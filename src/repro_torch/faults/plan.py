"""Deterministic fault injection for resilience drills (a copy of
``repro/faults/plan.py``, which is pure Python, so the port needs nothing of
``repro``).

A :class:`FaultPlan` is a seeded, step-indexed schedule of :class:`Fault`s
fired through EXPLICIT hook points (``plan.fire(site, step=...)``) that the
checkpoint / train / data layers call at their failure-prone boundaries —
no monkeypatching, so the injected control flow is exactly the production
control flow.  The registered sites:

=========================  =====================================================
site                       fired by
=========================  =====================================================
``ckpt.write.arrays``      ``CheckpointManager`` before writing ``arrays.npz``
``ckpt.write.meta``        before writing ``meta.json``
``ckpt.commit``            between the tmp-dir write and ``os.replace``
``loader.next``            ``ThreadedIterator`` worker, once per source pull
``train.step``             ``TrainLoop`` inside the timed step window
=========================  =====================================================

Actions:

* ``raise``   — raise ``exc`` (default ``RuntimeError``); models transient
  failures (ENOSPC via ``exc=OSError(errno.ENOSPC, ...)``, a flaky shard
  read, ...).  Retry/backoff layers are allowed to absorb these.
* ``crash``   — raise :class:`InjectedCrash` (a ``BaseException``): simulated
  process death.  Retry handlers for transient IO MUST NOT swallow it, and
  a drilled ``TrainLoop`` dies without writing its final checkpoint —
  exactly like a real ``kill -9``.
* ``partial`` — marker returned to the hook: the checkpoint writer COMMITS a
  torn ``arrays.npz`` (truncated bytes behind a valid-looking directory)
  and then crashes — the torn-write case checksum verification exists for.
* ``stall``   — sleep ``delay_s`` at the site, then continue (injected
  straggler / loader stall; shows up in step timing, not correctness).
* ``preempt`` / ``sigterm`` — marker for ``TrainLoop``: simulate host
  preemption (``sigterm`` delivers a real ``signal.SIGTERM`` to the process
  when the loop runs on the main thread; ``preempt`` sets the stop flag
  directly, the non-main-thread degradation).

Every fire is recorded on ``plan.fired`` (and the optional
:class:`repro_torch.faults.log.FailureLog`), so drills can assert the fault
actually happened.  ``FaultPlan.random`` derives a schedule from a seed via
``numpy.random.default_rng`` — same seed, same faults, every run.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Optional, Union

ACTIONS = ("raise", "crash", "partial", "stall", "preempt", "sigterm")

CKPT_SITES = ("ckpt.write.arrays", "ckpt.write.meta", "ckpt.commit")
SITES = CKPT_SITES + ("loader.next", "train.step")


class InjectedCrash(BaseException):
    """Simulated process death at a fault site.

    Deliberately a ``BaseException``: the bounded-retry paths for transient
    IO catch ``OSError``/``Exception`` and must never absorb a crash — a
    crashed process does not get to retry, and a drilled ``TrainLoop``
    skips its final checkpoint on the way out.
    """


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fire ``action`` at ``site`` on step ``step``.

    ``step=None`` arms the fault for the first ``times`` fires of the site
    regardless of step.  ``exc`` is the exception to raise for
    ``action="raise"`` — an instance or a zero-arg factory.
    """

    site: str
    action: str = "raise"
    step: Optional[int] = None
    times: int = 1
    exc: Union[BaseException, Callable[[], BaseException], None] = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} (one of {ACTIONS})")

    def make_exc(self) -> BaseException:
        if self.exc is None:
            at = "" if self.step is None else f" step {self.step}"
            return RuntimeError(f"injected fault at {self.site}{at}")
        return self.exc() if callable(self.exc) else self.exc


class FaultPlan:
    """A deterministic, step-indexed schedule of faults.

    Thread-safe: hook points fire from loader worker threads and the
    checkpoint writer thread as well as the train loop.  Sites the plan
    does not name are free (``fire`` returns ``None`` without work), so an
    empty plan is safe to leave permanently wired in.
    """

    def __init__(self, faults: Iterable[Fault] = (), log=None):
        self._faults = [dataclasses.replace(f) for f in faults]
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self.fired: list[tuple[str, int, str]] = []
        self.log = log

    # ------------------------------------------------------------- build
    @classmethod
    def single(cls, site: str, action: str = "raise", step: Optional[int] = None, **kw) -> "FaultPlan":
        return cls([Fault(site, action=action, step=step, **kw)])

    @classmethod
    def random(
        cls,
        seed: int,
        sites: Iterable[str],
        steps: int,
        rate: float = 0.05,
        action: str = "raise",
        log=None,
    ) -> "FaultPlan":
        """Seeded pseudo-random schedule: each (site, step) pair fires with
        probability ``rate``.  Pure function of ``seed`` — drills replay."""
        import numpy as np

        rng = np.random.default_rng(seed)
        faults = [
            Fault(site, action=action, step=s)
            for site in sites
            for s in range(steps)
            if rng.random() < rate
        ]
        return cls(faults, log=log)

    # -------------------------------------------------------------- fire
    def fire(self, site: str, step: Optional[int] = None) -> Optional[Fault]:
        """Hook point.  Returns ``None`` (no fault armed here), performs the
        fault's action (raise / crash / sleep), or returns the matched
        :class:`Fault` for marker actions the site interprets itself."""
        with self._lock:
            count = self._counters.get(site, 0)
            self._counters[site] = count + 1
            at = count if step is None else step
            hit = None
            for f in self._faults:
                if f.times > 0 and f.site == site and (f.step is None or f.step == at):
                    hit = f
                    break
            if hit is None:
                return None
            hit.times -= 1
            self.fired.append((site, at, hit.action))
        if self.log is not None:
            self.log.record("fault_injected", site=site, step=at, action=hit.action)
        if hit.action == "raise":
            raise hit.make_exc()
        if hit.action == "crash":
            raise InjectedCrash(f"injected crash at {site} step {at}")
        if hit.action == "stall":
            time.sleep(hit.delay_s)
        return hit

    def count(self, site: Optional[str] = None) -> int:
        """How many faults have fired (at ``site``, or in total)."""
        with self._lock:
            return len([f for f in self.fired if site is None or f[0] == site])


#: Shared empty plan: ``NO_FAULTS.fire(...)`` is a cheap no-op, so
#: production call sites never need a None check.
NO_FAULTS = FaultPlan()


def corrupt_checkpoint(directory, step: int, mode: str = "flip", seed: int = 0) -> str:
    """Deterministically damage a COMMITTED checkpoint — the drill utility
    for bit-rot / torn-write scenarios that happen outside the writer's
    control.  Returns the damaged file's path.

    ``mode``: ``flip`` xor-flips 16 seeded byte positions of
    ``arrays.npz``; ``truncate`` cuts it to a third; ``no_meta`` deletes
    ``meta.json`` (an incomplete directory); ``meta_garbage`` overwrites
    ``meta.json`` with non-JSON bytes.
    """
    import numpy as np
    from pathlib import Path

    cdir = Path(directory) / f"step_{step}"
    arrays = cdir / "arrays.npz"
    meta = cdir / "meta.json"
    if mode == "flip":
        raw = bytearray(arrays.read_bytes())
        rng = np.random.default_rng(seed)
        # flip inside the payload region, away from the zip end-of-archive
        # record, so np.load still opens the file and verification has to
        # catch the damage by CHECKSUM, not by parse failure
        lo = len(raw) // 4
        hi = len(raw) - 1024 if len(raw) > 2048 else (3 * len(raw)) // 4
        hi = max(hi, lo + 1)
        for pos in rng.integers(lo, hi, size=16):
            raw[int(pos)] ^= 0xFF
        arrays.write_bytes(bytes(raw))
        return str(arrays)
    if mode == "truncate":
        raw = arrays.read_bytes()
        arrays.write_bytes(raw[: max(1, len(raw) // 3)])
        return str(arrays)
    if mode == "no_meta":
        meta.unlink()
        return str(meta)
    if mode == "meta_garbage":
        meta.write_bytes(b"\x00not json\xff")
        return str(meta)
    raise ValueError(f"unknown corruption mode {mode!r}")
