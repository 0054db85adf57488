"""What the parity tests of the train step's options share: the small
config, the numpy start states and batches both packages take, the
reference's step runner (code for one subprocess with forced XLA devices),
and the checks that hold the port's state to the reference's.

The tolerances are those of ``tests/test_torch_hybrid.py``: the loss within
1e-6 relative; rows no step touched bit for bit; touched rows, their state
slabs and the fp32 master of the dense weights within 1e-3 relative plus
1e-5; and where a case is held bit for bit (row mode, Split-SGD), every
leaf.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import torch

from repro_torch import weights
from repro_torch.core import dlrm as t_dlrm
from repro_torch.core import sharded_embedding as t_se
from repro_torch.dist.exchange import ExchangeConfig, resolve_exchange
from repro_torch.optim import data_parallel as t_dp
from repro_torch.optim import row as t_row
from repro_torch.optim.split_sgd import combine_split

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(name="dlrm-tiny", num_dense=16, bottom=(32, 16), top=(32, 16),
             table_rows=(100, 37, 250, 13, 60, 21), emb_dim=16, pooling=3, batch=32, lr=0.1)

# the reference's train steps of a list of cases, in one process with 4 forced
# XLA devices: ``sys.argv[1]`` a pickle of the cases, ``sys.argv[2]`` where the
# results go; ``EXTRA`` code of a test file runs after (``out`` the results)
REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.core import dlrm
from repro.dist.exchange import ExchangeConfig
from repro.launch.mesh import make_mesh

def ref_cfg(kw):
    kw = dict(kw)
    if isinstance(kw.get("exchange"), dict):
        kw["exchange"] = ExchangeConfig(**kw["exchange"])
    return dlrm.DLRMConfig(**kw, fused_update=False)

todo = pickle.load(open(sys.argv[1], "rb"))
out = {"cases": []}
for c in todo["cases"]:
    mesh = make_mesh(c["mesh"], ("data", "model"))
    step, shardings, _, _ = dlrm.make_train_step(ref_cfg(c["cfg"]), mesh)
    state = jax.device_put(jax.tree.map(jnp.asarray, c["start"]), shardings)
    losses, states = [], []
    for b in c.get("ref_batches") or c["batches"]:
        state, loss = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
        states.append(jax.tree.map(np.array, state))  # copies: the next step donates
    out["cases"].append({"losses": losses, "states": states})
"""


def cfg_of(kw: dict) -> t_dlrm.DLRMConfig:
    """The port's config of a case's keyword arguments (``exchange`` as a
    dict of ``ExchangeConfig`` fields)."""
    kw = dict(kw)
    if isinstance(kw.get("exchange"), dict):
        kw["exchange"] = ExchangeConfig(**kw["exchange"])
    return t_dlrm.DLRMConfig(**kw)


def emb_shards(cfg, mesh) -> int:
    return mesh[1] if cfg.emb_mode == "table" else mesh[0] * mesh[1]


def layout_of(cfg, mesh):
    return t_se.make_layout(cfg.spec, emb_shards(cfg, mesh), cfg.emb_mode)


def start_state(cfg, mesh, seed: int, err_scale: float = 0.0) -> dict:
    """A global start state of ``cfg`` on ``mesh`` as the reference's numpy
    arrays: table rows ~ U(-a, a), the optimizer's state slabs drawn too,
    dense weights drawn by the port; with the dense error feedback an
    ``err`` slab ~ N(0, err_scale) (zero at 0: a fresh run's), and ``sr`` =
    ``cfg.sr_seed`` where the config reads it."""
    layout = layout_of(cfg, mesh)
    a = 1.0 / np.sqrt(np.mean(cfg.table_rows))
    W = np.random.default_rng(seed).uniform(-a, a, (layout.total_rows, cfg.emb_dim))
    opt = t_row.resolve(cfg)
    emb = t_row.init_store(opt, torch.from_numpy(W.astype(np.float32)))
    rng = np.random.default_rng(seed + 1)
    for key, _, dtype in opt.state:
        slab = emb[key]
        vals = (rng.integers(1, 4, slab.shape) if dtype == torch.int32
                else rng.uniform(0 if key == "acc" else -a, a, slab.shape))
        slab.copy_(torch.from_numpy(vals).to(dtype))
    ex = resolve_exchange(cfg)
    dense = t_dp.dp_global_arrays(
        t_dlrm.init_dense_params(cfg, torch.Generator().manual_seed(seed), "cpu"),
        mesh[0] * mesh[1], ex.num_buckets, ex.needs_err)
    if dense["err"] is not None and err_scale:
        dense["err"] = torch.from_numpy(
            (rng.standard_normal(dense["err"].shape) * err_scale).astype(np.float32))
    state = {"emb": emb, "dense": dense}
    if opt.stochastic_round or ex.needs_sr:
        state["sr"] = torch.tensor(cfg.sr_seed, dtype=torch.int32)
    return weights.state_to_numpy(state)


def zipf_batches(cfg, mesh, n: int, seed: int) -> list[dict]:
    """n zipf batches; table mode with the replicated stream takes them in
    padded-slot order, as the reference's loader gives them.  Each keeps its
    original-slot ids and weights under ``orig`` for the host pre-sort."""
    rng = np.random.default_rng(seed)
    layout = layout_of(cfg, mesh)
    out = []
    for _ in range(n):
        B = cfg.batch
        idx = np.stack([rng.zipf(1.3, (B, cfg.pooling)) % m for m in cfg.table_rows], 1)
        b = {"idx": idx.astype(np.int32),
             "dense_x": rng.standard_normal((B, cfg.num_dense)).astype(ml_dtypes.bfloat16),
             "labels": rng.integers(0, 2, B).astype(np.float32)}
        if cfg.weighted:
            b["weights"] = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
        orig = {k: b[k] for k in ("idx", "weights") if k in b}
        if cfg.emb_mode == "table" and cfg.idx_input == "replicated":
            for k in orig:
                b[k] = t_se.permute_indices(layout, torch.from_numpy(orig[k])).numpy()
        b["orig"] = orig
        out.append(b)
    return out


def case(name: str, mesh, over: dict, seed: int, steps: int = 2, err_scale: float = 0.0,
         base: dict = SMALL) -> dict:
    """A case both packages run: ``cfg`` keyword arguments, the mesh, the
    numpy start state and ``steps`` batches; with ``host_presort`` the port's
    batches carry the port's ``psort_*`` fields and ``ref_batches`` the
    reference's."""
    kw = {**base, **over}
    cfg = cfg_of(kw)
    bs = zipf_batches(cfg, mesh, steps, seed)
    c = {"name": name, "cfg": kw, "mesh": mesh, "start": start_state(cfg, mesh, seed, err_scale),
         "batches": [{k: v for k, v in b.items() if k != "orig"} for b in bs]}
    if cfg.host_presort:
        from repro.core import sharded_embedding as j_se
        from repro.data.pipeline import presort_batch as j_presort
        from repro_torch.data.pipeline import presort_batch as t_presort
        t_layout = layout_of(cfg, mesh)
        j_layout = j_se.make_layout(cfg.spec, t_layout.num_shards, cfg.emb_mode)
        c["ref_batches"] = [{**x, **j_presort(j_layout, b["orig"]["idx"], b["orig"].get("weights"))}
                            for x, b in zip(c["batches"], bs)]
        c["batches"] = [{**x, **t_presort(t_layout, b["orig"]["idx"], b["orig"].get("weights"))}
                        for x, b in zip(c["batches"], bs)]
    return c


def run_reference(tmp: Path, cases: list, extra: str = "", inputs=None) -> subprocess.Popen:
    """Start the reference's process over ``cases`` (and ``extra`` code with
    ``todo["inputs"]``); :func:`reference_results` collects it."""
    with open(tmp / "ref_cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "inputs": inputs}, f)
    code = textwrap.dedent(REF) + textwrap.dedent(extra) + \
        "\npickle.dump(out, open(sys.argv[2], 'wb'))\n"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", code, str(tmp / "ref_cases.pkl"),
                             str(tmp / "ref_out.pkl")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def reference_results(tmp: Path, proc: subprocess.Popen, timeout: float = 300) -> dict:
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref_out.pkl", "rb") as f:
        return pickle.load(f)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def master(emb: dict) -> np.ndarray:
    """The fp32 master rows of a store (Split-SGD's ``hi`` and ``lo`` joined)."""
    if "hi" in emb:
        return np.asarray(combine_split(weights.to_torch(emb["hi"]), weights.to_torch(emb["lo"])))
    return np.asarray(emb["w"], np.float32)


def dense_master(state: dict, ns: int, nb: int = 4) -> np.ndarray:
    """The fp32 master of the dense weights, natural order."""
    hi = np.concatenate([np.asarray(a).reshape(-1) for a in jax.tree.leaves(state["dense"]["hi"])])
    lo = np.asarray(state["dense"]["lo"])
    lo = lo.reshape(ns, nb, -1).transpose(1, 0, 2).reshape(-1)[:hi.size]
    return master({"hi": hi, "lo": lo})


def touched(c: dict) -> np.ndarray:
    """The rows of the global store that the case's steps touch (table mode:
    also every shard's spare row, which the dummy slots read)."""
    cfg = cfg_of(c["cfg"])
    layout = layout_of(cfg, c["mesh"])
    out = np.zeros(layout.total_rows, bool)
    R = layout.rows_per_shard
    for b in c["batches"]:
        idx = b["idx"]
        if cfg.emb_mode == "row":
            out[(idx + layout.row_offsets[None, :, None]).reshape(-1)] = True
            continue
        if cfg.idx_input == "sharded":
            idx = t_se.permute_indices(layout, torch.from_numpy(idx)).numpy()
        pos = np.arange(layout.num_padded_slots)
        base = (pos // layout.slots_per_shard) * R + layout.slot_local_offsets
        out[(idx + base[None, :, None]).reshape(-1)] = True
    if cfg.emb_mode == "table":
        out[np.arange(layout.num_shards) * R + R - 1] = True
    return out


def hold_state(c: dict, mine: dict, ref: dict, bitwise: bool) -> None:
    """The port's gathered state after a case's steps held to the
    reference's: the tolerances of ``tests/test_torch_hybrid.py`` (module
    docstring), every leaf bit for bit where ``bitwise``; the ``err`` slab
    (residuals below a bf16 ulp of the gradients) within the dense master's
    1e-5 absolute."""
    start = c["start"]
    rows = touched(c)
    for k in mine["emb"]:
        assert mine["emb"][k].shape == ref["emb"][k].shape
        np.testing.assert_array_equal(bits(mine["emb"][k])[~rows], bits(ref["emb"][k])[~rows])
        np.testing.assert_array_equal(bits(mine["emb"][k])[~rows], bits(start["emb"][k])[~rows])
        if k not in ("hi", "lo"):
            np.testing.assert_allclose(np.asarray(mine["emb"][k], np.float32)[rows],
                                       np.asarray(ref["emb"][k], np.float32)[rows],
                                       rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(master(mine["emb"])[rows], master(ref["emb"])[rows],
                               rtol=1e-3, atol=1e-5)
    ns = c["mesh"][0] * c["mesh"][1]
    nb = resolve_exchange(cfg_of(c["cfg"])).num_buckets
    np.testing.assert_allclose(dense_master(mine, ns, nb), dense_master(ref, ns, nb),
                               rtol=1e-3, atol=1e-5)
    assert (mine["dense"]["err"] is None) == (ref["dense"]["err"] is None)
    if mine["dense"]["err"] is not None:
        np.testing.assert_allclose(mine["dense"]["err"], ref["dense"]["err"], rtol=0, atol=1e-5)
    assert ("sr" in mine) == ("sr" in ref)
    if bitwise:
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(bits(a), bits(b))


def same_bits(a: dict, b: dict) -> bool:
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(np.array_equal(bits(x), bits(y)) for x, y in zip(la, lb))
