"""The port's LM steps on a mesh (``models.lm_steps`` with a mesh:
``models.transformer``'s FSDP, Megatron TP and sequence parallelism, the
MoE's expert-parallel all-to-all, the sequence-sharded decode cache)
against the reference's steps, on the CPU.

One reference process with 4 forced XLA devices (``jax.set_mesh`` around
its calls; ``--xla_allow_excess_precision=false``, as the MoE archs'
one-rank tests run it) runs every case first; then one ``run_ranks`` of 4
gloo ranks runs the port's (``_torch_ranks.lm_mesh_rank``): (2, 2) over
the world, (1, 2) and (2, 1) over each pair of ranks.  The configs are
``tests/test_torch_lm_train.py``'s at 2 layers (d_model 64, vocab 256,
``loss_chunk`` 16, ``attn_chunk`` 8): dense GQA (internlm2), five heads and
five KV heads at tp 2 (heads that do not divide ``model``), gemma2 (local
and global layers, both soft-caps, tied, ``embed_scale``), MoE (qwen3) and
MLA (deepseek: a dense first layer, a shared expert).

How they are held.
* Train: three steps with microbatch 2 at (1, 2) and (2, 2), each step
  from the reference's state before it (a shared start, as the one-rank
  tests hold their steps), so that each step's gaps are that step's: the
  loss within 1e-3, every leaf's update (its fp32 master less the start's)
  and momentum within 4e-2 of its largest (``test_torch_lm_train.py``'s
  tolerances).  The dense families against the reference's step on the
  same mesh, with ``seq_shard`` off and on.  The MoE and MLA families
  against the reference's one-device step (``seq_shard`` off, the only
  path of the reference's MoE that the CPU executes: its ``shard_map``
  einsum stops at ``DotThunk`` BF16 x BF16 = F32), with ``seq_shard`` off
  and on: at (2, 2) the reference's own GSPMD sums move its updates by up
  to 6.4% from its one-device step (deepseek, measured), past the 4e-2,
  where the port's mesh step stays within 2% of the port's one-device
  step.  Their MoE routes every token to all of its 4 experts (top_k =
  n_experts): at top_k 2 of 8 a router input one bf16 step away flips a
  choice (in either package, between meshes), which moves every leaf's
  update by up to 45%.  The routing's top-k, slots and drops are held at
  one rank (``tests/test_torch_moe.py``).
* The expert-parallel FFN alone in fp32 against the reference's
  ``_expert_ffn`` ``shard_map`` at (1, 2), (2, 1) and (2, 2): the output
  and every gradient within 1e-5 of its largest (no factor).
* The launcher's configs (``reduced_lm`` of the five archs: pure FSDP,
  ``tp_size`` 1) at (1, 2), one step each against the reference's on the
  same mesh (the routed archs, at their top 2 of 8 experts with drops,
  against its one-device step, as above).
* Serving: prefill and four decode steps at (1, 2) and (2, 2), a B = 1
  cache sharded over the whole (2, 2) mesh along the sequence (the
  reference's prefill of it on one device): logits within 2e-2 and the
  cache within 0.1 (``tests/test_torch_lm.py``'s bounds); the MoE served
  with the reference's ``seq_shard`` off.
* An LM state saved on (1, 2) restores on (2, 1), on one rank and in the
  reference, bit for bit; ``init_lm_state`` on a mesh is the one-rank
  draw cut.  A one-rank mesh runs the one-card steps, bit for bit.  A
  shape-only (1, 2) step counts the collectives that two gloo ranks run.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_ranks import lm_step_counts
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.local import run_ranks
from repro_torch.launch.mesh import make_mesh, make_shape_mesh, shape_only_meshes
from repro_torch.launch.train import reduced_lm
from repro_torch.models import lm_steps
from repro_torch.models import transformer as tf
from repro_torch.optim.data_parallel import tree_leaves
from test_torch_lm_train import GRAD_TOL, LOSS_TOL, _cfg, _master, _port_cfg, _state_np

ROOT = Path(__file__).resolve().parents[1]
B, L, N = 4, 32, 4
LR = 0.05
DENSE = ["internlm2-1.8b", "heads5", "gemma2-27b"]
ROUTED = ["qwen3-moe-30b-a3b", "deepseek-v2-236b"]
LOGIT_TOL, CACHE_TOL, EP_TOL = 2e-2, 0.1, 1e-5

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import lm_steps, transformer as tf


def mesh_of(shape):
    return Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))


def train(c):
    mesh, cfg = mesh_of(c["ref_mesh"]), tf.TransformerConfig(**c["ref_cfg"])
    with jax.set_mesh(mesh):
        step, _, (ssh, bsh) = lm_steps.make_lm_train_step(cfg, mesh, c["B"], c["L"], lr=c["lr"])
        state, starts, losses, states = c["start"], [], [], []
        for b in c["batches"]:
            starts.append(state)
            new, loss = step(jax.device_put(jax.tree.map(jnp.asarray, state), ssh),
                             jax.device_put(jax.tree.map(jnp.asarray, b), bsh))
            state = jax.tree.map(np.array, new)
            losses.append(float(loss))
            states.append(state)
    return {"starts": starts, "losses": losses, "states": states}


def serve(c):
    mesh, cfg = mesh_of(c["mesh"]), tf.TransformerConfig(**c["ref_cfg"])
    B, L, N = c["B"], c["L"], c["N"]
    pm = mesh if B % c["mesh"][0] == 0 else mesh_of((1, 1))
    out = {}
    with jax.set_mesh(pm):
        pre, _, (psh, tsh) = lm_steps.make_prefill_step(cfg, pm, B, L)
        logits, cache = pre(jax.device_put(jax.tree.map(jnp.asarray, c["params"]), psh),
                            jax.device_put(jnp.asarray(c["prompt"]), tsh))
        out["logits"] = np.asarray(logits, np.float32)
        cache = jax.tree.map(np.asarray, cache)
    out["cache"] = cache
    with jax.set_mesh(mesh):
        dec, _, (psh, csh, tsh, _) = lm_steps.make_decode_step(cfg, mesh, B, L + N)

        def pad(a):
            w = [(0, 0)] * a.ndim
            w[3 if a.ndim == 5 else 2] = (0, N)
            return jnp.pad(jnp.asarray(a), w)
        full = jax.device_put(jax.tree.map(pad, cache), csh)
        params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), psh)
        steps = []
        for i in range(N):
            tok = jax.device_put(jnp.asarray(c["next"][:, i]), tsh)
            pos = jax.device_put(jnp.full((B,), L + i, jnp.int32), tsh)
            logits, full = dec(params, full, tok, pos)
            steps.append(np.asarray(logits, np.float32))
        out["steps"] = steps
        out["final"] = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), full)
    return out


def ep(c):
    mesh, cfg = mesh_of(c["mesh"]), tf.TransformerConfig(**c["ref_cfg"])
    names = ("buf", "wg", "wu", "wd")
    with jax.set_mesh(mesh):
        def f(buf, wg, wu, wd):
            return jnp.sum(tf._expert_ffn(buf, wg, wu, wd, cfg) * c["cot"])
        args = [jnp.asarray(c[k]) for k in names]
        out = jax.jit(lambda *a: tf._expert_ffn(*a, cfg))(*args)
        grads = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*args)
    return {"out": np.asarray(out), **{"g" + k: np.asarray(g) for k, g in zip(names, grads)}}


out = {}
for c in pickle.load(open(sys.argv[1], "rb")):
    out[c["name"]] = {"train": train, "serve": serve, "ep": ep}[c["kind"]](c)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _config(name: str, mesh: tuple, seq_shard: bool, **over):
    """The reference's config of a case: 2 layers, the mesh's TP width; the
    routed families with every token on each of 4 experts (module note)."""
    over = dict(n_layers=2, dp_axes=("data",), tp_size=mesh[1], seq_shard=seq_shard, **over)
    if name == "heads5":
        return dataclasses.replace(_cfg("internlm2-1.8b", **over), name="heads5", n_heads=5,
                                   n_kv_heads=5)
    cfg = _cfg(name, **over)
    return dataclasses.replace(cfg, n_experts=4, top_k=4) if cfg.moe else cfg


def _batches(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


def _train_cases() -> list:
    cases = []
    for mesh in ((1, 2), (2, 2)):
        for name in DENSE + ROUTED:
            for seq in (False, True):
                cfg = _config(name, mesh, seq, microbatch=2)
                routed = name in ROUTED
                ref = dataclasses.replace(cfg, seq_shard=False, tp_size=1) if routed else cfg
                cases.append(dict(kind="train", name=f"train/{name}/{mesh}/seq={seq}",
                                  mesh=mesh, cfg=dataclasses.asdict(cfg),
                                  ref_cfg=dataclasses.asdict(ref),
                                  ref_mesh=(1, 1) if routed else mesh, B=B, L=L, lr=LR,
                                  start=_state_np(cfg), batches=_batches(cfg, 1)))
    for arch in ("internlm2-1.8b", "gemma2-27b", "phi3-medium-14b", "qwen3-moe-30b-a3b",
                 "deepseek-v2-236b"):
        cfg, _, _ = reduced_lm(arch, B, L)
        cfg = dataclasses.replace(_cfg("internlm2-1.8b"), **{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
        cases.append(dict(kind="train", name=f"launcher/{arch}", mesh=(1, 2),
                          cfg=dataclasses.asdict(cfg), ref_cfg=dataclasses.asdict(cfg),
                          ref_mesh=(1, 1) if cfg.moe else (1, 2), B=B, L=L, lr=LR,
                          start=_state_np(cfg),
                          batches=_batches(cfg, 2)[:1]))
    return cases


def _serve_cases() -> list:
    cases = []
    for mesh, rows, names in (((1, 2), B, DENSE + ROUTED), ((2, 2), B, DENSE + ROUTED),
                              ((2, 2), 1, ["internlm2-1.8b", "deepseek-v2-236b"])):
        for name in names:
            cfg = _config(name, mesh, True)
            ref = dataclasses.replace(cfg, seq_shard=not cfg.moe)
            params = jax.tree.map(lambda a: np.asarray(a.astype(jax.numpy.bfloat16)),
                                  jtf.init_params(jax.random.PRNGKey(3), ref))
            rng = np.random.default_rng(5)
            cases.append(dict(kind="serve", name=f"serve/{name}/{mesh}/B={rows}", mesh=mesh,
                              cfg=dataclasses.asdict(cfg), ref_cfg=dataclasses.asdict(ref),
                              B=rows, L=L, N=N, params=params,
                              prompt=rng.integers(0, cfg.vocab, (rows, L)).astype(np.int32),
                              next=rng.integers(0, cfg.vocab, (rows, N)).astype(np.int32)))
    return cases


def _ep_cases() -> list:
    cases = []
    rng = np.random.default_rng(9)
    E, C, d, f = 4, 8, 16, 8
    for mesh in ((1, 2), (2, 1), (2, 2)):
        cfg = _config("qwen3-moe-30b-a3b", mesh, True)
        draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        cases.append(dict(kind="ep", name=f"ep/{mesh}", mesh=mesh, cfg=dataclasses.asdict(cfg),
                          ref_cfg=dataclasses.asdict(cfg), buf=draw(B, E, C, d),
                          wg=draw(E, d, f), wu=draw(E, d, f), wd=draw(E, f, d),
                          cot=draw(B, E, C, d)))
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases, the reference's results and the port's (rank 0's)."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    train, serve, ep = _train_cases(), _serve_cases(), _ep_cases()
    with open(tmp / "cases.pkl", "wb") as fh:
        pickle.dump(train + serve + ep, fh)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "-c", textwrap.dedent(REF), str(tmp / "cases.pkl"),
                    str(tmp / "ref.pkl")], env=env, check=True, timeout=600)
    with open(tmp / "ref.pkl", "rb") as fh:
        ref = pickle.load(fh)
    for c in train:
        c["starts"] = ref[c["name"]]["starts"]
    for c in serve:
        c["cache"] = {k: v.astype(np.float32) for k, v in ref[c["name"]]["cache"].items()}
    cfg = _config("internlm2-1.8b", (1, 2), True, microbatch=2)
    extra = [dict(kind="ckpt", name="ckpt", cfg=dataclasses.asdict(_port_cfg(cfg)), B=B, L=L,
                  lr=LR, batch=_batches(cfg, 3)[0], dir=str(tmp / "ckpt")),
             dict(kind="counts", name="counts", mesh=(1, 2), B=B, L=L,
                  cfg=dataclasses.asdict(_port_cfg(_config("qwen3-moe-30b-a3b", (1, 2), True))))]
    port_cases = [{k: v for k, v in c.items() if k not in ("start", "ref_cfg")}
                  for c in train + serve + ep] + extra
    mine = run_ranks(_rank_fn(), 4, (port_cases,), timeout_s=600)[0]
    return {c["name"]: c for c in train + serve + ep + extra}, ref, mine


def _rank_fn():
    import _torch_ranks
    return _torch_ranks.lm_mesh_rank


def _names(kind: str) -> list:
    if kind == "train":
        return [c["name"] for c in _train_cases() if c["name"].startswith("train/")]
    if kind == "launcher":
        return [c["name"] for c in _train_cases() if c["name"].startswith("launcher/")]
    return [f"serve/{n}/{m}/B={b}" for m, b, ns in (((1, 2), B, DENSE + ROUTED),
                                                     ((2, 2), B, DENSE + ROUTED),
                                                     ((2, 2), 1, ["internlm2-1.8b",
                                                                  "deepseek-v2-236b"]))
            for n in ns]


def _hold_steps(c: dict, r: dict, m: dict) -> None:
    for i, (start, want, got) in enumerate(zip(r["starts"], r["states"], m["states"])):
        assert abs(m["losses"][i] - r["losses"][i]) <= LOSS_TOL, (i, m["losses"][i],
                                                                  r["losses"][i])
        w0 = [_master(h, lo) for h, lo in zip(tree_leaves(start["hi"]), tree_leaves(start["lo"]))]
        for j, (w, hj, lj, ht, lt) in enumerate(zip(
                w0, tree_leaves(want["hi"]), tree_leaves(want["lo"]),
                tree_leaves(got["hi"]), tree_leaves(got["lo"]))):
            dw, dg = _master(hj, lj) - w, _master(ht, lt) - w
            top = float(np.abs(dw).max())
            assert top > 0 and np.abs(dw - dg).max() <= GRAD_TOL * top, (i, j)
        for j, (mj, mt) in enumerate(zip(tree_leaves(want["mom"]), tree_leaves(got["mom"]))):
            top = float(np.abs(mj).max())
            assert np.abs(np.asarray(mj) - mt).max() <= GRAD_TOL * top, (i, j)


@pytest.mark.parametrize("name", _names("train"))
def test_mesh_train_steps_match_the_reference(runs, name):
    """Three steps with microbatch 2 on the case's mesh (module note)."""
    cases, ref, mine = runs
    _hold_steps(cases[name], ref[name], mine[name])


@pytest.mark.parametrize("name", _names("launcher"))
def test_pure_fsdp_launcher_configs_match_the_reference(runs, name):
    """The launcher's ``reduced_lm`` (``tp_size`` 1, ``seq_shard`` off: each
    leaf over the whole (1, 2) mesh, the batch on every rank) one step
    against the reference's on the same mesh."""
    cases, ref, mine = runs
    _hold_steps(cases[name], ref[name], mine[name])


@pytest.mark.parametrize("name", _names("serve"))
def test_mesh_serving_matches_the_reference(runs, name):
    """The prefill's logits (gathered from ``P(bdp, model)``) and cache, then
    each decode step's logits and the final cache."""
    cases, ref, mine = runs
    r, m = ref[name], mine[name]
    if cases[name]["B"] > 1:
        assert np.abs(m["logits"] - r["logits"]).max() <= LOGIT_TOL
        for k, v in m["cache"].items():
            assert np.abs(v - r["cache"][k].astype(np.float32)).max() <= CACHE_TOL, k
    for i, (a, b) in enumerate(zip(r["steps"], m["steps"])):
        assert np.abs(a - b).max() <= LOGIT_TOL, i
    for k, v in m["final"].items():
        assert np.abs(v - r["final"][k]).max() <= CACHE_TOL, k


@pytest.mark.parametrize("mesh", ["(1, 2)", "(2, 1)", "(2, 2)"])
def test_expert_parallel_ffn_matches_the_shard_map(runs, mesh):
    """The all-to-all over ``data``, the rank's experts and f columns, the
    fp32 partial sums reduced over ``model``, the all-to-all back: the
    output and the gradients of the buffer and the three weights within
    1e-5 of each one's largest, the reference's gradients with no factor."""
    _, ref, mine = runs
    r, m = ref[f"ep/{mesh}"], mine[f"ep/{mesh}"]
    for k in ("out", "gbuf", "gwg", "gwu", "gwd"):
        top = float(np.abs(r[k]).max())
        assert np.abs(r[k] - m[k]).max() <= EP_TOL * top, k


def test_lm_state_checkpoint_moves_between_meshes_and_packages(runs):
    """``init_lm_state`` on (1, 2) equals the one-rank draw cut by the specs;
    the state after a step, saved whole, restores onto (2, 1) bit for bit;
    the port's one-rank ``CheckpointManager`` and the reference's restore
    the same files bit for bit."""
    _, _, mine = runs
    got = mine["ckpt"]
    assert got["init_cut"] and got["restored"]
    cfg = _port_cfg(_config("internlm2-1.8b", (1, 2), True, microbatch=2))
    step, one = CheckpointManager(got["path"]).restore(weights.lm_global_like(cfg), device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(got["state"]), tree_leaves(weights.lm_state_to_numpy(one))):
        assert a.tobytes() == np.asarray(b).tobytes()
    like = jax.tree.map(jax.numpy.asarray, weights.lm_state_to_numpy(one))
    step, back = JCheckpointManager(got["path"]).restore(like, verify=True)
    assert step == 1
    for a, b in zip(tree_leaves(got["state"]), jax.tree.leaves(back)):
        assert a.tobytes() == np.asarray(b).tobytes()


def test_shape_only_counts_equal_two_gloo_ranks(runs):
    """A shape-only (1, 2) mesh's train, prefill and decode steps (MoE on
    the expert-parallel path, sequence parallel) count, kind by kind, the
    calls and bytes that the real step counts on two gloo ranks."""
    cases, _, mine = runs
    c = cases["counts"]
    mesh = make_shape_mesh((1, 2), ("data", "model"), device="cpu")
    with shape_only_meshes():
        want = lm_step_counts(tf.TransformerConfig(**c["cfg"]), mesh, c["B"], c["L"])
    assert mine["counts"] == want
    assert want["train"]["calls"]["all-to-all"] > 0 and want["train"]["calls"]["reduce-scatter"]


def test_one_rank_mesh_runs_the_one_card_steps_bit_for_bit():
    """``make_lm_train_step(cfg, mesh)`` on a one-rank mesh is the one-card
    step: three steps from one state give the same losses and state bits."""
    cfg = _port_cfg(_config("gemma2-27b", (1, 1), True))
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    # two draws of one seed: a state made from numpy on the CPU shares its arrays
    a = weights.lm_state_from_numpy(_state_np(cfg), cfg, "cpu")
    b = weights.lm_state_from_numpy(_state_np(cfg), cfg, "cpu", mesh=mesh)
    one, _ = lm_steps.make_lm_train_step(cfg, B, L, lr=LR, device="cpu")
    ranked, _ = lm_steps.make_lm_train_step(cfg, mesh, B, L, lr=LR)
    for batch in _batches(cfg, 4):
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, la = one(a, t)
        _, lb = ranked(b, lm_steps.local_batch(cfg, mesh, t))
        assert float(la) == float(lb)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
