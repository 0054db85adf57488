"""The arch registry (``repro_torch/configs/base.py`` and every arch's
``ArchDef``), the row-optimizer registry (``repro_torch/optim/row.py``) and
``concat_interaction`` (``repro_torch/core/interaction.py``) against the
JAX package's.

One reference subprocess (8 forced XLA devices, a (2, 4) mesh) lists the
reference's archs and builds every cell there, without lowering it; the
port builds the same cells on a shape-only (2, 4) mesh
(``launch.mesh.make_shape_mesh``), the LM cells through their ``plan``.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import interaction as j_inter
from repro.optim import row as j_row
from repro_torch.configs import base as t_base
from repro_torch.core import interaction as t_inter
from repro_torch.kernels import embedding_update as t_eu
from repro_torch.launch.mesh import make_mesh, make_shape_mesh, shape_only_meshes
from repro_torch.optim import row as t_row

ROOT = Path(__file__).resolve().parents[1]

REF = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs import base
from repro.launch.mesh import make_mesh
mesh = make_mesh((2, 4), ("data", "model"))
out = {"archs": base.list_archs(), "defs": {}}
for name in out["archs"]:
    ad = base.get(name)
    cells = [(c.shape, c.kind, c.skip) for c in ad.cells]
    metas = {c.shape: ad.build(c.shape, mesh).meta for c in ad.cells if not c.skip}
    out["defs"][name] = {"family": ad.family, "notes": ad.notes, "cells": cells,
                         "metas": metas}
pickle.dump(out, open(sys.argv[1], "wb"))
"""

ARCHS = ("bst", "deepseek-v2-236b", "din", "dlrm-large", "dlrm-mlperf", "dlrm-small", "egnn",
         "fm", "gemma2-27b", "internlm2-1.8b", "phi3-medium-14b", "qwen3-moe-30b-a3b", "sasrec")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("registry") / "ref.pkl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REF), str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def plain(meta: dict) -> dict:
    """A meta dict with tuples as lists (the two packages' size lists)."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in meta.items()}


def port_meta(name: str, shape: str) -> dict:
    ad = t_base.get(name)
    mesh = make_shape_mesh((2, 4), ("data", "model"), device="cpu")
    if ad.plan is not None:
        return ad.plan(shape, mesh).meta
    with shape_only_meshes():
        return ad.build(shape, mesh).meta


def test_list_archs_is_the_reference_s(ref):
    """The registry loads every config module and lists the reference's 13
    archs."""
    assert t_base.list_archs() == ref["archs"] == list(ARCHS)


@pytest.mark.parametrize("name", ARCHS)
def test_arch_family_notes_and_cells(ref, name):
    """Each ArchDef's family, notes and cells (shape, kind, the skip reason
    word for word) are the reference's."""
    ad, want = t_base.get(name), ref["defs"][name]
    assert ad.family == want["family"]
    assert ad.notes == want["notes"]
    assert [(c.shape, c.kind, c.skip) for c in ad.cells] == want["cells"]


@pytest.mark.parametrize("name", ARCHS)
def test_cell_meta_on_a_2x4_mesh(ref, name):
    """Every cell's ``meta`` at a (2, 4) mesh equals the reference's key for
    key: the LM cells' config adaptation (data axes, pure DP, the
    microbatch fit, decode's tokens = B), the recsys, DLRM and EGNN cells'
    sizes."""
    want = ref["defs"][name]["metas"]
    assert want
    for shape, meta in want.items():
        assert plain(port_meta(name, shape)) == plain(meta), (name, shape)


def test_registry_whole_after_one_config_module():
    """Importing one arch's config module first (as a caller of
    ``configs.egnn_arch.build`` does) leaves the registry whole: every
    config module is loaded when it is read."""
    code = ("import repro_torch.configs.egnn_arch\n"
            "from repro_torch.configs import base\n"
            "print(','.join(base.list_archs()))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().split(",") == list(ARCHS)


def test_lm_build_refuses_a_mesh_and_runs_one_rank():
    """An LM cell's ``build`` on a shape-only mesh is refused outside the dry
    run's context; inside it, it returns rank 0's mesh step with the specs
    of its arguments (the state's, the batch over the config's data axes);
    on a one-rank mesh it returns the one-card step with ``lm_steps``'
    structs and no specs."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import shape_only_meshes
    from repro_torch.models import lm_steps
    ad = t_base.get("internlm2-1.8b")
    shape_only = make_shape_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="shape-only"):
        ad.build("train_4k", shape_only)
    with shape_only_meshes():
        on_mesh = ad.build("train_4k", shape_only, n_layers=2, batch=4)
    assert on_mesh.specs == (shd.lm_state_specs(on_mesh.model, momentum=False),
                             {"tokens": (("data",), None), "labels": (("data",), None)})
    assert on_mesh.model.tp_size == 4 and on_mesh.model.dp_axes == ("data",)
    one = make_mesh((1, 1), ("data", "model"), "cpu")
    built = ad.build("train_4k", one, n_layers=2, batch=4)
    plan = ad.plan("train_4k", one, n_layers=2, batch=4)
    assert callable(built.fn) and built.meta == plan.meta
    assert built.args == (lm_steps.lm_state_structs(plan.cfg, momentum=False),
                          {"tokens": ((4, 4096), torch.int32), "labels": ((4, 4096), torch.int32)})
    dec = ad.build("decode_32k", one, n_layers=2, batch=2)
    assert dec.meta["tokens"] == 2 and dec.args[1] == lm_steps.cache_structs(dec.model, 2, 32768)


# ---------------------------------------------------------------------------
# The row-optimizer registry
# ---------------------------------------------------------------------------

def test_row_registry_names_in_the_reference_s_order():
    """The built-in eight, registered in the reference's order."""
    assert t_row.names() == j_row.names()
    assert len(t_row.names()) == 8


@pytest.mark.parametrize("case", ["taken", "no_kernel"])
def test_row_registry_refusals(case):
    """Both registries refuse a taken name and an optimizer without a kernel
    entry, with a ``ValueError``; neither registers it."""
    def noop(*a):
        return None

    if case == "taken":
        t_opt = t_row.RowOptimizer("sgd", noop)
        j_opt = j_row.RowOptimizer("sgd", kernel=noop, reference=noop)
        match = "already registered"
    else:
        t_opt = t_row.RowOptimizer("toy_none", None)
        j_opt = j_row.RowOptimizer("toy_none", reference=noop)
        match = "no fused kernel"
    for register, opt in ((t_row.register, t_opt), (j_row.register, j_opt)):
        with pytest.raises(ValueError, match=match):
            register(opt)
    assert t_row.names() == j_row.names()


def _t_sign_sgd(opt, store, stream, dY, lr, seed):
    """The port's toy: each touched row steps by ``-lr * sign`` of its
    summed gradient (the sorted stream's runs)."""
    rows, bags, msk, wgt = stream
    g = dY.float()[bags.long()] * (wgt * msk.float())[:, None]
    uniq, inv = torch.unique(rows.long(), return_inverse=True)
    summed = torch.zeros((len(uniq), g.shape[1])).index_add_(0, inv, g)
    touched = torch.zeros(len(uniq), dtype=torch.float32).index_add_(0, inv, msk.float()) > 0
    step = (-lr * torch.sign(summed))[touched]
    store["w"].index_add_(0, uniq[touched], step)


def _j_sign_sgd(opt, store, rep, summed, lr, seed):
    return {"w": store["w"].at[rep].add(-lr * jnp.sign(summed))}


def test_toy_optimizer_registered_in_both_packages():
    """A user's optimizer (sign SGD, registered in both packages) gives the
    reference's update on the plain path bit for bit, through the same
    ``resolve`` / ``apply_sparse`` every built-in takes; unregistered, the
    name is unknown again."""
    t_row.register(t_row.RowOptimizer("toy_sign", _t_sign_sgd))
    j_row.register(j_row.RowOptimizer("toy_sign", kernel=noop_kernel, reference=_j_sign_sgd))
    try:
        assert t_row.names()[-1] == j_row.names()[-1] == "toy_sign"
        rng = np.random.default_rng(0)
        M, E, NB, P = 64, 16, 32, 4
        w = rng.standard_normal((M, E)).astype(np.float32)
        idx = rng.integers(0, M, (NB, P)).astype(np.int32)
        valid = rng.random((NB, P)) < 0.8
        dY = rng.standard_normal((NB, E)).astype(np.float32)
        opt = t_row.resolve(type("Cfg", (), {"sparse_optimizer": "toy_sign"})())
        store = {"w": torch.from_numpy(w.copy())}
        stream = t_eu.sort_lookups(torch.from_numpy(idx.reshape(-1)),
                                   torch.from_numpy(valid.reshape(-1)), M, P)
        t_row.apply_sparse(opt, store, stream, torch.from_numpy(dY), 0.01)
        want = j_row.get("toy_sign").apply_sparse(
            {"w": jnp.asarray(w)}, j_row.SparseStream(idx=jnp.asarray(idx), dY=jnp.asarray(dY),
                                                      valid=jnp.asarray(valid)), 0.01)
        np.testing.assert_array_equal(store["w"].numpy().view(np.int32),
                                      np.asarray(want["w"]).view(np.int32))
        assert not np.array_equal(store["w"].numpy(), w)
    finally:
        t_row.unregister("toy_sign")
        j_row.unregister("toy_sign")
    assert "toy_sign" not in t_row.names()
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        t_row.get("toy_sign")


def noop_kernel(*a):
    raise AssertionError("the plain path calls no kernel")


# ---------------------------------------------------------------------------
# concat_interaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,E", [(4, 3, 8), (16, 26, 16)])
def test_concat_interaction_bitwise(B, S, E):
    """The paper's Concat interaction: the dense vector and the flattened
    bags in fp32, bit for bit the reference's (bf16 inputs widened)."""
    rng = np.random.default_rng(B * S)
    dense = rng.standard_normal((B, E)).astype(np.float32)
    emb = rng.standard_normal((B, S, E)).astype(np.float32)
    got = t_inter.concat_interaction(torch.from_numpy(dense).to(torch.bfloat16),
                                     torch.from_numpy(emb))
    want = j_inter.concat_interaction(jnp.asarray(dense, jnp.bfloat16), jnp.asarray(emb))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, E + S * E)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("kind,self_interaction", [("dot", False), ("dot", True),
                                                   ("concat", False)])
def test_interaction_output_dim(kind, self_interaction):
    """``interaction_output_dim``'s dot, self-interaction and concat
    widths, the reference's."""
    for F, E in ((9, 64), (27, 128), (65, 256)):
        assert (t_inter.interaction_output_dim(F, E, kind, self_interaction)
                == j_inter.interaction_output_dim(F, E, kind, self_interaction))
    assert t_inter.interaction_output_dim(9, 64) == 64 + 36
