"""``repro_torch/dist/sharding.py`` (the FSDP / TP spec policy, ``batch_axes``,
``shard_shape``), the decode cache's sharding choice
(``repro_torch/models/lm_steps.py::cache_specs``) and the shape-only mesh
(``launch/mesh.py::make_production_mesh``, ``dist/comm.py``'s shape-only
groups) against the JAX package's.

No subprocess: the reference's policy is pure functions of a param tree
(``jax.eval_shape``) and of a mesh's axes, which a
``jax.sharding.AbstractMesh`` gives without devices (as
``tests/test_placement.py`` does).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import sharding as j_shd
from repro.models import lm_steps as j_lm
from repro.models import transformer as j_tf
from repro_torch.dist import comm
from repro_torch.dist import sharding as t_shd
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import lm_steps as t_lm
from repro_torch.models import transformer as t_tf

LM_MODULES = ("internlm2_1_8b", "gemma2_27b", "phi3_medium_14b", "qwen3_moe_30b_a3b",
              "deepseek_v2_236b")
POLICIES = ((True, True), (False, True), (True, False))


def abstract_mesh(shape, axes):
    try:
        return jax.sharding.AbstractMesh(tuple(shape), tuple(axes))
    except TypeError:   # jax < 0.5: AbstractMesh(((name, size), ...))
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def norm(spec, n: int) -> tuple:
    """A spec (the reference's ``PartitionSpec`` or the port's tuple) as one
    tuple of axis names a dim, padded to ``n`` dims."""
    spec = tuple(spec) + (None,) * (n - len(tuple(spec)))
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


def flat_specs(spec_tree, shape_tree, prefix=""):
    """``{path: normalised spec}`` of a port spec tree over its shape tree."""
    out = {}
    for k, v in spec_tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, shape_tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = norm(v, len(t_shd.leaf_shape(shape_tree[k])))
    return out


def ref_flat_specs(specs, shapes) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    sh = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    return {"/".join(str(k.key) for k in path): norm(p, len(sh[path].shape))
            for path, p in flat}


def example_tree():
    """``tests/test_placement.py``'s example tree, as shapes."""
    return {"embed": (64, 8),
            "layers": {"ln1": (4, 8),
                       "attn": {"wq": (4, 8, 16), "wo": (4, 16, 8)},
                       "mlp": {"wg": (4, 8, 32), "wd": (4, 32, 8)},
                       "moe": {"router": (4, 8, 4), "wg": (4, 4, 8, 16), "wd": (4, 4, 16, 8)}},
            "final_norm": (8,)}


def as_jnp(tree):
    return {k: as_jnp(v) if isinstance(v, dict) else jnp.zeros(v) for k, v in tree.items()}


@pytest.mark.parametrize("fsdp,tp", POLICIES)
def test_example_tree_specs(fsdp, tp):
    """``lm_param_specs`` on ``test_placement.py``'s example tree: every leaf's
    spec the reference's, under FSDP + TP, TP only and pure DP (ZeRO-3)."""
    shapes = example_tree()
    got = flat_specs(t_shd.lm_param_specs(shapes, fsdp=fsdp, tp=tp), shapes)
    want = ref_flat_specs(j_shd.lm_param_specs(as_jnp(shapes), fsdp=fsdp, tp=tp), as_jnp(shapes))
    assert got == want
    if fsdp and tp:
        assert got["embed"] == (("model",), ("data",))
        assert got["layers/moe/wg"] == ((), ("data",), (), ("model",))
    if fsdp and not tp:
        assert got["layers/attn/wq"] == ((), ("data", "model"), ())


def ref_config(module: str):
    import importlib
    return importlib.import_module(f"repro.configs.{module}").config()


def port_config(module: str):
    import importlib
    return importlib.import_module(f"repro_torch.configs.{module}").config()


@pytest.mark.parametrize("fsdp,tp", POLICIES)
@pytest.mark.parametrize("module", LM_MODULES)
def test_lm_param_specs_on_every_arch(module, fsdp, tp):
    """``lm_param_specs`` on each LM arch's full parameter tree
    (``transformer.param_shapes``), leaf by leaf against the reference's on
    ``jax.eval_shape(init_params)``: the same leaves, shapes and specs."""
    rcfg, tcfg = ref_config(module), port_config(module)
    rshapes = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0), rcfg))
    tshapes = t_tf.param_shapes(tcfg)
    want = ref_flat_specs(j_shd.lm_param_specs(rshapes, fsdp=fsdp, tp=tp), rshapes)
    got = flat_specs(t_shd.lm_param_specs(tshapes, fsdp=fsdp, tp=tp), tshapes)
    assert got == want


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data", "model"))])
def test_batch_and_all_axes(shape, axes):
    """``batch_axes`` / ``all_axes`` of the port's shape-only mesh are the
    reference's of an abstract mesh of the same shape."""
    tm = t_mesh.make_shape_mesh(shape, axes, device="cpu")
    am = abstract_mesh(shape, axes)
    assert t_shd.batch_axes(tm) == j_shd.batch_axes(am)
    assert t_shd.all_axes(tm) == j_shd.all_axes(am)


def _small(name, kv):
    return dict(name=name, n_layers=2, d_model=32, n_heads=4, n_kv_heads=kv, d_head=8, d_ff=64,
                vocab=64)


@pytest.mark.parametrize("kv,B,Lmax", [(4, 8, 16), (2, 8, 16), (2, 1, 64)])
def test_decode_cache_sharding_choice(kv, B, Lmax):
    """``test_placement.py::test_decode_cache_sharding_choice``'s three
    cases (HC2): heads over ``model`` when they divide it, else the head
    dim; B = 1 shards the sequence over the whole mesh."""
    am = abstract_mesh((2, 4), ("data", "model"))
    tm = t_mesh.make_shape_mesh((2, 4), ("data", "model"), device="cpu")
    _, spec, _ = j_lm.cache_structs(j_tf.TransformerConfig(**_small("a", kv)), am, B=B,
                                    Lmax=Lmax)
    got = t_lm.cache_specs(t_tf.TransformerConfig(**_small("a", kv)), tm, B)
    for k in ("k", "v"):
        assert norm(got[k], 5) == norm(spec[k], 5)
    want = {(4, 8): ((), ("data",), ("model",), (), ()),
            (2, 8): ((), ("data",), (), (), ("model",)),
            (2, 1): ((), (), (), ("data", "model"), ())}[(kv, B)]
    assert norm(got["k"], 5) == want


@pytest.mark.parametrize("module", LM_MODULES)
def test_decode_cache_specs_on_the_production_meshes(module):
    """Each LM arch's decode cache specs (GQA and MLA) at 16 x 16 and two
    pods, at decode_32k's B 128 and long_500k's B 1, the reference's."""
    rcfg, tcfg = ref_config(module), port_config(module)
    for shape, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        am = abstract_mesh(shape, axes)
        tm = t_mesh.make_shape_mesh(shape, axes, device="cpu")
        for B in (128, 1):
            _, spec, _ = j_lm.cache_structs(rcfg, am, B=B, Lmax=64)
            got = t_lm.cache_specs(tcfg, tm, B)
            assert sorted(got) == sorted(spec)
            for k in got:
                assert norm(got[k], 5 if not tcfg.mla else 4) == norm(
                    spec[k], 5 if not tcfg.mla else 4), (module, shape, B, k)


@pytest.mark.parametrize("shape,spec,want", [
    ((151937, 64), ("model", None), (37985, 64)),
    ((7, 3), ("model",), (2, 3)),
    ((100, 10), (("data", "model"), None), (13, 10)),
    ((5, 8, 9), (None, "data", "model"), (5, 4, 3)),
    ((6,), (), (6,)),
])
def test_shard_shape_rounds_up(shape, spec, want):
    """A leaf's per-rank shape at (2, 4): each sharded dim divided by its
    ranks and rounded up, as XLA pads a dim that does not divide."""
    assert t_shd.shard_shape(shape, spec, {"data": 2, "model": 4}) == want
    assert t_shd.shard_bytes(shape, torch.bfloat16, spec, {"data": 2, "model": 4}) == \
        2 * int(np.prod(want))


def test_production_mesh_shape_and_groups():
    """``make_production_mesh``: (16, 16) over (data, model) or (2, 16, 16)
    over (pod, data, model); every group shape-only, sized and indexed as
    ``make_mesh`` numbers ranks (first axis major)."""
    one = t_mesh.make_production_mesh(device="cpu")
    assert one.shape == {"data": 16, "model": 16} and one.size == 256 and one.shape_only
    two = t_mesh.make_production_mesh(multi_pod=True, rank=300, device="cpu")
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert {k: (g.size, g.index) for k, g in two.groups.items()} == {
        ("pod",): (2, 1), ("data",): (16, 2), ("model",): (16, 12),
        ("pod", "data", "model"): (512, 300), ("pod", "data"): (32, 18)}
    assert all(g.pg is comm.SHAPE_ONLY and g.backend is None for g in two.groups.values())
    assert comm.local_group().pg is None and not comm.local_group().shape_only


def test_shape_only_collectives_count_bytes_and_return_own_share():
    """Each collective over a shape-only group of 4 counts the bytes a real
    one does and returns what it would if every other rank held zeros: this
    rank's block in place (gathers, all-to-all), its own term (sums), zeros
    (a ring shift); dtype and device kept."""
    mesh = t_mesh.make_shape_mesh((1, 4), ("data", "model"), rank=2, device="cpu")
    g = mesh.group("model")
    x = torch.arange(1, 25, dtype=torch.float32).reshape(8, 3)
    ag = comm.all_gather(x.to(torch.bfloat16), g)
    assert ag.dtype == torch.bfloat16 and tuple(ag.shape) == (32, 3)
    assert torch.equal(ag[16:24].float(), x) and not ag[:16].any() and not ag[24:].any()
    out = torch.full((32, 3), 7.0)
    comm.all_gather(x, g, out=out)
    assert torch.equal(out[16:24], x) and not out[:16].any()
    a2a = comm.all_to_all(x, g, 0, 1)
    assert tuple(a2a.shape) == (2, 12) and torch.equal(a2a[:, 6:9], x[4:6])
    assert not a2a[:, :6].any() and not a2a[:, 9:].any()
    assert torch.equal(comm.psum_scatter(x, g), x[4:6])
    assert torch.equal(comm.psum(x, g), x)
    assert not comm.ppermute(x, g).any()
    want_out = {"all-gather": 32 * 3 * 2 + 32 * 3 * 4, "all-to-all": 24 * 4,
                "reduce-scatter": 6 * 4, "all-reduce": 24 * 4, "collective-permute": 24 * 4}
    assert mesh.stats.bytes_out == want_out
    assert mesh.stats.calls == {"all-gather": 2, "all-to-all": 1, "reduce-scatter": 1,
                                "all-reduce": 1, "collective-permute": 1}
    # under autograd: the transposes run over the same group
    xs = x.clone().requires_grad_()
    comm.all_gather_ad(xs, g).sum().backward()
    assert torch.equal(xs.grad, torch.ones_like(x))


def test_resolve_mesh_refuses_a_shape_only_mesh():
    """A shape-only mesh is refused by ``resolve_mesh`` (so by every step
    factory) outside ``shape_only_meshes``, taken inside it."""
    from repro_torch.core import hybrid
    from repro_torch.configs.dlrm_paper import dlrm_small
    mesh = t_mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="shape-only"):
        t_mesh.resolve_mesh(mesh)
    with pytest.raises(ValueError, match="shape-only"):
        hybrid.make_train_step(dlrm_small(), mesh)
    with t_mesh.shape_only_meshes():
        assert t_mesh.resolve_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="shape-only"):
        t_mesh.resolve_mesh(mesh)


def test_run_loop_and_server_refuse_a_shape_only_mesh():
    """The run loop and the server refuse a shape-only mesh, inside
    ``shape_only_meshes`` too."""
    from repro_torch import train
    from repro_torch.configs.dlrm_paper import dlrm_small
    from repro_torch.serve import snapshot
    mesh = t_mesh.make_shape_mesh((2, 4), ("data", "model"), device="cpu")
    with t_mesh.shape_only_meshes():
        with pytest.raises(ValueError, match="the run loop refuses a shape-only"):
            train.TrainLoop(train.TrainLoopConfig(steps=1), lambda s, b: (s, 0), {}, iter(()),
                            mesh=mesh, model_cfg=dlrm_small())
        with pytest.raises(ValueError, match="the server refuses a shape-only"):
            snapshot.make_bucket_scorers(dlrm_small(), (8,), lambda: None, mesh=mesh)
        with pytest.raises(ValueError, match="the server refuses a shape-only"):
            snapshot.follow({}, mesh)
        with pytest.raises(ValueError, match="the server refuses a shape-only"):
            snapshot.release(mesh)


def test_launcher_refuses_a_shape_only_mesh(monkeypatch):
    """The launcher's mesh comes from ``make_mesh``, which builds no
    shape-only mesh; one slipped in for it is refused by the first step
    factory the launcher reaches, before any step runs."""
    from repro_torch.launch import train as launch
    monkeypatch.setattr(launch, "make_mesh", lambda shape, axes, device: t_mesh.make_shape_mesh(
        (2, 4), axes, device=device))
    args = launch.parser().parse_args(["--arch", "dlrm-smoke", "--device", "cpu", "--steps", "1"])
    with pytest.raises(ValueError, match="a step outside the dry run refuses a shape-only"):
        launch.run(0, 1, args)
    assert not t_mesh.make_mesh((1, 1), ("data", "model"), device="cpu").shape_only
