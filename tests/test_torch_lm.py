"""The port's LM serving path (``repro_torch.models.{transformer,lm_steps}``)
against the JAX package's, on the five archs' reduced configs (the sizes of
``tests/test_models.py::reduced``: 4 layers, d_model 64; MoE with 8
experts, top 2 and capacity factor 8, so that nothing drops; deepseek-v2
with a first dense layer, a shared expert and MLA) with
``attn_impl="pallas"``: the Pallas flash kernel in interpret mode on the JAX
side, the kernel's plain version on the port's.  deepseek-v2 runs on
``"chunked"``: the reference cannot run MLA on its kernel.  The JAX
parameters are cast to bf16 (the serving step's dtype) and carried across
with ``repro_torch.weights.lm_params_from_numpy``.  The MoE block alone
(where pairs drop) is ``tests/test_torch_moe.py``.

The tolerances: jitted XLA on the CPU keeps some bf16 intermediates in fp32
across a fusion (``--xla_allow_excess_precision``, on by default), e.g. the
residual sum that feeds the next layer's RMSNorm, where the port rounds
each to bf16 as the reference's code reads.  So from layer 1 on, bf16
roundings part, and the logits (about 0.55 at most) agree within 2e-2 (7e-3
measured).  With that flag off (a subprocess, below), the same comparison
agrees to the last bit for gemma2 and within a few bf16 flips for
internlm2.

A router is not continuous: at the default flag, an input one bf16 ulp
apart flips a top-k choice between two near-equal experts (qwen3-moe at
one token of 64 from layer 1 on, deepseek-v2 at two), and that token's
cache entries in the layers above move by up to 2.4, which no tolerance
could hold.  So the MoE archs' prefill is held to the JAX prefill with the
flag off, which rounds as the reference's code reads: deepseek-v2's caches
then agree bit for bit, qwen3-moe's within 0.03.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (deepseek_v2_236b as jdeepseek, gemma2_27b as jgemma,
                           internlm2_1_8b as jintern, phi3_medium_14b as jphi3,
                           qwen3_moe_30b_a3b as jqwen3)
from repro.models import transformer as jtf
from repro_torch import weights
from repro_torch.configs import (deepseek_v2_236b, gemma2_27b, internlm2_1_8b, phi3_medium_14b,
                                 qwen3_moe_30b_a3b)
from repro_torch.kernels import ops
from repro_torch.models import lm_steps
from repro_torch.models import transformer as tf
from repro_torch.testing import assert_close, to_numpy

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["internlm2-1.8b", "gemma2-27b", "phi3-medium-14b", "qwen3-moe-30b-a3b",
         "deepseek-v2-236b"]
DENSE = NAMES[:2]   # the excess-precision claim of the module note
MOE = NAMES[3:]     # held to the JAX prefill without excess precision (the module note)
B, L = 2, 32


def _reduced(name: str) -> jtf.TransformerConfig:
    """tests/test_models.py::reduced, pallas attention (chunked for MLA)."""
    base = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                seq_shard=False, tp_size=1, tie_embeddings=False, attn_impl="pallas")
    if name == "qwen3-moe-30b-a3b":
        base.update(n_experts=8, top_k=2, moe_d_ff=32, capacity_factor=8.0)
    if name == "deepseek-v2-236b":
        base.update(n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=1, first_dense_layers=1,
                    mla=True, q_lora=32, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16,
                    n_kv_heads=4, capacity_factor=8.0, attn_impl="chunked")
    if name == "gemma2-27b":
        base.update(local_global=True, window=16, attn_softcap=50.0, final_softcap=30.0,
                    embed_scale=True, tie_embeddings=True)
    if name == "phi3-medium-14b":
        base.update(n_heads=8, n_kv_heads=2)
    return jtf.TransformerConfig(name=name, **base)


def _port_cfg(cfg: jtf.TransformerConfig) -> tf.TransformerConfig:
    return tf.TransformerConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(jtf.TransformerConfig)})


def _setup(name, seed=0):
    cfg = _reduced(name)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          jtf.init_params(jax.random.PRNGKey(seed), cfg))
    tparams = weights.lm_params_from_numpy(jax.tree.map(np.asarray, params), _port_cfg(cfg),
                                           device="cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    return cfg, params, tparams, toks


def _at(c, b: int, p):
    """Row ``b``'s cache entries at positions ``p`` (the L axis is the
    second to last in both layouts)."""
    return c[:, b][..., p, :]


def _grow(cache: dict, Lmax: int) -> dict:
    out = {k: torch.zeros(v.shape[:-2] + (Lmax, v.shape[-1]), dtype=v.dtype)
           for k, v in cache.items()}
    for k in out:
        out[k][..., :cache[k].shape[-2], :] = cache[k]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(name, exact):
    """Logits within 2e-2 (see the module note); the layer-0 cache equal
    bit for bit (nothing has rounded apart before it); every layer's cache
    (k and v, or MLA's c_kv and k_rope) within 0.1 of values of standard
    deviation about 1.  The kernel's launch count does not move on the
    CPU.  The MoE archs: the JAX prefill without excess precision."""
    cfg, params, tparams, toks = _setup(name)
    if name in MOE:
        want = exact[name + "/logits"]
        want_cache = {k: exact[f"{name}/{k}"] for k in tf.cache_shapes(_port_cfg(cfg), B, L)}
    else:
        want, want_cache = jax.jit(lambda p, t: jtf.prefill(p, t, cfg))(
            params, jnp.asarray(toks[:, :L]))
    step, (_, tstruct) = lm_steps.make_prefill_step(_port_cfg(cfg), B, L, device="cpu")
    before = ops.flash_attention.launches
    got, cache = step(tparams, torch.from_numpy(toks[:, :L]))
    assert ops.flash_attention.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, cfg.vocab)
    assert tstruct == ((B, L), torch.int32)
    assert_close(got, np.asarray(want), rtol=0, atol=2e-2, what="logits")
    shapes = tf.cache_shapes(_port_cfg(cfg), B, L)
    assert set(cache) == set(want_cache) == set(shapes)
    for k in shapes:
        w = np.asarray(want_cache[k]).astype(np.float32)
        c = to_numpy(cache[k])
        assert c.shape == w.shape == shapes[k]
        assert np.array_equal(c[0], w[0]), f"layer-0 {k} cache"
        assert_close(c, w, rtol=0, atol=0.1, what=f"{k} cache")


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_jax(name):
    """One decode step from the same cache (the JAX prefill's, grown to
    L + 8) and token: logits within 2e-2 (the module note), this token's
    cache entries written at each row's pos (rows at other positions), the
    rest of the cache untouched."""
    cfg, params, tparams, toks = _setup(name)
    _, jcache = jax.jit(lambda p, t: jtf.prefill(p, t, cfg))(params, jnp.asarray(toks[:, :L]))
    Lmax = L + 8
    cache_np = {k: np.asarray(v) for k, v in jcache.items()}
    pos = np.array([L, L - 5], np.int32)   # the second row overwrites an earlier slot
    jgrown = jax.tree.map(lambda a: jnp.zeros(a.shape[:-2] + (Lmax, a.shape[-1]), a.dtype
                                              ).at[..., :L, :].set(a), jcache)
    want, want_cache = jax.jit(lambda p, c, t, q: jtf.decode_step(p, c, t, q, cfg))(
        params, jgrown, jnp.asarray(toks[:, L]), jnp.asarray(pos))
    cache = _grow({k: weights.to_torch(v) for k, v in cache_np.items()}, Lmax)
    before = {k: v.clone() for k, v in cache.items()}
    step, structs = lm_steps.make_decode_step(_port_cfg(cfg), B, Lmax, device="cpu")
    assert structs[1] == {k: (s, torch.bfloat16)
                          for k, s in tf.cache_shapes(_port_cfg(cfg), B, Lmax).items()}
    got, out = step(tparams, cache, torch.from_numpy(toks[:, L]), torch.from_numpy(pos))
    assert out is cache   # written in place
    assert_close(got, np.asarray(want), rtol=0, atol=2e-2, what="logits")
    for k in cache:
        w = np.asarray(want_cache[k]).astype(np.float32)
        for b in range(B):
            assert_close(to_numpy(_at(cache[k], b, pos[b])), _at(w, b, pos[b]), rtol=0,
                         atol=0.1, what=f"{k} written at row {b}")
            keep = np.ones(Lmax, bool)
            keep[pos[b]] = False
            assert torch.equal(_at(cache[k], b, keep), _at(before[k], b, keep))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_prefill(name):
    """Next-token logits from (prefill L, decode 1) match the prefill of
    L + 1 tokens within 5e-2, the tolerance of
    ``tests/test_models.py::test_decode_matches_prefill``: the decode path
    runs a one-shot softmax, the prefill the kernel's tiled one with ``p``
    rounded to bf16 against a running max."""
    cfg, _, tparams, toks = _setup(name, seed=1)
    pcfg = _port_cfg(cfg)
    _, cache = lm_steps.make_prefill_step(pcfg, B, L, device="cpu")[0](
        tparams, torch.from_numpy(toks[:, :L]))
    decode, _ = lm_steps.make_decode_step(pcfg, B, L + 1, device="cpu")
    got, _ = decode(tparams, _grow(cache, L + 1), torch.from_numpy(toks[:, L]),
                    torch.full((B,), L, dtype=torch.int32))
    want, _ = lm_steps.make_prefill_step(pcfg, B, L + 1, device="cpu")[0](
        tparams, torch.from_numpy(toks))
    assert_close(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "deepseek-v2-236b"])
def test_prefill_microbatch_chunks_the_batch(name):
    """``prefill_microbatch`` 2 runs the batch in two sequential halves,
    each writing its rows of one cache: the same logits and cache as one
    chunk (each row is computed on its own; MoE routes each sequence on its
    own), within 1e-6 for the fp32 logits and bit for bit in the cache."""
    cfg, _, tparams, _ = _setup(name)
    pcfg = _port_cfg(cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (4, L)))
    want, want_cache = lm_steps.make_prefill_step(pcfg, 4, L, device="cpu")[0](tparams, toks)
    got, cache = lm_steps.make_prefill_step(dataclasses.replace(pcfg, prefill_microbatch=2), 4, L,
                                            device="cpu")[0](tparams, toks)
    assert_close(got, want, rtol=0, atol=1e-6)
    assert set(cache) == set(want_cache)
    for k in cache:
        assert torch.equal(cache[k], want_cache[k])


def test_steps_check_their_inputs():
    cfg = _port_cfg(_reduced("internlm2-1.8b"))
    prefill, _ = lm_steps.make_prefill_step(cfg, B, L, device="cpu")
    with pytest.raises(ValueError, match="tokens"):
        prefill({}, torch.zeros((B, L + 1), dtype=torch.int32))
    decode, (_, cstructs, _, _) = lm_steps.make_decode_step(cfg, B, L, device="cpu")
    cache = {k: torch.zeros(s, dtype=d) for k, (s, d) in cstructs.items()}
    with pytest.raises(ValueError, match="pos"):
        decode({}, cache, torch.zeros(B, dtype=torch.int32), torch.zeros(B + 1, dtype=torch.int32))
    with pytest.raises(TypeError, match="cache"):
        decode({}, {k: v.float() for k, v in cache.items()}, torch.zeros(B, dtype=torch.int32),
               torch.zeros(B, dtype=torch.int32))


@pytest.mark.parametrize("call", ["prefill_step", "decode_step", "init_lm_params", "prefill"])
def test_mla_on_pallas_is_refused(call):
    """MLA under ``attn_impl="pallas"`` is the one refusal left (the
    reference cannot run it either); MoE and MLA on the chunked path pass
    the same entry points' check."""
    cfg = dataclasses.replace(_port_cfg(_reduced("deepseek-v2-236b")), attn_impl="pallas")
    calls = {"prefill_step": lambda c: lm_steps.make_prefill_step(c, B, L, device="cpu"),
             "decode_step": lambda c: lm_steps.make_decode_step(c, B, L, device="cpu"),
             "init_lm_params": lambda c: weights.init_lm_params(c, torch.Generator(), device="cpu"),
             "prefill": lambda c: tf.check_supported(c) or tf.prefill(
                 {}, torch.zeros((B, L), dtype=torch.int32), c)}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        calls[call](cfg)
    if call != "prefill":
        for name in ("deepseek-v2-236b", "qwen3-moe-30b-a3b"):
            calls[call](_port_cfg(_reduced(name)))


def test_lm_params_from_numpy_is_bitwise_and_checks_the_tree():
    cfg, params, tparams, _ = _setup("gemma2-27b")
    assert "unembed" not in tparams   # tied
    flat_j = jax.tree.leaves(params)
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t)
    for a, t in zip(flat_j, flat_t):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(a).astype(np.float32), to_numpy(t))
    pnp = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="wq"):
        bad = jax.tree.map(lambda a: a, pnp)
        bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :8]
        weights.lm_params_from_numpy(bad, _port_cfg(cfg), device="cpu")
    with pytest.raises(ValueError, match="embed"):
        weights.lm_params_from_numpy({**pnp, "embed": pnp["embed"].astype(np.float32)},
                                     _port_cfg(cfg), device="cpu")
    with pytest.raises(ValueError, match="unembed"):
        weights.lm_params_from_numpy({**pnp, "unembed": pnp["embed"].T}, _port_cfg(cfg),
                                     device="cpu")
    copy = weights.lm_params_to(tparams, "cpu")
    assert copy["embed"] is not tparams["embed"] and torch.equal(copy["embed"], tparams["embed"])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_lm_params_from_numpy_takes_the_moe_and_mla_trees(name):
    """The MoE leaves (router, the experts' stacks, the shared expert), MLA's
    attention leaves and the dense_layers stack carried bit for bit; a leaf
    of another shape and a missing stack are refused."""
    cfg, params, tparams, _ = _setup(name)
    assert set(tparams["layers"]) == {"ln1", "ln2", "attn", "moe"}
    assert ("dense_layers" in tparams) == (cfg.first_dense_layers > 0)
    flat_j = jax.tree.leaves(params)
    flat_t = jax.tree.leaves(tparams)
    assert len(flat_j) == len(flat_t)
    for a, t in zip(flat_j, flat_t):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(a).astype(np.float32), to_numpy(t))
    pnp = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="wg"):
        bad = jax.tree.map(lambda a: a, pnp)
        bad["layers"]["moe"]["wg"] = bad["layers"]["moe"]["wg"][:, :-1]
        weights.lm_params_from_numpy(bad, _port_cfg(cfg), device="cpu")
    if cfg.mla:
        with pytest.raises(ValueError, match="dense_layers"):
            weights.lm_params_from_numpy({k: v for k, v in pnp.items() if k != "dense_layers"},
                                         _port_cfg(cfg), device="cpu")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-236b"])
def test_init_lm_params_follows_the_reference_moe_and_mla_distributions(name):
    """The reference's tree, and its scales: an expert stack [E, d, f] ~
    N(0, 1/E) (the reference scales by the leaf's first dim), the router
    N(0, 1/d), MLA's wkv_b N(0, 1/kv_lora), its norms 0."""
    cfg = _port_cfg(_reduced(name))
    p = weights.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, p)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                                         _reduced(name)))))
    moe = p["layers"]["moe"]
    for leaf, scale in (("wg", cfg.n_experts), ("wd", cfg.n_experts), ("router", cfg.d_model)):
        std = scale ** -0.5
        assert abs(float(moe[leaf].float().std()) - std) < 0.1 * std, leaf
    if cfg.mla:
        attn = p["layers"]["attn"]
        assert not attn["q_norm"].any() and not attn["kv_norm"].any()
        std = cfg.kv_lora ** -0.5
        assert abs(float(attn["wkv_b"].float().std()) - std) < 0.1 * std
        std = cfg.d_ff ** -0.5
        assert abs(float(p["dense_layers"]["mlp"]["wd"].float().std()) - std) < 0.1 * std


def test_init_lm_params_follows_the_reference_distributions():
    cfg = _port_cfg(_reduced("internlm2-1.8b"))
    p = weights.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda x: 0, p)) == jax.tree.structure(
        jax.tree.map(lambda x: 0, jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                                         _reduced(cfg.name)))))
    for a in jax.tree.leaves(p):
        assert a.dtype == torch.bfloat16
    assert not p["layers"]["ln1"].any() and not p["final_norm"].any()
    assert abs(float(p["embed"].float().std()) - 0.02) < 2e-3
    std = cfg.d_ff ** -0.5
    assert abs(float(p["layers"]["mlp"]["wd"].float().std()) - std) < 0.1 * std


@pytest.mark.parametrize("port,ref", [(internlm2_1_8b, jintern), (gemma2_27b, jgemma),
                                      (phi3_medium_14b, jphi3), (qwen3_moe_30b_a3b, jqwen3),
                                      (deepseek_v2_236b, jdeepseek)])
def test_configs_match_the_reference(port, ref):
    """Every field, the parameter counts and windows; the port's tree holds
    exactly ``param_count()`` values beside the norms it leaves out (the
    final norm, MLA's q and kv norms), counted on the meta device."""
    a, b = port.config(), ref.config()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.param_count() == b.param_count()
    assert a.moe == b.moe and a.active_param_count() == b.active_param_count()
    assert a.layer_windows() == b.layer_windows() and a.attn_scale == b.attn_scale
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(tf.param_shapes(a),
                                                      is_leaf=lambda x: isinstance(x, tuple)))
    assert n == a.param_count() + a.d_model + a.n_layers * (a.q_lora + a.kv_lora) * a.mla
    if a.name == "internlm2-1.8b":
        assert 1.88e9 < a.param_count() < 1.90e9


_EXACT = """
import jax, jax.numpy as jnp, numpy as np
from repro.models import transformer as jtf
out = {{}}
for fields in {cfgs!r}:
    cfg = jtf.TransformerConfig(**fields)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          jtf.init_params(jax.random.PRNGKey(0), cfg))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, ({B}, {L} + 1)).astype(np.int32)
    logits, cache = jax.jit(lambda p, t: jtf.prefill(p, t, cfg))(params, jnp.asarray(toks[:, :{L}]))
    out[cfg.name + "/logits"] = np.asarray(logits)
    for k in cache:
        out[cfg.name + "/" + k] = np.asarray(cache[k]).astype(np.float32)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def exact(tmp_path_factory):
    """The JAX prefill of the DENSE and MOE archs' reduced configs with XLA's
    excess precision off, in one subprocess (so that no other test sees the
    flag): ``{name}/logits`` and ``{name}/{cache key}``."""
    path = tmp_path_factory.mktemp("exact") / "jax_prefill.npz"
    env = {**os.environ, "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    code = _EXACT.format(cfgs=[dataclasses.asdict(_reduced(n)) for n in DENSE + MOE], B=B, L=L,
                         path=str(path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(path)


def test_prefill_matches_jax_without_excess_precision(exact):
    """The module note's claim: with XLA's excess precision off (in a
    subprocess, so that no other test sees the flag), the JAX prefill
    rounds each bf16 value as its code reads, and the port agrees: gemma2's
    logits within 1e-6 and its caches bit for bit; internlm2's logits
    within 4e-3 (1.5e-3 measured) and 99 % of its cache bit for bit (an
    exponential or a sum an ulp apart flips a bf16 rounding from layer 2
    on)."""
    want = exact
    for name in DENSE:
        cfg, _, tparams, toks = _setup(name)
        got, cache = tf.prefill(tparams, torch.from_numpy(toks[:, :L]), _port_cfg(cfg))
        exact = name == "gemma2-27b"
        assert_close(got, want[name + "/logits"], rtol=0, atol=1e-6 if exact else 4e-3,
                     what=name)
        for k in ("k", "v"):
            same = to_numpy(cache[k]) == want[f"{name}/{k}"]
            assert same.all() if exact else same.mean() >= 0.99, f"{name} {k} cache"
