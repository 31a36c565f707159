"""repro_torch.models against repro.models: layers, attention (full,
prefill, decode with per-row positions and ring wrap), the dense stack's
embedded entry points, with weights carried across by
``params_from_jax``, and the Mamba2 block (causal conv, chunked SSD with
an initial state, the whole block, its init)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models.config import ArchConfig as JaxArchConfig
from repro.policies import network as jax_network
from repro_torch.models import attention, layers, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.policies import network

# The JAX side runs jitted (ArchConfig is hashable), as its callers do.
_jax_init = jax.jit(jax_network.init, static_argnums=(1, 2, 3))
_jax_prefill = jax.jit(jax_tf.prefill_embedded, static_argnums=1)
_jax_decode = jax.jit(jax_tf.decode_step_embedded, static_argnums=1,
                      static_argnames="backend")

LAYER_TOL = 1e-5
ATTN_TOL = 1e-4
ARCH = dict(name="t", arch_type="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=3, head_dim=16,
            sliding_window=4, tie_embeddings=True)


def _arch(**kw):
    fields = dict(ARCH, **kw)
    return ArchConfig(**fields), JaxArchConfig(**fields)


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               atol=tol, rtol=tol)


def _attn_params(rng, arch):
    d, h, kv, hd = arch.d_model, arch.num_heads, arch.num_kv_heads, \
        arch.head_dim
    p = {"wq": rng.randn(d, h, hd), "wk": rng.randn(d, kv, hd),
         "wv": rng.randn(d, kv, hd), "wo": rng.randn(h, hd, d)}
    p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
    return ({k: torch.as_tensor(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


# ==================================================================== layers
def test_rmsnorm_matches():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 32).astype(np.float32)
    scale = rng.rand(32).astype(np.float32) + 0.5
    _close(layers.rmsnorm({"scale": torch.as_tensor(scale)},
                          torch.as_tensor(x)),
           jax_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           LAYER_TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches(per_row):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    positions = (rng.randint(0, 40, (3, 5)) if per_row
                 else np.arange(5)[None, :])
    _close(layers.apply_rope(torch.as_tensor(x), torch.as_tensor(positions),
                             10_000.0),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                 10_000.0),
           LAYER_TOL)


def test_swiglu_mlp_matches():
    rng = np.random.RandomState(2)
    p = {"w_gate": rng.randn(32, 64), "w_up": rng.randn(32, 64),
         "w_down": rng.randn(64, 32)}
    p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 3, 32).astype(np.float32)
    _close(layers.mlp({k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x)),
           jax_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x)),
           LAYER_TOL)


def test_init_shapes_and_scales_match_reference():
    arch, jarch = _arch()
    gen = torch.Generator().manual_seed(0)
    ours = network.init(gen, arch, 50, 3, device="cpu")
    ref = jax.tree.map(np.asarray, _jax_init(jax.random.key(0), jarch, 50, 3))
    carried = network.params_from_jax(ref, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path

    def leaves(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                flat(tree)[0]}

    ours_leaves, ref_leaves = leaves(ours), leaves(carried)
    assert ours_leaves.keys() == ref_leaves.keys()
    for name, value in ours_leaves.items():
        assert value.shape == ref_leaves[name].shape, name
        if value.size > 64 and value.std() > 0:       # init scale agrees
            assert value.std() == pytest.approx(ref_leaves[name].std(),
                                                rel=0.15), name
    # a fixed generator seed gives the same weights every time
    again = network.init(torch.Generator().manual_seed(0), arch, 50, 3,
                         device="cpu")
    assert torch.equal(again["blocks"][1]["attn"]["wq"],
                       ours["blocks"][1]["attn"]["wq"])


# ================================================================= attention
@pytest.mark.parametrize("window", [None, 3])
def test_full_sequence_attention_matches(window):
    arch, jarch = _arch(sliding_window=window)
    tp, jp = _attn_params(np.random.RandomState(3), arch)
    x = np.random.RandomState(4).randn(2, 6, 32).astype(np.float32)
    _close(attention.attention(tp, arch, torch.as_tensor(x),
                               torch.arange(6)),
           jax_attn.attention(jp, jarch, jnp.asarray(x), jnp.arange(6)),
           ATTN_TOL)


def test_full_sequence_attention_dispatches_through_ops_on_cpu():
    """``ops`` alone picks kernel or plain version: on CPU tensors
    ``attention`` still calls ``ops.flash_attention``, with the unrepeated
    GQA K/V, and launches no kernel."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    arch, _ = _arch(sliding_window=3)
    tp, _ = _attn_params(np.random.RandomState(3), arch)
    x = torch.as_tensor(np.random.RandomState(4).randn(2, 6, 32),
                        dtype=torch.float32)
    shapes, dispatch = [], ops.flash_attention

    def spy(q, k, v, **kwargs):
        shapes.append((tuple(q.shape), tuple(k.shape), kwargs))
        return dispatch(q, k, v, **kwargs)

    before = flash_attention.launches
    expected = attention.attention(tp, arch, x, torch.arange(6))
    with mock.patch.object(attention.ops, "flash_attention", spy):
        out = attention.attention(tp, arch, x, torch.arange(6))
    h, kv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    assert shapes == [((2, h, 6, hd), (2, kv, 6, hd),
                       {"causal": True, "window": 3})]
    assert torch.equal(out, expected)
    assert flash_attention.launches == before


def test_prefill_attention_matches_with_lengths():
    arch, jarch = _arch()
    tp, jp = _attn_params(np.random.RandomState(5), arch)
    x = np.random.RandomState(6).randn(3, 4, 32).astype(np.float32)
    lengths = np.asarray([4, 2, 1], np.int32)
    cache = attention.init_kv_cache(arch, 3, 4, torch.float32, "cpu")
    jcache = jax_attn.init_kv_cache(jarch, 3, 4, jnp.float32)
    out, cache = attention.prefill_attention(
        tp, arch, torch.as_tensor(x), cache, torch.arange(4),
        torch.as_tensor(lengths))
    jout, jcache = jax_attn.prefill_attention(
        jp, jarch, jnp.asarray(x), jcache, jnp.arange(4),
        jnp.asarray(lengths))
    _close(out, jout, ATTN_TOL)
    _close(cache["k"], jcache["k"], ATTN_TOL)
    _close(cache["v"], jcache["v"], ATTN_TOL)


@pytest.mark.parametrize("backend,jax_backend", [("grouped", "jnp"),
                                                 ("ref", "ref")])
@pytest.mark.parametrize("window", [4, None])
def test_decode_attention_per_row_positions_and_ring_wrap(backend,
                                                          jax_backend,
                                                          window):
    """Rows at different depths in one dispatch, some past the ring wrap
    (pos >= L writes slot pos mod L; all L keys stay valid)."""
    arch, jarch = _arch(sliding_window=window)
    tp, jp = _attn_params(np.random.RandomState(7), arch)
    rng = np.random.RandomState(8)
    length = 4 if window else 12
    k0 = rng.randn(5, length, 2, 16).astype(np.float32)
    v0 = rng.randn(5, length, 2, 16).astype(np.float32)
    x = rng.randn(5, 1, 32).astype(np.float32)
    pos = np.asarray([0, 2, 3, 6, 9] if window else [0, 2, 3, 6, 11],
                     np.int32)
    cache = {"k": torch.as_tensor(k0.copy()), "v": torch.as_tensor(v0.copy())}
    out, cache = attention.decode_attention(
        tp, arch, torch.as_tensor(x), cache, torch.as_tensor(pos),
        backend=backend)
    jout, jcache = jax_attn.decode_attention(
        jp, jarch, jnp.asarray(x), {"k": jnp.asarray(k0),
                                    "v": jnp.asarray(v0)},
        jnp.asarray(pos), backend=jax_backend)
    _close(out, jout, ATTN_TOL)
    _close(cache["k"], jcache["k"], ATTN_TOL)
    _close(cache["v"], jcache["v"], ATTN_TOL)


def test_decode_attention_scalar_position():
    arch, jarch = _arch()
    tp, jp = _attn_params(np.random.RandomState(9), arch)
    rng = np.random.RandomState(10)
    k0 = rng.randn(2, 4, 2, 16).astype(np.float32)
    x = rng.randn(2, 1, 32).astype(np.float32)
    cache = {"k": torch.as_tensor(k0.copy()), "v": torch.as_tensor(k0.copy())}
    out, _ = attention.decode_attention(tp, arch, torch.as_tensor(x), cache,
                                        5, backend="grouped")
    jout, _ = jax_attn.decode_attention(
        jp, jarch, jnp.asarray(x), {"k": jnp.asarray(k0),
                                    "v": jnp.asarray(k0)},
        jnp.int32(5), backend="jnp")
    _close(out, jout, ATTN_TOL)


# ========================================================= the dense stack
def _stack(seed=0):
    arch, jarch = _arch()
    jparams = _jax_init(jax.random.key(seed), jarch, 50, 3)
    params = network.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    jstack = {"blocks": jparams["blocks"], "final_norm": jparams["final_norm"]}
    return arch, jarch, params, jstack


def test_forward_embedded_matches():
    arch, jarch, params, jstack = _stack()
    x = np.random.RandomState(11).randn(2, 7, 32).astype(np.float32)
    feats = transformer.forward_embedded(params, arch, torch.as_tensor(x))
    jfeats, _ = jax_tf.forward_embedded(jstack, jarch, jnp.asarray(x))
    _close(feats, jfeats, ATTN_TOL)


@pytest.mark.parametrize("backend,jax_backend", [("grouped", "jnp"),
                                                 ("ref", "ref")])
def test_prefill_then_decode_steps_match(backend, jax_backend):
    """prefill_embedded with ragged lengths, then decode steps with per-row
    positions through the stacked ring cache, past the wrap."""
    arch, jarch, params, jstack = _stack(1)
    rng = np.random.RandomState(12)
    x = rng.randn(3, 4, 32).astype(np.float32)
    lengths = np.asarray([4, 2, 1], np.int32)
    cache = transformer.init_cache(arch, 3, 4, torch.float32, "cpu")
    jcache = jax_tf.init_cache(jarch, 3, 4, jnp.float32)
    feats, cache = transformer.prefill_embedded(
        params, arch, cache, torch.as_tensor(x),
        lengths=torch.as_tensor(lengths))
    jfeats, jcache = _jax_prefill(jstack, jarch, jcache, jnp.asarray(x),
                                  lengths=jnp.asarray(lengths))
    _close(feats, jfeats, ATTN_TOL)
    pos = lengths.copy()
    for _ in range(6):
        step = rng.randn(3, 1, 32).astype(np.float32)
        feats, cache = transformer.decode_step_embedded(
            params, arch, cache, torch.as_tensor(step), torch.as_tensor(pos),
            backend=backend)
        jfeats, jcache = _jax_decode(jstack, jarch, jcache, jnp.asarray(step),
                                     jnp.asarray(pos), backend=jax_backend)
        _close(feats, jfeats, ATTN_TOL)
        pos += 1
    _close(cache["kv"]["k"], jcache["kv"]["k"], ATTN_TOL)
    _close(cache["kv"]["v"], jcache["kv"]["v"], ATTN_TOL)


def test_params_from_jax_splits_the_layer_axis():
    arch, _, params, jstack = _stack(2)
    assert len(params["blocks"]) == arch.num_layers
    for i, block in enumerate(params["blocks"]):
        np.testing.assert_array_equal(
            block["attn"]["wo"].numpy(),
            np.asarray(jstack["blocks"]["attn"]["wo"][i]))
        np.testing.assert_array_equal(
            block["mlp"]["w_down"].numpy(),
            np.asarray(jstack["blocks"]["mlp"]["w_down"][i]))


# ============================================================ Mamba2 (SSD)
def _ssm_arch(**kw):
    from repro import configs as jax_configs
    from repro_torch import configs
    import dataclasses
    return (dataclasses.replace(configs.reduced(
                configs.get_arch("zamba2-1.2b")), **kw),
            dataclasses.replace(jax_configs.reduced(
                jax_configs.get_arch("zamba2-1.2b")), **kw))


def _scaled_close(actual, expected, tol):
    expected = np.asarray(expected)
    scale = np.abs(expected).max() + 1.0
    np.testing.assert_allclose(np.asarray(actual) / scale, expected / scale,
                               atol=tol)


def test_causal_conv_matches():
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    rng = np.random.RandomState(20)
    w = rng.randn(4, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    xbc = rng.randn(2, 9, 24).astype(np.float32)
    _close(ssm._causal_conv(torch.as_tensor(w), torch.as_tensor(b),
                            torch.as_tensor(xbc)),
           jax_ssm._causal_conv(jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(xbc)),
           LAYER_TOL)


def test_ssd_chunked_with_initial_state_matches():
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    rng = np.random.RandomState(21)
    b, s, h, p, n = 2, 64, 4, 16, 8
    arrays = [rng.randn(b, s, h, p), np.abs(rng.randn(b, s, h)) * 0.3 + 0.01,
              -np.arange(1, h + 1, dtype=np.float64), rng.randn(b, s, n),
              rng.randn(b, s, n), rng.randn(b, h, n, p)]
    arrays = [a.astype(np.float32) for a in arrays]
    y, final = ssm.ssd_chunked(*map(torch.as_tensor, arrays[:5]), 16,
                               h0=torch.as_tensor(arrays[5]))
    y_ref, final_ref = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays[:5]), 16,
                                           h0=jnp.asarray(arrays[5]))
    _scaled_close(y, y_ref, 1e-5)
    _scaled_close(final, final_ref, 1e-5)


@pytest.mark.parametrize("seq", [32, 64])
def test_ssm_forward_matches(seq):
    """One Mamba2 block of reduced Zamba2 (d_model 256, 32 heads of 16,
    d_state 16, chunk 32) with the JAX init's weights, over one and two
    chunks; the final state too."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    arch, jarch = _ssm_arch()
    jparams = jax.tree.map(np.asarray,
                           jax_ssm.ssm_init(jax.random.key(3), jarch))
    params = {k: torch.as_tensor(v.copy()) for k, v in jparams.items()
              if k != "norm"}
    params["norm"] = {"scale": torch.as_tensor(jparams["norm"]["scale"].copy())}
    x = np.random.RandomState(22).randn(2, seq, 256).astype(np.float32)
    out, final = ssm.ssm_forward(params, arch, torch.as_tensor(x))
    jout, jfinal = jax_ssm.ssm_forward(
        jax.tree.map(jnp.asarray, jparams), jarch, jnp.asarray(x))
    _close(out, jout, ATTN_TOL)
    _scaled_close(final, jfinal, 1e-5)


def test_ssm_init_matches_reference_shapes_and_constants():
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm
    arch, jarch = _ssm_arch()
    ours = ssm.ssm_init(torch.Generator().manual_seed(0), arch, device="cpu")
    ref = jax_ssm.ssm_init(jax.random.key(0), jarch)
    for name in ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
                 "out_proj"):
        assert tuple(ours[name].shape) == ref[name].shape, name
        assert ours[name].dtype == torch.float32, name
    np.testing.assert_allclose(ours["A_log"].numpy(),
                               np.asarray(ref["A_log"]), rtol=1e-6)
    dt = torch.nn.functional.softplus(ours["dt_bias"])
    assert bool(((dt > 1e-3 - 1e-7) & (dt < 1e-1 + 1e-7)).all())
    for name in ("in_proj", "conv_w", "out_proj"):
        assert ours[name].std().item() == pytest.approx(
            float(np.asarray(ref[name]).std()), rel=0.15), name
