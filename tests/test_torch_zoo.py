"""The model zoo's dense, MoE, VLM and audio families in repro_torch against
the JAX package, on ``configs.reduced`` of every arch of the four:
``transformer.forward_features`` and ``forward`` (features, logits and the
MoE losses), ``launch.steps.make_prefill_step``, ``moe.moe_ffn`` alone
(with capacity cut until assignments are dropped), cross-attention alone,
the VLM's vision prefix, ``layers.sinusoid_positions`` and ``init``'s
layout.  Weights come from the JAX init through
``transformer.params_from_jax``; tokens, vision and frames from numpy."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch import configs, tree
from repro_torch.launch import steps
from repro_torch.models import attention, layers, moe, transformer

FEATURE_TOL = 1e-4     # f32, two blocks; observed ~2e-6
LOGIT_TOL = 1e-4       # atol and rtol; observed ~5e-5 on logits of ~10-100
AUX_TOL = 1e-5         # moe_aux ~1e-2, moe_z ~1e-3
MOE_TOL = 1e-5         # moe_ffn alone, outputs of ~1
ATTN_TOL = 1e-5        # one attention call, outputs of ~1
ARCHS = ["qwen3-1.7b", "yi-6b", "deepseek-7b", "codeqwen1.5-7b",
         "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "internvl2-26b",
         "whisper-base"]
BATCH, TEXT = 2, 64


def _inputs(cfg, seed=1):
    """tokens (and vision or frames, 0.1 x normal, as the JAX package's
    smoke tests make them) from numpy."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (BATCH, TEXT)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["vision"] = (0.1 * rng.randn(BATCH, cfg.vision_tokens,
                                           cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = (0.1 * rng.randn(BATCH, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _case(arch):
    """(port cfg, JAX params, port params, inputs, JAX features, aux,
    logits and step output), computed once per arch."""
    cfg = configs.reduced(configs.get_arch(arch))
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    jparams = jax.jit(jax_tf.init, static_argnums=1)(jax.random.key(0), jcfg)
    params = transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    batch = _inputs(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jfeats, jaux = jax.jit(lambda p, b: jax_tf.forward_features(
        p, jcfg, b, remat="none"))(jparams, jbatch)
    jlogits, _ = jax.jit(lambda p, b: jax_tf.forward(
        p, jcfg, b, remat="none"))(jparams, jbatch)
    jout = jax.jit(jax_steps.make_prefill_step(jcfg))(jparams, jbatch)
    return (cfg, jparams, params, batch, np.asarray(jfeats),
            {k: float(v) for k, v in jaux.items()}, np.asarray(jlogits),
            jax.tree.map(np.asarray, jout))


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_features_matches(arch):
    cfg, _, params, batch, jfeats, jaux, _, _ = _case(arch)
    feats, aux = transformer.forward_features(params, cfg, batch)
    assert feats.shape == (BATCH, TEXT, cfg.d_model)
    _close(feats, jfeats, FEATURE_TOL)
    assert sorted(aux) == sorted(jaux)
    for name, value in jaux.items():
        assert aux[name].dtype == torch.float32
        assert abs(float(aux[name]) - value) <= AUX_TOL, (name, value)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch):
    """Logits over every text position, vocab padding masked, and the MoE
    losses summed over layers."""
    cfg, _, params, batch, _, jaux, jlogits, _ = _case(arch)
    logits, aux = transformer.forward(params, cfg, batch)
    assert logits.shape == (BATCH, TEXT, cfg.padded_vocab_size)
    _close(logits, jlogits, LOGIT_TOL)
    if cfg.arch_type == "moe":
        assert float(aux["moe_aux"]) > 0 and float(aux["moe_z"]) > 0
    for name, value in jaux.items():
        assert abs(float(aux[name]) - value) <= AUX_TOL, (name, value)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches(arch):
    """Equal greedy actions at every text position and last-position
    logits within LOGIT_TOL."""
    cfg, _, params, batch, _, _, _, jout = _case(arch)
    out = steps.make_prefill_step(cfg)(params, batch)
    assert out["actions"].dtype == torch.int32
    assert out["actions"].shape == (BATCH, TEXT)
    assert out["last_logits"].shape == (BATCH, cfg.padded_vocab_size)
    np.testing.assert_array_equal(out["actions"].numpy(), jout["actions"])
    _close(out["last_logits"], jout["last_logits"], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_carried_params(arch):
    """The port's own init gives the tree, shapes and dtypes that
    ``params_from_jax`` gives from the JAX init (the MoE router float32
    at any dtype); a fixed seed repeats."""
    cfg, _, carried, _, _, _, _, _ = _case(arch)
    ours = transformer.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ours_leaves, ours_def = tree.flatten(ours)
    carried_leaves, carried_def = tree.flatten(carried)
    assert ours_def == carried_def
    for a, b in zip(ours_leaves, carried_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = transformer.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert all(torch.equal(a, b)
               for a, b in zip(tree.leaves(again), ours_leaves))
    if cfg.arch_type == "moe":
        half = transformer.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu", dtype=torch.bfloat16)
        moe_params = half["blocks"][0]["moe"]
        assert moe_params["router"].dtype == torch.float32
        assert moe_params["experts"]["w_up"].dtype == torch.bfloat16


def test_params_from_jax_unstacks_layers_and_keeps_the_expert_axis():
    cfg, jparams, params, _, _, _, _, _ = _case("qwen2-moe-a2.7b")
    assert len(params["blocks"]) == cfg.num_layers
    bank = params["blocks"][1]["moe"]["experts"]["w_down"]
    assert bank.shape == (cfg.moe.num_experts, cfg.moe.d_expert, cfg.d_model)
    np.testing.assert_array_equal(
        bank.numpy(), np.asarray(jparams["blocks"]["moe"]["experts"]
                                 ["w_down"][1]))
    cfg, jparams, params, _, _, _, _, _ = _case("whisper-base")
    assert len(params["enc_blocks"]) == cfg.encoder_layers
    np.testing.assert_array_equal(
        params["enc_blocks"][1]["attn"]["wq"].numpy(),
        np.asarray(jparams["enc_blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        params["blocks"][0]["xattn"]["wk"].numpy(),
        np.asarray(jparams["blocks"]["xattn"]["wk"][0]))
    np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                  np.asarray(jparams["enc_norm"]["scale"]))


def test_vlm_interleaves_vision_tokens():
    """The vision prefix is stripped after the final norm, and a change of
    the vision embeddings changes the text logits (cross-modal flow), as
    ``tests/test_models_smoke.py::test_vlm_interleaves_vision_tokens``
    holds the JAX package; both runs equal the JAX package's."""
    cfg, jparams, params, batch, _, _, jlogits, _ = _case("internvl2-26b")
    logits, _ = transformer.forward(params, cfg, batch)
    assert logits.shape[1] == TEXT
    shifted = dict(batch, vision=batch["vision"] + 1.0)
    logits2, _ = transformer.forward(params, cfg, shifted)
    assert float((logits - logits2).abs().max()) > 1e-4
    jcfg = jax_configs.reduced(jax_configs.get_arch("internvl2-26b"))
    jlogits2, _ = jax.jit(lambda p, b: jax_tf.forward(
        p, jcfg, b, remat="none"))(
        jparams, {k: jnp.asarray(v) for k, v in shifted.items()})
    _close(logits2, jlogits2, LOGIT_TOL)


# ================================================================ MoE alone
def _dropped_assignments(router, x, cfg):
    """Assignments past their expert's capacity, counted from the router's
    top-k choices in numpy (the count needs no priority order)."""
    m = cfg.moe
    g_tokens = min(m.group_size, x.shape[1])
    xg = x.reshape(-1, g_tokens, x.shape[-1]).astype(np.float64)
    logits = xg @ router.astype(np.float64)
    top = np.argsort(-logits, axis=-1)[..., :m.top_k]
    capacity = max(int(np.ceil(g_tokens * m.top_k * m.capacity_factor
                               / m.num_experts)), m.top_k)
    counts = np.stack([(top == e).sum(axis=(1, 2))
                       for e in range(m.num_experts)], axis=-1)
    return int(np.maximum(counts - capacity, 0).sum())


@pytest.mark.parametrize("arch,capacity_factor", [
    ("granite-moe-3b-a800m", 1.25), ("granite-moe-3b-a800m", 0.5),
    ("granite-moe-3b-a800m", 0.25), ("qwen2-moe-a2.7b", 0.5)])
def test_moe_ffn_matches_with_dropped_tokens(arch, capacity_factor):
    """``moe_ffn`` against the JAX package's, capacity cut until
    assignments are dropped: an assignment dropped on one side and kept on
    the other moves its token's output by its gate times its expert's
    output (~0.1-1), so equal outputs mean the same rank-major drops."""
    def cut(c):
        return dataclasses.replace(
            c, moe=dataclasses.replace(c.moe,
                                       capacity_factor=capacity_factor))
    cfg = cut(configs.reduced(configs.get_arch(arch)))
    jcfg = cut(jax_configs.reduced(jax_configs.get_arch(arch)))
    jparams = jax.tree.map(np.asarray, jax.jit(
        jax_moe.moe_init, static_argnums=1)(jax.random.key(3), jcfg))
    params = jax.tree.map(torch.tensor, jparams)
    x = np.random.RandomState(4).randn(2, 128, cfg.d_model).astype(
        np.float32)
    y, losses = moe.moe_ffn(params, cfg, torch.as_tensor(x))
    jy, jlosses = jax.jit(jax_moe.moe_ffn, static_argnums=1)(
        jparams, jcfg, jnp.asarray(x))
    dropped = _dropped_assignments(jparams["router"], x, cfg)
    if capacity_factor < 1:
        assert dropped > 0
    _close(y, jy, MOE_TOL)
    for name in ("moe_aux", "moe_z"):
        assert abs(float(losses[name]) - float(jlosses[name])) <= AUX_TOL


def test_moe_router_stays_float32_under_bf16():
    """bf16 activations and experts, float32 router: the routing equals the
    float32 run's on the same (bf16-representable) inputs, and the output
    is bf16."""
    cfg = configs.reduced(configs.get_arch("granite-moe-3b-a800m"))
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu", dtype=torch.bfloat16)
    x = torch.as_tensor(np.random.RandomState(5).randn(2, 64, cfg.d_model),
                        dtype=torch.bfloat16)
    y, losses = moe.moe_ffn(params, cfg, x)
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    full = tree.map(lambda t: t.float(), params)
    _, losses32 = moe.moe_ffn(full, cfg, x.float())
    for name in ("moe_aux", "moe_z"):
        assert losses[name].dtype == torch.float32
        assert float(losses[name]) == float(losses32[name])


# ====================================================== attention pieces
def test_cross_attention_matches():
    """Whisper's cross-attention: q (projected without RoPE, qk-normed
    where the config says so) over given K/V with sq != sk, unmasked."""
    for qk_norm in (False, True):
        fields = dict(name="x", arch_type="audio", num_layers=1, d_model=32,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=64,
                      vocab_size=8, qk_norm=qk_norm, rope_theta=10000.0)
        cfg = configs.ArchConfig(**fields)
        jcfg = jax_configs.ArchConfig(**fields)
        rng = np.random.RandomState(6)
        p = {"wq": rng.randn(32, 4, 16), "wk": rng.randn(32, 2, 16),
             "wv": rng.randn(32, 2, 16), "wo": rng.randn(4, 16, 32),
             "q_norm": 1 + 0.1 * rng.randn(16),
             "k_norm": 1 + 0.1 * rng.randn(16)}
        p = {k: (0.2 * v if k.startswith("w") else v).astype(np.float32)
             for k, v in p.items()}
        x = rng.randn(2, 24, 32).astype(np.float32)
        k = rng.randn(2, 40, 2, 16).astype(np.float32)
        v = rng.randn(2, 40, 2, 16).astype(np.float32)
        out = attention.attention(
            {n: torch.as_tensor(a) for n, a in p.items()}, cfg,
            torch.as_tensor(x), torch.arange(24), causal=False,
            kv=(torch.as_tensor(k), torch.as_tensor(v)))
        expected = jax_attn.attention(
            {n: jnp.asarray(a) for n, a in p.items()}, jcfg, jnp.asarray(x),
            jnp.arange(24), causal=False, kv=(jnp.asarray(k),
                                              jnp.asarray(v)))
        assert out.shape == (2, 24, 32)
        _close(out, expected, ATTN_TOL)


@pytest.mark.parametrize("seq,d_model", [(16, 256), (64, 256), (448, 512),
                                         (1500, 512)])
def test_sinusoid_positions_match(seq, d_model):
    """Within one float32 ulp of 1 (2^-24) of the JAX package's at the
    reduced and full Whisper shapes: the angles are the same float32
    numbers, but XLA's float32 sine and cosine differ from correctly
    rounded ones (taken here) in the last bit at ~1% of the entries, so
    bit equality is out of reach."""
    expected = np.asarray(jax.jit(jax_layers.sinusoid_positions,
                                  static_argnums=(0, 1))(seq, d_model))
    got = layers.sinusoid_positions(seq, d_model, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (seq, d_model)
    assert np.abs(got.numpy() - expected).max() <= 2.0 ** -24
