"""Token-by-token decode of every model-zoo family in repro_torch against
the JAX package, on ``configs.reduced`` of one arch per family (and a
Zamba2-shaped hybrid with tail layers, and a dense model whose
sliding-window ring wraps): ``ssm.init_ssm_cache``/``ssm_step``,
``transformer.init_cache`` (both layouts), ``decode_step`` and ``prefill``
through ``launch.steps.make_serve_step``/``make_batched_prefill_step``,
``attention.decode_attention(cross_kv=)``, MoE at decode, Whisper's
decode-time positional term, per-row positions, and the JAX package's own
gaps between decode and its forward pass.  Weights come from the JAX init
through ``transformer.params_from_jax``; tokens from numpy.

Tolerances: logits within LOGIT_TOL of the reference's largest |logit|
with equal greedy tokens; cache leaves within CACHE_TOL of each leaf's
largest magnitude (zeros exactly).  Observed below 1e-6 in float32."""
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
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps
from repro_torch.models import attention, moe, ssm, transformer

LOGIT_TOL = 1e-5       # of the largest |logit|
CACHE_TOL = 1e-5       # of each cache leaf's largest magnitude
STEP_TOL = 1e-5        # one ssm_step or attention call, outputs of ~1
B, PROMPT, DECODE = 2, 8, 8
MAX_LEN = PROMPT + DECODE
# one reduced arch per family, a Zamba2-shaped hybrid (2 groups of 3 and
# 2 tail layers, as 38 = 6 x 6 + 2), and a dense ring of 4 that wraps
CASES = {
    "dense": ("qwen3-1.7b", {}),
    "moe": ("granite-moe-3b-a800m", {}),
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "vlm": ("internvl2-26b", {}),
    "audio": ("whisper-base", {}),
    "hybrid_tail": ("zamba2-1.2b", {"num_layers": 8, "hybrid_attn_every": 3}),
    "dense_window": ("qwen3-1.7b", {"sliding_window": 4}),
}
FAMILIES = ["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


def _configs(case):
    arch, updates = CASES[case]
    return (dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                                **updates),
            dataclasses.replace(jax_configs.reduced(
                jax_configs.get_arch(arch)), **updates))


@functools.lru_cache(maxsize=None)
def _params(case):
    cfg, jcfg = _configs(case)
    jparams = jax.jit(jax_tf.init, static_argnums=1)(jax.random.key(0), jcfg)
    jparams = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, jparams, transformer.params_from_jax(cfg, jparams,
                                                           device="cpu")


def _batched(cfg):
    return cfg.arch_type in ("dense", "moe") and not cfg.sliding_window


def _prompts(cfg, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX package's serving run: the prompt through
    ``make_batched_prefill_step`` (dense, MoE) or one ``make_serve_step``
    a token, then DECODE greedy steps.  Returns the greedy tokens, the
    logits of every step and the final cache, as numpy."""
    cfg, jcfg, jparams, _ = _params(case)
    prompts = _prompts(cfg)
    cache = jax_tf.init_cache(jcfg, B, MAX_LEN, jnp.float32)
    serve = jax.jit(jax_steps.make_serve_step(jcfg))
    if _batched(cfg):
        tok, logits, cache = jax.jit(jax_steps.make_batched_prefill_step(
            jcfg))(jparams, cache, jnp.asarray(prompts))
    else:
        for t in range(PROMPT):
            tok, logits, cache = serve(jparams, cache,
                                       jnp.asarray(prompts[:, t:t + 1]),
                                       jnp.int32(t))
    tokens, all_logits = [np.array(tok)], [np.asarray(logits)]
    for i in range(DECODE):
        tok, logits, cache = serve(jparams, cache, tok, jnp.int32(PROMPT + i))
        tokens.append(np.array(tok))
        all_logits.append(np.asarray(logits))
    return tokens, all_logits, jax.tree.map(np.asarray, cache)


def _leaves(tree, prefix=""):
    """(path, leaf) over nested dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, node in enumerate(tree):
            yield from _leaves(node, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _assert_caches_close(cache, jcache, rows=None):
    """Same leaf paths, shapes and dtypes; values within CACHE_TOL of each
    leaf's largest magnitude (a leaf of zeros exactly)."""
    ours, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(ours) == sorted(theirs)
    for path, expected in theirs.items():
        got = ours[path]
        assert tuple(got.shape) == expected.shape, path
        assert _dtype_name(got.dtype) == str(expected.dtype), path
        got = got.float().numpy()
        expected = expected.astype(np.float32)
        if rows is not None:
            got, expected = rows(path, got), rows(path, expected)
        np.testing.assert_allclose(
            got, expected, rtol=0,
            atol=CACHE_TOL * np.abs(expected).max(), err_msg=path)


def _assert_logits_close(logits, expected, what):
    logits = logits.numpy()
    scale = np.abs(expected).max()
    assert np.abs(logits - expected).max() <= LOGIT_TOL * scale, what
    np.testing.assert_array_equal(logits.argmax(-1), expected.argmax(-1),
                                  err_msg=what)


# ------------------------------------------------------------------ SSM
def test_ssm_step_matches_and_chains_to_ssm_forward():
    """20 tokens through ``ssm_step`` against the JAX package's step
    (outputs and the cache after every token), and the chain against
    ``ssm_forward`` over the same 20 tokens: outputs and the final state."""
    cfg, jcfg, jparams, params = _params("ssm")
    bp, jbp = params["blocks"][0]["ssm"], jax.tree.map(
        lambda t: t[0], jparams["blocks"])["ssm"]
    rng = np.random.RandomState(3)
    x = rng.randn(B, 20, cfg.d_model).astype(np.float32)
    cache = ssm.init_ssm_cache(cfg, B, device="cpu")
    jcache = jax_ssm.init_ssm_cache(jcfg, B)
    jstep = jax.jit(lambda c, xt: jax_ssm.ssm_step(jbp, jcfg, xt, c))
    outs = []
    for t in range(20):
        xt = x[:, t:t + 1]
        y, returned = ssm.ssm_step(bp, cfg, torch.as_tensor(xt), cache)
        assert returned is cache
        jy, jcache = jstep(jcache, jnp.asarray(xt))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        _assert_caches_close(cache, jax.tree.map(np.asarray, jcache))
        outs.append(y)
    full, final = ssm.ssm_forward(bp, cfg, torch.as_tensor(x))
    torch.testing.assert_close(torch.cat(outs, dim=1), full,
                               atol=STEP_TOL, rtol=STEP_TOL)
    torch.testing.assert_close(cache["state"], final,
                               atol=STEP_TOL, rtol=STEP_TOL)


def test_ssm_cache_keeps_its_dtype():
    """A bfloat16 cache takes the float32 state update in its own dtype."""
    cfg, _, _, params = _params("ssm")
    cache = ssm.init_ssm_cache(cfg, B, dtype=torch.bfloat16, device="cpu")
    x = torch.as_tensor(np.random.RandomState(4).randn(B, 1, cfg.d_model),
                        dtype=torch.float32)
    y, _ = ssm.ssm_step(params["blocks"][0]["ssm"], cfg, x, cache)
    assert y.dtype == torch.float32
    assert cache["state"].dtype == cache["conv"].dtype == torch.bfloat16
    assert bool(cache["state"].abs().sum() > 0)


# ---------------------------------------------------------------- caches
@pytest.mark.parametrize("case", FAMILIES + ["hybrid_tail", "dense_window"])
@pytest.mark.parametrize("layout", ["stacked", "list"])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_init_cache_layout_matches(case, layout, dtype):
    """Leaf names, shapes and dtypes equal the JAX package's, for the
    default (bfloat16) and float32 KV caches, in both layouts (``list``
    applies to the dense family only, as there)."""
    cfg, jcfg = _configs(case)
    kwargs = {} if dtype is None else {"dtype": getattr(torch, dtype)}
    jkwargs = {} if dtype is None else {"dtype": getattr(jnp, dtype)}
    cache = transformer.init_cache(cfg, 3, 24, device="cpu", layout=layout,
                                   **kwargs)
    jcache = jax_tf.init_cache(jcfg, 3, 24, layout=layout, **jkwargs)
    ours, theirs = dict(_leaves(cache)), dict(_leaves(jcache))
    assert sorted(ours) == sorted(theirs)
    for path, expected in theirs.items():
        assert tuple(ours[path].shape) == expected.shape, path
        assert _dtype_name(ours[path].dtype) == str(expected.dtype), path
        assert not bool(ours[path].any()), path


def test_hybrid_sites_have_their_own_caches():
    """The shared-attention sites share the block's params, not a cache:
    each group writes its own ``attn_kv`` row, and the tail its own SSM
    rows."""
    cfg, _, _, params = _params("hybrid_tail")
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    transformer.decode_step(params, cfg, cache, _prompts(cfg)[:, :1], 0)
    k = cache["attn_kv"]["k"]
    assert k.shape[0] == 2 and bool(k[:, :, 0].abs().amin(-1).amin(-1).gt(0)
                                    .any())
    assert not torch.equal(k[0], k[1])
    assert bool(cache["tail_ssm"]["state"].abs().sum(dim=(1, 2, 3, 4))
                .gt(0).all())
    assert bool(cache["ssm"]["state"].abs().sum(dim=(2, 3, 4, 5))
                .gt(0).all())


# ---------------------------------------------------------------- decode
def _serve(case, backend, layout="stacked"):
    """The port's serving run on the reference's tokens (teacher-forced):
    every step's logits against the reference's, then the final cache."""
    cfg, _, _, params = _params(case)
    tokens, expected, jcache = _reference(case)
    prompts = _prompts(cfg)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu",
                                   layout=layout)
    serve = steps.make_serve_step(cfg, backend=backend)
    if _batched(cfg) and layout == "stacked":
        tok, logits, returned = steps.make_batched_prefill_step(cfg)(
            params, cache, prompts)
    else:
        for t in range(PROMPT):
            tok, logits, returned = serve(params, cache, prompts[:, t:t + 1],
                                          t)
    assert returned is cache
    assert tok.dtype == torch.int32 and tok.shape == (B, 1)
    _assert_logits_close(logits, expected[0], f"{case}: prompt")
    for i in range(DECODE):
        tok, logits, _ = serve(params, cache, tokens[i], PROMPT + i)
        _assert_logits_close(logits, expected[i + 1], f"{case}: step {i}")
        np.testing.assert_array_equal(tok.numpy(), tokens[i + 1])
    return cache, jcache


@pytest.mark.parametrize("backend", ["auto", "grouped"])
@pytest.mark.parametrize("case", FAMILIES + ["hybrid_tail", "dense_window"])
def test_decode_after_prompt_matches(case, backend):
    """A prompt of 8 and 8 decoded tokens: logits of every step within
    LOGIT_TOL of the largest, equal greedy tokens, and every cache leaf
    (the hybrid's grouped SSM rows and tail included; the ring wrapped
    four times) within CACHE_TOL.  ``"auto"`` is the plain version of the
    decode kernel on the CPU; ``"grouped"`` the JAX package's ``"jnp"``."""
    cache, jcache = _serve(case, backend)
    _assert_caches_close(cache, jcache)


@pytest.mark.parametrize("backend", ["auto", "grouped"])
def test_decode_list_layout_matches(backend):
    """The unrolled ``kv_list`` layout steps the same function."""
    cache, jcache = _serve("dense", backend, layout="list")
    assert len(cache["kv_list"]) == _params("dense")[0].num_layers
    stacked = {"kv": {name: torch.stack([c[name] for c in cache["kv_list"]])
                      for name in ("k", "v")}}
    _assert_caches_close(stacked, jcache)


@pytest.mark.parametrize("backend", ["auto", "grouped"])
@pytest.mark.parametrize("case", ["dense", "moe"])
def test_decode_per_row_positions_match(case, backend):
    """Rows at different depths in one dispatch: (b,) positions, each row
    writing its own slot."""
    cfg, jcfg, jparams, params = _params(case)
    prompts = _prompts(cfg)
    offsets = np.asarray([0, 3], np.int32)
    cache = transformer.init_cache(cfg, B, MAX_LEN + 4, torch.float32, "cpu")
    jcache = jax_tf.init_cache(jcfg, B, MAX_LEN + 4, jnp.float32)
    step = jax.jit(lambda p, c, t, pos: jax_tf.decode_step(p, jcfg, c, t,
                                                           pos))
    for t in range(PROMPT):
        pos = offsets + t
        jlogits, jcache = step(jparams, jcache, jnp.asarray(prompts[:, t:t + 1]),
                               jnp.asarray(pos))
        logits, _ = transformer.decode_step(params, cfg, cache,
                                            prompts[:, t:t + 1],
                                            torch.as_tensor(pos),
                                            backend=backend)
        _assert_logits_close(logits, np.asarray(jlogits), f"{case}: {t}")
    _assert_caches_close(cache, jax.tree.map(np.asarray, jcache))


def test_audio_decode_refuses_per_row_positions():
    cfg, _, _, params = _params("audio")
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    with pytest.raises(ValueError, match="scalar pos"):
        transformer.decode_step(params, cfg, cache, _prompts(cfg)[:, :1],
                                torch.tensor([0, 1]))


@pytest.mark.parametrize("pos", [0, 7, 447])
def test_audio_positional_term_matches(pos):
    """Whisper's decode-time sinusoid at a position, as the JAX package's
    ``decode_step`` writes it (the angle by division by the power, inside
    its jit with ``pos`` traced): within an ulp of the angle's sine, which
    XLA's float32 sine leaves in its last bits."""
    d_model = 512

    @jax.jit
    def reference(pos):
        dim = jnp.arange(0, d_model, 2, dtype=jnp.float32)
        angle = pos.astype(jnp.float32) / jnp.power(10000.0, dim / d_model)
        pe = jnp.zeros((d_model,), jnp.float32)
        return pe.at[0::2].set(jnp.sin(angle)).at[1::2].set(jnp.cos(angle))

    expected = np.asarray(reference(jnp.int32(pos)))
    got = transformer.decode_positional(torch.tensor(pos), d_model, "cpu")
    assert got.dtype == torch.float32 and got.shape == (d_model,)
    # an ulp of the largest angle (pos) carried through sin, and one of 1
    tol = np.spacing(np.float32(max(pos, 1))) + 2.0 ** -23
    assert np.abs(got.numpy() - expected).max() <= tol


def test_audio_decode_attends_over_zero_cross_kv():
    """``init_cache``'s cross K/V stay zeros through decode, as in the JAX
    package (nothing fills them): the cross-attention output is the mean
    of zero V, so Whisper's decoder reads no encoder."""
    cfg, _, _, params = _params("audio")
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    transformer.decode_step(params, cfg, cache, _prompts(cfg)[:, :1], 0)
    assert not bool(cache["cross_k"].any()) and not bool(
        cache["cross_v"].any())


# -------------------------------------------------------- cross-attention
@pytest.mark.parametrize("backend", ["auto", "ref", "grouped"])
def test_decode_cross_attention_matches(backend):
    """``decode_attention(cross_kv=)`` over random encoder K/V: only q is
    projected (no RoPE), every encoder key attends, and the cache passes
    through untouched."""
    cfg, jcfg, jparams, params = _params("audio")
    bp = params["blocks"][0]["xattn"]
    jbp = jax.tree.map(lambda t: t[0], jparams["blocks"])["xattn"]
    rng = np.random.RandomState(5)
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    kv = [rng.randn(B, 40, cfg.num_kv_heads, cfg.head_dim).astype(np.float32)
          for _ in range(2)]
    sentinel = object()
    out, cache = attention.decode_attention(
        bp, cfg, torch.as_tensor(x), sentinel, 5,
        cross_kv=tuple(map(torch.as_tensor, kv)), backend=backend)
    assert cache is sentinel
    jout, _ = jax_attn.decode_attention(jbp, jcfg, jnp.asarray(x), None,
                                        jnp.int32(5),
                                        cross_kv=tuple(map(jnp.asarray, kv)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=STEP_TOL, rtol=STEP_TOL)


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("case", ["dense", "moe"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_then_decode_matches(case, ragged):
    """``prefill`` with and without ``lengths`` (right-padded rows), the
    logits at each row's last real token, cache slots below each row's
    length, then decode from per-row positions ``lengths``."""
    cfg, jcfg, jparams, params = _params(case)
    prompts = _prompts(cfg)
    lengths = np.asarray([PROMPT, 5], np.int32) if ragged else None
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    jcache = jax_tf.init_cache(jcfg, B, MAX_LEN, jnp.float32)
    logits, _ = transformer.prefill(params, cfg, cache, prompts,
                                    lengths=lengths)
    jlogits, jcache = jax.jit(lambda p, c, t, n: jax_tf.prefill(
        p, jcfg, c, t, lengths=n))(jparams, jcache, jnp.asarray(prompts),
                                   None if lengths is None
                                   else jnp.asarray(lengths))
    _assert_logits_close(logits, np.asarray(jlogits), f"{case}: prefill")
    real = np.full((B,), PROMPT) if lengths is None else lengths

    def below_lengths(path, leaf):       # (layers, b, slots, ...)
        return np.concatenate([leaf[:, i, :real[i]] for i in range(B)], 1)

    _assert_caches_close(cache, jax.tree.map(np.asarray, jcache),
                         rows=below_lengths)
    step = jax.jit(lambda p, c, t, pos: jax_tf.decode_step(p, jcfg, c, t,
                                                           pos))
    tok = np.asarray(jlogits).argmax(-1).astype(np.int32)[:, None]
    for i in range(3):
        pos = real + i
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(pos, jnp.int32))
        logits, _ = transformer.decode_step(params, cfg, cache, tok,
                                            torch.as_tensor(pos),
                                            backend="auto")
        _assert_logits_close(logits, np.asarray(jlogits), f"{case}: {i}")
        tok = np.asarray(jlogits).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("case", ["ssm", "hybrid", "vlm", "audio"])
def test_prefill_refuses_other_families(case):
    cfg, _, _, params = _params(case)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    with pytest.raises(ValueError, match="prefill_embedded supports"):
        transformer.prefill(params, cfg, cache, _prompts(cfg))


def test_prefill_refuses_the_list_layout():
    cfg, _, _, params = _params("dense")
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu",
                                   layout="list")
    with pytest.raises(ValueError, match="stacked"):
        transformer.prefill(params, cfg, cache, _prompts(cfg))


# --------------------------------------------------------- the card route
class _Counted:
    """A kernel wrapper's stand-in on the CPU: its plain version, counted."""

    def __init__(self, fn):
        self.fn, self.launches = fn, 0

    def __call__(self, *args):
        self.launches += 1
        return self.fn(*args)


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors routed as the card routes them (``ops._on_card`` true,
    ``"auto"`` decode picking the kernel), each kernel replaced by its
    counted plain version."""
    flash = _Counted(lambda q, k, v, causal, window: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window))
    decode = _Counted(ref.decode_attention_ref)
    ssd = _Counted(lambda *args: pytest.fail("the SSD scan ran at decode"))
    backend = attention._decode_backend
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_flash", flash)
    monkeypatch.setattr(ops, "_decode", decode)
    monkeypatch.setattr(ops, "_ssd", ssd)
    monkeypatch.setattr(attention, "_decode_backend", lambda name, device: (
        "kernel" if name == "auto" else backend(name, device)))
    return flash, decode


# decode launches a step and flash launches a batched prefill, per family
LAUNCHES = {"dense": (2, 2), "moe": (2, 2), "ssm": (0, 0), "hybrid": (2, 0),
            "vlm": (2, 0), "audio": (4, 0), "hybrid_tail": (2, 0),
            "dense_window": (2, 0)}


@pytest.mark.parametrize("case", FAMILIES + ["hybrid_tail"])
def test_card_route_launch_counts_and_logits(card_route, case):
    """On the card's route the serving run gives the reference's logits
    (flash over the prompt's own K/V at prefill, the decode kernel's plain
    version at every step) and launches each kernel as
    phase 24 holds it: the decode kernel once a layer a step (the hybrid's
    sites, Whisper's self- and cross-attention), flash once a layer a
    batched prefill."""
    flash, decode = card_route
    per_step, per_prefill = LAUNCHES[case]
    _serve(case, "auto")
    steps_run = DECODE + (0 if _batched(_params(case)[0]) else PROMPT)
    assert flash.launches == per_prefill
    assert decode.launches == per_step * steps_run


def test_card_route_prefill_ragged_rows_below_lengths(card_route,
                                                     monkeypatch):
    """Flash without the ``lengths`` mask changes only rows at or past a
    row's length: the logits at the last real tokens and the cache slots
    below the lengths equal the masked softmax's."""
    cfg, _, _, params = _params("dense")
    prompts, lengths = _prompts(cfg), np.asarray([PROMPT, 3], np.int32)
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    logits, _ = transformer.prefill(params, cfg, cache, prompts,
                                    lengths=lengths)
    flash, _ = card_route
    assert flash.launches == cfg.num_layers
    masked = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, "cpu")
    with monkeypatch.context() as cpu_route:
        cpu_route.setattr(ops, "_on_card", lambda t: False)
        expected, _ = transformer.prefill(params, cfg, masked, prompts,
                                          lengths=lengths)
    assert flash.launches == cfg.num_layers
    torch.testing.assert_close(logits, expected, atol=1e-5, rtol=1e-5)
    for i in range(B):
        torch.testing.assert_close(cache["kv"]["k"][:, i, :lengths[i]],
                                   masked["kv"]["k"][:, i, :lengths[i]],
                                   atol=1e-5, rtol=1e-5)


def test_policy_window_prefill_runs_flash_below_lengths(card_route):
    """The policy network's window prefill (acting) on the card's route
    launches flash once a layer, and at every position below a row's
    length its Q-values and cache slots equal the JAX package's
    ``q_prefill`` (the masked softmax) on the same weights (1e-5)."""
    from repro.policies import TransformerPolicyConfig as JaxConfig
    from repro.policies import network as jax_network
    from repro_torch.policies import TransformerPolicyConfig, network
    flash, _ = card_route
    kw = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
              head_dim=16, d_ff=64, window=4)
    arch = network.make_arch(TransformerPolicyConfig(**kw), num_actions=3)
    jarch = jax_network.make_arch(JaxConfig(**kw), num_actions=3)
    jparams = jax_network.init(jax.random.key(0), jarch, 5, 3)
    params = network.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    lengths = np.asarray([4, 2], np.int32)
    obs = np.random.RandomState(6).randn(B, 4, 5).astype(np.float32)
    obs *= np.arange(4)[None, :, None] < lengths[:, None, None]
    cache = network.init_cache(arch, B, device="cpu")
    q, cache = network.q_prefill(params, arch, cache, torch.as_tensor(obs),
                                 torch.as_tensor(lengths))
    assert q.shape == (B, 4, 3) and flash.launches == arch.num_layers
    jq, jcache = jax_network.q_prefill(
        jparams, jarch, jax_network.init_cache(jarch, B), jnp.asarray(obs),
        jnp.asarray(lengths))
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(q[i, :n].numpy(), np.asarray(jq)[i, :n],
                                   atol=1e-5, rtol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache["kv"][name][:, i, :n].numpy(),
                np.asarray(jcache["kv"][name])[:, i, :n], atol=1e-5,
                rtol=1e-5)


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("b", [1, 8])
def test_moe_decode_matches_and_drops_nothing(b):
    """At decode an MoE layer sees one token a row: groups of one token,
    capacity ``top_k`` (``max(ceil(k cf / e), k)``), so no assignment is
    dropped and each row's output is the gate-weighted sum of its top-k
    experts.  The port's ``moe_ffn`` equals the JAX package's and that
    sum; ``decode_step`` at b rows equals the JAX package's."""
    cfg, jcfg, jparams, params = _params("moe")
    bp = params["blocks"][0]["moe"]
    jbp = jax.tree.map(lambda t: t[0], jparams["blocks"])["moe"]
    x = np.random.RandomState(7).randn(b, 1, cfg.d_model).astype(np.float32)
    y, _ = moe.moe_ffn(bp, cfg, torch.as_tensor(x))
    jy, _ = jax_moe.moe_ffn(jbp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=STEP_TOL,
                               rtol=STEP_TOL)
    xt = torch.as_tensor(x)[:, 0]
    _, _, top_vals, top_idx = moe.route(bp, cfg, xt[None])
    gates = (top_vals / top_vals.sum(-1, keepdim=True))[0]
    bank = bp["experts"]
    dense = torch.zeros_like(xt)
    for r in range(b):
        for slot in range(cfg.moe.top_k):
            e = int(top_idx[0, r, slot])
            h = torch.nn.functional.silu(xt[r] @ bank["w_gate"][e]) * (
                xt[r] @ bank["w_up"][e])
            dense[r] += gates[r, slot] * (h @ bank["w_down"][e])
    if cfg.moe.num_shared:
        dense = dense + transformer.layers.mlp(bp["shared"], xt)
    torch.testing.assert_close(y[:, 0], dense, atol=STEP_TOL, rtol=STEP_TOL)

    tokens = np.random.RandomState(8).randint(0, cfg.vocab_size, (b, 1))
    cache = transformer.init_cache(cfg, b, 4, torch.float32, "cpu")
    jcache = jax_tf.init_cache(jcfg, b, 4, jnp.float32)
    logits, _ = transformer.decode_step(params, cfg, cache, tokens, 0)
    jlogits, _ = jax_tf.decode_step(jparams, jcfg, jcache,
                                    jnp.asarray(tokens), jnp.int32(0))
    _assert_logits_close(logits, np.asarray(jlogits), f"moe b={b}")


# ------------------------------------------- the reference's decode gaps
# |decode logits - forward logits| / max |forward logit| after 8 prompt
# tokens stepped through make_serve_step, 2 rows (the JAX package): exact
# or rounding for every family but two, whose gaps come from the reference
# itself — MoE drops tokens in the forward pass's groups and none at
# decode, and Whisper's decode cross-attends over zero K/V.
GAP_BOUNDS = {"dense": (0.0, 1e-6), "vlm": (0.0, 1e-6), "ssm": (0.0, 1e-5),
              "hybrid": (0.0, 1e-5), "moe": (1e-2, 1.0), "audio": (1e-1, 1.0)}


@pytest.mark.parametrize("case", FAMILIES)
def test_decode_vs_forward_gap_is_the_references(case):
    """The JAX package's own gap between decode and its forward pass lies
    in the documented range, and the port's gap is the same."""
    cfg, jcfg, jparams, params = _params(case)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.arch_type == "vlm":          # text only, as decode serves it
        batch["vision"] = np.zeros((B, 0, cfg.d_model), np.float32)
    if cfg.arch_type == "audio":
        batch["frames"] = (0.1 * rng.randn(B, cfg.encoder_seq, cfg.d_model)
                           ).astype(np.float32)
    jforward, _ = jax_tf.forward(jparams, jcfg,
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 remat="none")
    forward, _ = transformer.forward(params, cfg, batch)
    jforward, forward = np.asarray(jforward)[:, -1], forward[:, -1].numpy()

    jcache = jax_tf.init_cache(jcfg, B, PROMPT, jnp.float32)
    cache = transformer.init_cache(cfg, B, PROMPT, torch.float32, "cpu")
    serve = jax.jit(jax_steps.make_serve_step(jcfg))
    port_serve = steps.make_serve_step(cfg)
    for t in range(PROMPT):
        _, jlogits, jcache = serve(jparams, jcache,
                                   jnp.asarray(prompts[:, t:t + 1]),
                                   jnp.int32(t))
        _, logits, _ = port_serve(params, cache, prompts[:, t:t + 1], t)
    gap = np.abs(np.asarray(jlogits) - jforward).max() / np.abs(
        jforward).max()
    low, high = GAP_BOUNDS[case]
    assert low <= gap <= high, gap
    port_gap = np.abs(logits.numpy() - forward).max() / np.abs(forward).max()
    assert abs(port_gap - gap) <= 1e-5, (port_gap, gap)
