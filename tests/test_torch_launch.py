"""repro_torch.launch.steps.make_prefill_step and the token models under it
(``transformer.forward_features`` for the ``ssm`` and ``hybrid`` families)
against the JAX package: reduced Zamba2 (a shared attention block after
every Mamba2 layer), a Zamba2 with a tail (groups of 2 and one tail layer),
reduced Mamba2, and Mamba2 with a padded vocabulary.  Weights come from the
JAX init through ``transformer.params_from_jax``; tokens from numpy.  At
s = 64 the reduced configs' 32-token chunks run twice, so the state carried
between chunks is exercised."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import transformer

FEATURE_TOL = 1e-4     # f32, one to three blocks; observed ~4e-6
LOGIT_TOL = 1e-4       # atol and rtol; logits reach ~50-160, observed ~5e-5
CASES = {
    "zamba2": ("zamba2-1.2b", {}),
    "zamba2_tail": ("zamba2-1.2b", dict(num_layers=3, hybrid_attn_every=2)),
    "mamba2": ("mamba2-780m", {}),
    "mamba2_padded_vocab": ("mamba2-780m", dict(vocab_size=500)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(port cfg, JAX cfg, JAX params, port params, tokens, JAX step output,
    JAX features), computed once per case."""
    arch, updates = CASES[name]
    cfg = dataclasses.replace(configs.reduced(configs.get_arch(arch)),
                              **updates)
    jcfg = dataclasses.replace(
        jax_configs.reduced(jax_configs.get_arch(arch)), **updates)
    jparams = jax.jit(jax_tf.init, static_argnums=1)(jax.random.key(0), jcfg)
    params = transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    jout = jax.jit(jax_steps.make_prefill_step(jcfg))(jparams, batch)
    jfeats, _ = jax.jit(lambda p, b: jax_tf.forward_features(
        p, jcfg, b, remat="none"))(jparams, batch)
    return cfg, jcfg, jparams, params, tokens, jout, jfeats


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_features_matches(name):
    cfg, _, _, params, tokens, _, jfeats = _case(name)
    feats, aux = transformer.forward_features(params, cfg,
                                              {"tokens": tokens})
    assert aux == {}
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=FEATURE_TOL, rtol=FEATURE_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_step_matches(name):
    """Equal greedy actions at every position and last-position logits
    within LOGIT_TOL, vocab padding masked in both."""
    cfg, _, _, params, tokens, jout, _ = _case(name)
    out = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.as_tensor(tokens)})
    assert out["actions"].dtype == torch.int32
    assert out["actions"].shape == tokens.shape
    assert out["last_logits"].shape == (2, cfg.padded_vocab_size)
    np.testing.assert_array_equal(out["actions"].numpy(),
                                  np.asarray(jout["actions"]))
    np.testing.assert_allclose(out["last_logits"].numpy(),
                               np.asarray(jout["last_logits"]),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_padded_vocab_is_masked():
    cfg, _, _, params, tokens, _, _ = _case("mamba2_padded_vocab")
    assert cfg.padded_vocab_size == 512 > cfg.vocab_size == 500
    out = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert bool((out["last_logits"][:, 500:] == -1e30).all())
    assert int(out["actions"].max()) < 500


def test_prefill_step_chunks_give_the_same_actions():
    """The argmax runs over chunks of positions; any chunk that divides s
    gives the same actions, and one that does not falls back to one chunk."""
    cfg, _, _, params, tokens, _, _ = _case("zamba2")
    whole = steps.make_prefill_step(cfg)(params, {"tokens": tokens})
    for chunk in (16, 48):
        out = steps.make_prefill_step(cfg, chunk=chunk)(params,
                                                        {"tokens": tokens})
        assert torch.equal(out["actions"], whole["actions"])
        assert torch.equal(out["last_logits"], whole["last_logits"])


def test_params_from_jax_groups_blocks_and_tail():
    cfg, _, jparams, params, _, _, _ = _case("zamba2_tail")
    assert len(params["blocks"]) == 1 and len(params["blocks"][0]) == 2
    assert len(params["tail_blocks"]) == 1
    np.testing.assert_array_equal(
        params["blocks"][0][1]["ssm"]["in_proj"].numpy(),
        np.asarray(jparams["blocks"]["ssm"]["in_proj"][0, 1]))
    np.testing.assert_array_equal(
        params["tail_blocks"][0]["ssm"]["out_proj"].numpy(),
        np.asarray(jparams["tail_blocks"]["ssm"]["out_proj"][0]))
    np.testing.assert_array_equal(
        params["shared_attn"]["attn"]["wq"].numpy(),
        np.asarray(jparams["shared_attn"]["attn"]["wq"]))
    np.testing.assert_array_equal(params["lm_head"]["table"].numpy(),
                                  np.asarray(jparams["lm_head"]["table"]))


@pytest.mark.parametrize("name", ["zamba2_tail", "mamba2"])
def test_init_layout_matches_carried_params(name):
    """The port's own init gives the layout, shapes and dtypes that
    ``params_from_jax`` gives from the JAX init; a fixed seed repeats."""
    from repro_torch import tree
    cfg, _, _, carried, _, _, _ = _case(name)
    ours = transformer.init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ours_flat, carried_flat = tree.leaves(ours), tree.leaves(carried)
    assert len(ours_flat) == len(carried_flat)
    for a, b in zip(ours_flat, carried_flat):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = transformer.init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(again),
                                                 ours_flat))


def test_unknown_arch_type_raises():
    """An arch_type outside the six families raises ValueError, as the JAX
    package's ``init`` and ``forward_features`` do."""
    cfg = dataclasses.replace(configs.reduced(configs.get_arch("qwen3-1.7b")),
                              arch_type="rnn")
    with pytest.raises(ValueError, match="rnn"):
        transformer.init(torch.Generator(), cfg, device="cpu")
    params = transformer.init(
        torch.Generator().manual_seed(0),
        configs.reduced(configs.get_arch("qwen3-1.7b")), device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="rnn"):
        transformer.forward_features(params, cfg, {"tokens": tokens})
    with pytest.raises(ValueError, match="rnn"):
        steps.make_prefill_step(cfg)(params, {"tokens": tokens})
