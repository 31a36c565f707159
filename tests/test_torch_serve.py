"""``repro_torch.launch.serve.BatchedServer`` against the JAX package's
``repro.launch.serve.BatchedServer`` on ``configs.reduced`` of one arch
per family: with the reference server's parameters put in through
``transformer.params_from_jax`` (its ``params`` and ``cache`` are public
attributes, as there), ``generate`` returns the reference's greedy tokens
on the same prompts, with batched prefill (dense, MoE) and token at a
time; the slot-recycling ``main`` runs on the CPU."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import serve as jax_serve
from repro_torch import configs, tree
from repro_torch.launch import serve, steps
from repro_torch.models import transformer

ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-780m", "zamba2-1.2b",
         "internvl2-26b", "whisper-base"]
SLOTS, PROMPT, DECODE = 3, 6, 10


def _servers(arch, batched_prefill=True):
    jcfg = jax_configs.reduced(jax_configs.get_arch(arch))
    cfg = configs.reduced(configs.get_arch(arch))
    reference = jax_serve.BatchedServer(jcfg, SLOTS, PROMPT + DECODE,
                                        batched_prefill=batched_prefill)
    port = serve.BatchedServer(cfg, SLOTS, PROMPT + DECODE, device="cpu",
                               batched_prefill=batched_prefill)
    port.params = transformer.params_from_jax(
        cfg, jax.tree.map(np.asarray, reference.params), device="cpu")
    return cfg, reference, port


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batched_prefill", [True, False])
def test_generate_matches_the_reference(arch, batched_prefill):
    """Two batches through one server, the cache recycled between them as
    ``main`` does: the same (slots, DECODE) int32 tokens as the JAX
    package's server."""
    cfg, reference, port = _servers(arch, batched_prefill)
    rng = np.random.RandomState(0)
    for _ in range(2):
        prompts = rng.randint(0, cfg.vocab_size,
                              (SLOTS, PROMPT)).astype(np.int32)
        expected = reference.generate(prompts, DECODE)
        got = port.generate(prompts, DECODE)
        assert got.dtype == np.int32 and got.shape == (SLOTS, DECODE)
        np.testing.assert_array_equal(got, expected)
        reference.cache = jax.tree.map(jnp.zeros_like, reference.cache)
        port.cache = transformer.init_cache(cfg, SLOTS, port.max_len,
                                            torch.float32, "cpu")


@pytest.mark.parametrize("window", [None, 16])
def test_batched_prefill_equals_token_at_a_time(window):
    """On a dense model one batched-prefill call and PROMPT serve steps
    leave the same first token and the same cache slots (fig17's tier 1
    times the two).  An MoE model's need not agree: its prefill groups the
    prompt's tokens and may drop some, its steps drop none."""
    cfg = dataclasses.replace(configs.reduced(configs.get_arch("qwen3-1.7b")),
                              sliding_window=window)
    batched = serve.BatchedServer(cfg, SLOTS, PROMPT + DECODE, device="cpu")
    replay = serve.BatchedServer(cfg, SLOTS, PROMPT + DECODE, device="cpu",
                                 batched_prefill=False)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(batched.params),
                                                 tree.leaves(replay.params)))
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (SLOTS, PROMPT)).astype(np.int32)
    torch.testing.assert_close(batched.prefill(prompts),
                               replay.prefill(prompts), atol=0, rtol=0)
    for name in ("k", "v"):
        torch.testing.assert_close(batched.cache["kv"][name][:, :, :PROMPT],
                                   replay.cache["kv"][name][:, :, :PROMPT],
                                   atol=1e-5, rtol=1e-5)


def test_server_draws_from_its_seed():
    """The same seed gives the same weights, another seed others."""
    cfg = configs.reduced(configs.get_arch("qwen3-1.7b"))
    a, b, c = (serve.BatchedServer(cfg, 2, 8, seed=seed, device="cpu")
               for seed in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a.params),
                                                 tree.leaves(b.params)))
    assert not all(torch.equal(x, y) for x, y in zip(tree.leaves(a.params),
                                                     tree.leaves(c.params)))
    assert a.cache["kv"]["k"].dtype == torch.float32


def test_steps_return_int32_tokens():
    cfg = configs.reduced(configs.get_arch("qwen3-1.7b"))
    server = serve.BatchedServer(cfg, 2, 8, device="cpu")
    prompts = np.zeros((2, 4), np.int32)
    tok, logits, cache = steps.make_batched_prefill_step(cfg)(
        server.params, server.cache, prompts)
    assert cache is server.cache
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    assert logits.shape == (2, cfg.padded_vocab_size)
    tok2, logits2, _ = steps.make_serve_step(cfg)(server.params, cache, tok, 4)
    assert tok2.dtype == torch.int32 and tok2.shape == (2, 1)
    assert int(tok2.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_main_serves_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--requests", "6", "--slots", "4",
                       "--prompt-len", "5", "--decode-len", "6",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 4/6" in out and "served 6/6" in out
    assert "total: 36 tokens" in out
