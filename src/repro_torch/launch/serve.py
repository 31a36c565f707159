"""Batched serving driver (the distributed *actor* at scale, SEED-RL style).

Serves a model of any family with batched requests through its KV/SSM
cache, on ``make_serve_step``.  Requests are queued; the server decodes
the whole batch in lockstep (continuous batching is approximated by slot
recycling: finished requests free their slot).  Dense and MoE models take
the prompt in one batched-prefill call; SSM, hybrid, VLM and audio caches
replay it one token at a time, as the JAX package's server does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 8 --device cpu

``main`` serves ``configs.reduced`` of the arch; ``BatchedServer`` takes
any config.  Its ``params``, ``cache`` and ``pos`` are public attributes,
as in the JAX package, so a caller can put other weights or a fresh cache
in.  Its weights are drawn from a ``torch.Generator`` on the server's
device seeded with ``seed``: the JAX package's threefry draws cannot be
reproduced, so the same seed gives other weights there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.launch.steps import make_batched_prefill_step, make_serve_step
from repro_torch.models import transformer


class BatchedServer:
    def __init__(self, cfg, batch_slots: int = 4, max_len: int = 128,
                 seed: int = 0, batched_prefill: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.device = torch.device(device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = transformer.init(generator, cfg, device=self.device,
                                       dtype=torch.float32)
        self.cache = transformer.init_cache(cfg, batch_slots, max_len,
                                            torch.float32, self.device)
        self._serve = make_serve_step(cfg)
        # Whole-prompt prefill in one call; dense and MoE archs only —
        # ssm/hybrid/vlm/audio caches replay the prompt token at a time.
        self._prefill = (make_batched_prefill_step(cfg)
                         if batched_prefill and
                         cfg.arch_type in ("dense", "moe") else None)
        self.pos = 0
        # positions as device scalars, so a step uploads nothing
        self._positions = torch.arange(max_len, dtype=torch.int32,
                                       device=self.device)

    def prefill(self, prompts: np.ndarray):
        """Run the prompt through the cache; returns the first greedy token
        (slots, 1) int32 on the server's device.  One call when the arch
        supports batched prefill, otherwise one ``serve_step`` per prompt
        token."""
        prompts = torch.as_tensor(np.asarray(prompts), device=self.device)
        if self._prefill is not None:
            tok, _, self.cache = self._prefill(self.params, self.cache,
                                               prompts)
            return tok
        tok = None
        for t in range(prompts.shape[1]):
            tok, _, self.cache = self._serve(self.params, self.cache,
                                             prompts[:, t:t + 1],
                                             self._positions[t])
        return tok

    def generate(self, prompts: np.ndarray, decode_len: int):
        """prompts: (slots, prompt_len) ints.  Lockstep batched decode;
        returns the (slots, decode_len) int32 greedy tokens as numpy."""
        prompt_len = np.shape(prompts)[1]
        tok = self.prefill(prompts)
        outs = [tok]
        for i in range(decode_len - 1):
            tok, _, self.cache = self._serve(self.params, self.cache, tok,
                                             self._positions[prompt_len + i])
            outs.append(tok)
        return torch.cat(outs, dim=1).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--decode-len", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = reduced(get_arch(args.arch))
    server = BatchedServer(cfg, args.slots,
                           args.prompt_len + args.decode_len,
                           device=args.device)
    rng = np.random.RandomState(0)
    done = 0
    t0 = time.time()
    while done < args.requests:
        n = min(args.slots, args.requests - done)
        prompts = rng.randint(0, cfg.vocab_size,
                              (args.slots, args.prompt_len)).astype(np.int32)
        server.generate(prompts, args.decode_len)
        done += n
        # recycle: fresh cache per batch (prefix cache reuse is future work)
        server.cache = transformer.init_cache(cfg, args.slots, server.max_len,
                                              torch.float32, server.device)
        print(f"served {done}/{args.requests} "
              f"({done * args.decode_len / (time.time() - t0):.0f} tok/s)")
    tokens = done * args.decode_len
    print(f"total: {tokens} tokens in {time.time()-t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
