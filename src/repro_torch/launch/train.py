"""End-to-end large-model training driver (the Acme *learner* at scale).

Trains a REDUCED variant of any assigned architecture (or, with
``--full-size``, the published one) on the synthetic token-MDP corpus
(behaviour-cloning / offline-RL objective).  As the JAX package's driver
does, it builds the one-device host mesh (``make_host_mesh``) and runs
under its ``ShardingRules``; the tensors are plain, not DTensors, so the
models' layout hints do nothing on it.  Like the JAX package's, it has no
``--mesh`` flag: the production meshes are the dry run's
(``repro_torch.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --full-size --steps 20 --batch 4 --seq 1024          # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as shlib
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.envs import TokenChain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (TrainState, init_train_state,
                                      make_train_step)
from repro_torch.models import transformer
from repro_torch.optim import adam, cosine_schedule


def make_corpus_sampler(vocab: int, seq: int, batch: int, seed: int = 0):
    """Batches of token-MDP trajectories (observations=contexts, actions
    become next-token labels) — the offline dataset for the BC learner.
    Numpy arrays, the JAX package's batches exactly."""
    env = TokenChain(vocab_size=vocab, episode_len=seq + 1, seed=seed)

    def sample():
        toks = np.zeros((batch, seq + 1), np.int32)
        for b in range(batch):
            env.reset()
            # roll the chain; the "expert" emits the true next token
            for t in range(seq + 1):
                target = env._next_token()
                toks[b, t] = target
                env.step(target)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, :-1].copy(),
            "rewards": np.ones((batch, seq), np.float32),
            "discounts": np.ones((batch, seq), np.float32),
        }

    return sample


def state_to_jax(cfg, state: TrainState) -> TrainState:
    """A train state in the JAX package's layout (``transformer.
    params_to_jax`` on params, Adam's moments and the target), numpy
    leaves: what the checkpoint holds, leaf for leaf the reference's."""
    def layout(node):
        return None if node is None else transformer.params_to_jax(cfg, node)

    opt = state.opt_state
    opt = type(opt)(opt.step.cpu().numpy(),
                    *(layout(moment) for moment in opt[1:]))
    return TrainState(layout(state.params), opt, state.step.cpu().numpy(),
                      layout(state.target_params))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--objective", default="bc", choices=["bc", "dqn"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--full-size", action="store_true",
                   help="use the published config")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    # the host mesh's world-size-1 group lives as long as the run, unless
    # one was up before it
    owns_group = not dist.is_initialized()
    rules = shlib.ShardingRules(make_host_mesh(args.device))
    try:
        with shlib.use_rules(rules):
            return _train(cfg, args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, args):
    opt = adam(cosine_schedule(args.lr, args.steps, warmup_steps=10), clip=1.0)
    generator = torch.Generator(device=args.device).manual_seed(0)
    state = init_train_state(generator, cfg, opt, device=args.device,
                             param_dtype=torch.float32,
                             objective=args.objective)
    step_fn = make_train_step(cfg, opt, objective=args.objective,
                              remat="none", microbatches=1)
    sampler = make_corpus_sampler(cfg.vocab_size, args.seq, args.batch)
    # the BC objective's CE, or the DQN objective's TD loss (it has no CE)
    metric = "ce" if args.objective == "bc" else "td"

    ck = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    t0 = time.time()
    ce0 = None
    for i in range(args.steps):
        batch = sampler()
        state, metrics = step_fn(state, batch)
        if i == 0:
            ce0 = float(metrics[metric])
        if (i + 1) % 20 == 0:
            print(f"step {i+1:4d}  {metric} {float(metrics[metric]):.4f}  "
                  f"({(i+1)/(time.time()-t0):.2f} steps/s)", flush=True)
            if ck:
                ck.save(state_to_jax(cfg, state), step=i + 1,
                        metadata={"walltime": time.time() - t0})
    ce1 = float(metrics[metric])
    print(f"done: {metric} {ce0:.4f} -> {ce1:.4f} "
          f"({'improved' if ce1 < ce0 else 'NO IMPROVEMENT'})")
    return 0 if ce1 < ce0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
