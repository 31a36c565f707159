"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with nvcc, one process per source, all started together;
2. hold each kernel against its plain PyTorch version on the card: decode
   attention at the serve shapes, the sweep shapes, a ragged cache, fully
   masked rows, caches of 1 key, of one tile and of one split and one key
   either side of them, long caches over several splits with lengths at
   the splits' edges, inside the first split and 0, 1 to 8 query heads a
   KV head (and 12, two head blocks) at every head dim, and a second call
   at another split plan that must not read the first call's partials;
   V-trace at the learner's shape, the sweep shapes, a ragged batch,
   (1, 5) and (100, 16384), and T in {1, 31, 32, 33, 64, 65, 100, 1000} x
   B in {1, 15, 16, 17, 31, 32, 33, 16391} in both layouts (time-major,
   and the learner's transposed (B, T) sequences), with ratios below and
   above the clips and discounts with zeros (max-abs error <= 1e-4 in
   float32, <= 2e-2 in bfloat16); flash attention at the sweep shapes of
   ``tests/test_kernels.py`` in both dtypes with the three mask cases, a
   ragged length, rows past the last key, GQA and head dim 16, at one
   shared-attention site of the Zamba2 path (b 4, h 32, s 2048, d 64,
   causal, float32), at the transformer policy preset's head dim 16 (sq =
   sk in {1, 7, 16, 33}, causal windows 4 and 8, both dtypes), and at the
   tensor-core design's edges: sq, sk around the warp
   and block tiles, windows that end inside a key tile, the model's strided
   views (equal to contiguous copies) and one key per query with distinct
   V rows, which a wrong key order between P and V would show (the same
   tolerances); the SSD scan at the sweep shapes, d_state 128, the Zamba2
   path's shape, one chunk, 16 chunks, the ragged chunk 100 and d_state 128
   with p 128, the final state included, and a second call at another
   shape that must not read the first call's scratch (error over the
   output's largest magnitude <= 1e-5, and <= 1e-4 at the path's shape,
   where the chunk's cumulative decay reaches ~1e3 and one f32 ulp of it is
   ~1e-4: the plain version's f32 cumulative sum carries that into the
   decay weights);
3. engine parity at the served width: a ``PolicyEngine`` on the kernel and
   one on the plain version answer the same windows (ring wrap, episode
   restarts, one ``invalidate_all``) with equal actions and Q within 1e-4;
4. the serving path: 16 Catch clients, each an ``EnvironmentLoop`` with a
   ``WindowedInferenceClientActor``, served by one
   ``TransformerInferenceServer`` over a 64-slot KV-cache pool, for 5
   episodes each; launch counts are zeroed just before and read just
   after, and every decode batch must have launched the kernel once per
   layer;
5. time the launch floor (one ``add_(1)`` on a one-element tensor), then
   each kernel, its plain version and, where one exists, one PyTorch
   library call for the same function, at the main paths' shapes, beside
   the least time the card could take: CUDA events over 200 calls, median
   of 5 (20 calls for flash attention and the SSD scan at the Zamba2
   path's shapes, flash attention on the model's strided views), both
   replayed from a CUDA graph (device time: ``ms``) and called eagerly
   (with the host's per-call cost: ``eager_ms``).  Flash attention and the
   SSD scan also carry their tensor-core bound (``bound_tc_ms``: three
   TF32 passes at 495 TFLOP/s) and, for the SSD scan, the CUDA kernels one
   call launches, counted by torch.profiler (``cuda_launches_per_call``,
   also for decode attention and V-trace); decode attention is also timed
   at a long cache (b 64, s 2048) and V-trace at shapes up to
   (100, 65536), beyond L2, in both layouts; flash attention fails the run
   if it is slower than ``scaled_dot_product_attention`` on the same
   inputs, and decode attention at the long cache if it is slower than its
   plain version or than ``scaled_dot_product_attention``; flash attention
   is also timed at the transformer policy learner's shape (b 16, h 4,
   kv 2, s 16, d 64, window 8) beside ``scaled_dot_product_attention``
   with the same band as a mask;
6. the IMPALA path: ``make_agent(IMPALABuilder(spec, IMPALAConfig()))`` at
   the reference's full width (T 20, B 16, 50-64-64 torso) with a batched
   actor over a ``VectorEnv`` of 16 Catch envs in a
   ``VectorizedEnvironmentLoop``, for 512 episodes (about 30 learner
   steps); launch counts are zeroed just before and read just after, and
   every learner step must have launched V-trace once;
7. learner parity: two IMPALA learners from the same params take the same
   10 batches, one with V-trace on the kernel and one with it held on the
   plain version; params and Adam moments agree within 1e-5, and each of
   the kernel learner's steps syncs with the device once, for its metrics;
8. the reference's IMPALA learning acceptance on the card
   (``tests/test_agents_learning.py``): Catch(seed=2), T 5, B 4, lr 3e-3,
   entropy 0.02, builder seed 1, 600 episodes; the mean return of the last
   50 beats the first 50 by more than 0.3.
9. the Zamba2-1.2B scoring path: ``make_prefill_step`` over
   ``transformer.init`` of ``configs.get_arch("zamba2-1.2b")`` at full width
   and depth (38 Mamba2 layers, the shared attention block at 6 sites,
   1.2 B parameters in float32 from seed 0), 3 batches of 4 requests x 2048
   tokens from ``numpy.random.RandomState(0)``; launch counts are zeroed
   just before and read just after those 3, and each step must launch
   flash attention 6 times and the SSD scan 38 times; then the same
   batches in turn up to 20 timed steps, for requests/s, tokens/s and the
   step time's min, p50, p95 and max; peak device memory and a profile of
   one more step;
10. the scoring path's kernel route against its plain route: the first
   batch again with ``ops.flash_attention`` and ``ops.ssd_scan`` patched to
   their plain versions (last logits within 1e-4 of the largest plain
   |logit|; equal greedy actions wherever the plain top-2 margin exceeds
   twice that), and, by the same rule, a reduced Zamba2 with a tail on the
   card's kernels against the same weights on the CPU's plain versions;
11. the DQN path: ``repro_torch.experiments.run_experiment`` with
   examples/quickstart.py's config (DQN, hidden 64, dueling, Adam 1e-3,
   prioritized replay, batch 32, n-step 1, epsilon 0.2; Catch, seed 1, 250
   episodes, an eval of 20 episodes every 50) on the card, telemetry on;
   launch counts are zeroed just before and read just after, and must stay
   0 (the path runs none of the four kernels); the mean of the last 50
   train returns must be > 0 (the quickstart's acceptance) and the final
   eval must beat the mean of the first 20 (scripts/ci.sh's); prints env
   steps/s, learner steps, the learner step's p50/p95 and the wall time,
   then profiles a 20-episode run of the same config for the device's idle
   share;
12. the DQN learner on the card against the same learner on the CPU, from
   the same init on the same 10 replay batches: losses, |td| priorities,
   params, target params and Adam moments within 1e-5 of the CPU's largest
   magnitude per leaf, and each card step syncs with the device once;
   then a learner step and an acting call on the card, each timed over 50
   calls and traced for the kernels and copies a call launches and the
   device's busy time a call;
13. gradients through the kernels: the grads of a ``q_sequence`` loss over
   the phase-3 policy's params, and of a reduced Zamba2's logits (7 Mamba2
   layers, 3 shared-attention sites, d_model 256, 2 x 512 tokens, f32),
   with flash attention and the SSD scan on their autograd Functions
   (kernel forward, plain-recompute backward) against the same calls on
   the plain route; every leaf gets a grad within 1e-4 of the plain
   grad's largest magnitude; counts zeroed before and read after each, one
   flash launch per site and one SSD launch per layer; then the
   backward's time beside the forward kernel's at the scoring path's
   shapes;
14. the transformer policy learns Catch on the card: ``run_experiment``
   with ``TransformerPolicyBuilder`` at the reference acceptance's preset
   and schedule (``tests/conftest.py:67-70``, seed 0, 250 episodes, 20
   eval episodes, backend "auto", head dim 16); launch counts are zeroed
   just before and read just after: acting must launch the decode kernel
   and every learner step flash attention twice a layer (the online pass
   through ``FlashAttentionFunction``, the target pass), and the final
   eval must beat the mean of the first 30 train returns (the reference's
   acceptance); then the learner alone at the served width (T 16, B 16):
   host ms a step (p50, p95), flash launches a step, and decode launches
   and host ms of an acting call on the same weights;
15. the transformer policy's learner on the card against the same learner
   on the CPU on the same 10 batches, at the served width and at the
   preset: step by step from the same state, losses, priorities and Adam's
   moments within 1e-5 of the CPU's largest magnitude per leaf, params
   within 1e-4 (a tenth of one Adam step), one sync a card step; then 10
   free-running steps from the same init within 1e-4 (weights whose
   gradient is near Adam's eps drift apart and feed later steps);
16. R2D2, DQfD and R2D3 on the card, each held to the reference's learning
   acceptance at its config and seeds (R2D2 on MemoryChain(5, seed 3):
   last-60 mean > 0.3; DQfD on DeepSea(6, seed 1) with 20 demos and R2D3
   on DeepSea(5, seed 1) with 15 demo sequences: the treasure in more
   than a fifth of the last 50 episodes); no kernel launches; each
   learner step's host ms;
17. continuous control on the card: the reference's D4PG acceptance
   (``tests/test_agents_learning.py:40-50``: PendulumSwingup(seed 1, 120
   steps), hidden 64, batch 64, min replay 300, SPI 0, n-step 3, 31 atoms
   over [0, 120], sigma 0.3, target period 50, builder seed 3, 60
   episodes; the mean of the last 10 returns beats the first 10's) and
   the MPO and DMPO run-and-update checks (``:53-77``: learner steps > 0,
   finite returns); env steps/s and each learner step's host ms p50/p95;
18. the DDPG, D4PG, MPO and DMPO learners at ``ContinuousConfig()``'s full
   width (hidden 256, batch 256, 51 atoms over [0, 1000], 16 MPO samples)
   on the card against the same learners on the CPU, 10 batches step by
   step from the same state, MPO and DMPO on one shared normal stream:
   losses and the policy Adam's moments within 1e-5 of the CPU's largest
   magnitude per leaf (the three 0-d MPO duals within 1e-3 of their own;
   DMPO's, whose E-step weights softmax(Q / T) amplify f32 rounding of Q ~
   500 by |Q| / T, within 1e-4; a step from a state where a hidden ReLU
   pre-activation within 1e-5 of its layer's largest |z| of 0 has another
   sign on the card than on the CPU, within 1e-3), params within 1e-4, one
   sync a card step, the critic's Adam never stepped; then each learner step's host ms p50/p95, and its kernels,
   copies and device ms (torch.profiler);
19. offline and planning on the card: ``run_offline_experiment`` with
   examples/offline_bc.py's config (120 expert Catch episodes,
   ``BCConfig()``, 400 learner steps, 25 eval episodes: learner steps/s,
   the final eval); the reference's BC and offline-DQN acceptance
   (``tests/test_system.py:51-104``: BC eval > 0.3 after 300 steps on
   20%-explore data; the DQN's loss over the last 50 of 400 steps below
   the first 5's); the reference's MCTS acceptance
   (``tests/test_agents_learning.py:93-116``: Catch(seed 4), 48
   simulations, depth 12, temperature 0.25, mean return over 10 episodes
   > 0.4; ms a search, and the first search must sync once per network
   evaluation); 12 episodes of ``make_agent(MCTSBuilder(...))``, whose
   learner must step.

20. fig17's inference placement on the card
   (``benchmarks/fig17_transformer_serving.py:60-77,141-152``): its
   transformer policy at d_model 256 (2 layers, 4 query and 2 KV heads of
   64, d_ff 512, window 8, sequence 16, period 8, batch 16, SPI 0) trains
   on Catch through ``run_distributed_experiment`` with 4 actor processes
   (the multiprocess launcher) for 3000 actor steps, once with
   ``inference="server"`` and once with ``"local"``, telemetry on; launch
   counts are zeroed just before each run and read just after, in this
   process: in server mode the inference node here must launch the decode
   kernel once a layer a decode batch, and in both modes the learner here
   flash attention twice a layer a step (local-mode actors decode in their
   own processes); prints env steps/s, the server's batches, rows a batch,
   decode and prefill rows, learner steps and the learner step's host ms
   beside phase 14's learner alone, and which mode moved more env steps a
   second (not gated); then the reference's two server acceptances
   (``tests/test_policies.py:327-360``) at phase 14's preset on the local
   and the multiprocess launcher;
21. distributed DQN on the card: the reference's multiprocess acceptance
   (``tests/test_distributed.py:631-662``: 2 actor processes, an evaluator
   process, 2 replay shards, 4000 actor steps, final eval > -0.6, 1 <
   effective SPI < 8) and two-replica acceptance
   (``tests/test_multi_learner.py:409-434``: 2 learner replicas averaging
   every 10 steps, on both launchers), then a one-replica
   ``MultiLearner`` against the plain learner on the card over 10 batches,
   bit for bit; env steps/s, learner steps/s, averaging rounds and the
   effective SPI;
22. fault tolerance on the card: phase 20's policy in server mode with
   two learner replicas exchanging through the async parameter service
   every 10 steps (``learner_sync="async"``), once under the reference's
   ``RestartPolicy(max_restarts=3)`` with a chaos kill of
   ``learner/replica_1`` and ``learner/param_service`` at their 10th step
   or push/pull, and once without either: each target restored once from
   its snapshot, no worker restarted, the rounds and both replicas'
   steps growing after the restores, flash launches exactly twice a layer
   a learner step executed and decode launches once a layer a decode
   batch (both counted by the run's telemetry after the stop); prints env
   steps/s, learner steps/s a replica, the snapshot and restore ms (all
   services and each), the learner step's host ms p50 with and without
   failover beside phase 20's and phase 14's, pushes, pulls and the
   staleness histograms.  Then the reference's four resilience acceptances
   (``tests/test_resilience.py:572-594,1148-1181,1232-1265``,
   ``tests/test_async_learner.py:584-616``) with the port's DQN on the
   card and their mechanics (the -0.6 learning gate on the one that
   restores two services, kill-shard-and-replica); fig20's async vs
   barrier learner steps a second with a straggling replica
   (``benchmarks/fig20_async_learner.py``, its 6 s smoke window, at least
   1.5x); ``weighted_average_states`` and the async service's three merges
   of three DQN states on the card equal to the CPU's bit for bit, and a
   one-replica async ``MultiLearner`` on the card equal to the plain
   learner after 10 steps.

Phases 17-19, 21 and 22's DQN parts launch none of the four kernels: each
zeros the launch counts before it and requires 0 after.  The actor
processes of phases 20-22 re-import this file to unpickle ``CardBuilder``
and ``catch_env``, so its work stays under ``__main__``.  The last phase
heading is followed by the script's total seconds.

The last three lines are the card's name and power limit (from nvidia-smi),
a JSON ``kernels`` line (with the launch floor beside the kernels), and
``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, f32
# FLOP/s outside the tensor cores, and TF32 FLOP/s on them.  Flash
# attention and the SSD scan take each f32 product as three TF32 passes,
# so their tensor-core bound is 3x the f32 work over the TF32 rate
# (``bound_tc_ms``, beside the CUDA-core ``bound_ms``).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
TF32_PASSES = 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Adam moments and params of two learners that differ only in V-trace's
# rounding (FMA contraction in the kernel), after 10 steps.
LEARNER_TOL = 1e-5

# The served policy: fig17's top size (benchmarks/fig17_transformer_serving.py)
# on Catch (10 x 5 boards, 3 actions).
POLICY = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
              head_dim=64, d_ff=512, window=8, cache_slots=64)
OBS_SHAPE = (10, 5)
NUM_ACTIONS = 3
CLIENTS = 16
EPISODES = 5

# IMPALA: the reference's IMPALAConfig() (src/repro/agents/impala.py:29-40)
# over 16 Catch envs.  Catch episodes last 9 steps and the 16 envs end
# together, so each round of 16 episodes inserts one padded sequence per
# env: one learner step (B = 16) per round once 320 observations are in.
IMPALA_ENVS = 16
IMPALA_EPISODES = 512
IMPALA_MIN_LEARNER_STEPS = 20
VTRACE_SHAPES = [("learner", 20, 16), ("sweep", 16, 128), ("sweep", 64, 256),
                 ("sweep", 100, 128), ("ragged", 20, 37), ("tiny", 1, 5),
                 ("large", 100, 16384)]
# around the kernel's 32-row chunks and 32-column tiles and its 16-byte
# copies, in both layouts (time-major, and the learner's batch-major views)
VTRACE_T = [1, 31, 32, 33, 64, 65, 100, 1000]
VTRACE_B = [1, 15, 16, 17, 31, 32, 33, 16391]
# (T, B, batch_major): the learner's shape in its own layout first (the
# kernel line's row), then beyond L2 (183 MB at B 65536)
VTRACE_TIMED = [(20, 16, True), (20, 16, False), (100, 256, False),
                (100, 16384, False), (100, 65536, False), (100, 65536, True)]

# Zamba2-1.2B scoring (src/repro_torch/configs/zamba2_1_2b.py), full width
# and depth, float32, random weights from SEED.
ZAMBA = "zamba2-1.2b"
ZAMBA_BATCHES = 3
ZAMBA_BATCH = 4
ZAMBA_SEQ = 2048
# step times: the 3 counted batches, then the same batches in turn
ZAMBA_TIMED_STEPS = 20
# Kernel route vs plain route: |d last_logits| <= this x the largest plain
# |logit| (f32 sums in other orders through 38 Mamba2 layers and 6
# attention sites; greedy actions must agree where the plain top-2 margin
# exceeds twice the tolerance).
ZAMBA_LOGIT_REL_TOL = 1e-4
REDUCED_TOL = 1e-4        # the same rule: reduced Zamba2, card vs CPU
# flash attention, phase 2: (label, b, h, kv, sq, sk, d) x masks x dtypes
# DQN on Catch: examples/quickstart.py's config (seed 1, 250 episodes, an
# eval of 20 episodes every 50), through run_experiment on the card.
DQN_QUICKSTART = dict(min_replay_size=50, samples_per_insert=0.0,
                      batch_size=32, n_step=1, epsilon=0.2)
DQN_EPISODES = 250
DQN_PROFILED_EPISODES = 20
DQN_PROFILED_STEPS = 50
# the card learner against the CPU learner after 10 steps, max |d| over
# the CPU's largest magnitude per leaf (TF32 off: the same f32 math in
# another summation order)
DQN_TOL = 1e-5
# Gradients through the kernels against the plain route's: max |d| over the
# plain gradient's largest magnitude per leaf, at the kernels' f32
# tolerance (the forward outputs differ by up to 1e-4; the backward is the
# plain version's).
GRAD_TOL = 1e-4
GRAD_POLICY_BATCH = 64
GRAD_ZAMBA = dict(num_layers=7, hybrid_attn_every=2)
GRAD_ZAMBA_TOKENS = (2, 512)

# The transformer policy's training half (phases 14-16).  The reference
# acceptance's preset and schedule (tests/conftest.py:67-70,
# tests/test_policies.py::test_transformer_policy_learns_catch: seed 0,
# 250 episodes, no periodic eval, 20 eval episodes) with backend "auto", so
# acting decodes on the decode kernel and the learner runs flash attention
# at head_dim 16.
POLICY_PRESET = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                     head_dim=16, d_ff=64, window=4, sequence_length=10,
                     period=10, batch_size=8, min_replay_size=10,
                     samples_per_insert=0.0, backend="auto")
POLICY_EPISODES = 250
POLICY_EVAL_EPISODES = 20
# the learner alone at the served width (POLICY) on T 16, B 16; a target
# copy every 3 steps, so the 10 parity steps cover three copies
POLICY_LEARNER = dict(POLICY, sequence_length=16, batch_size=16,
                      target_update_period=3)
POLICY_TIMED_STEPS = 50
# card vs CPU learner, each step from the same state: loss, priorities and
# Adam's moments within this of the CPU's largest magnitude per leaf;
# params within POLICY_PARAM_ATOL, a tenth of one Adam step at the learning
# rate 1e-3 (a gradient near Adam's eps moves its weight by lr g / (|g| +
# eps), so summation-order noise in it moves the weight by up to ~lr / 50)
POLICY_TOL = 1e-5
POLICY_PARAM_ATOL = 1e-4
# the same after 10 free-running steps from the same init, where those
# weights feed later gradients (1.6e-5 seen on Adam's moments at fig17
# width, NVIDIA H100 80GB HBM3)
POLICY_DRIFT_TOL = 1e-4
# flash attention at the learner's shape (fig17 width): b, h, kv, s, d
POLICY_FLASH_SHAPE = (16, 4, 2, 16, 64)
# flash attention at the preset's head dim 16: sq = sk, windows 4 and 8
FLASH_D16_SEQS = [1, 7, 16, 33]
FLASH_D16_WINDOWS = [4, 8]

# Continuous control (phases 17-18).  Phase 17: the reference's D4PG
# acceptance (tests/test_agents_learning.py:40-50) and its MPO and DMPO
# run-and-update checks (:53-77), at their configs and seeds.
D4PG_ACCEPT = dict(algo="d4pg", hidden=64, batch_size=64,
                   min_replay_size=300, samples_per_insert=0, n_step=3,
                   vmin=0.0, vmax=120.0, num_atoms=31, sigma=0.3,
                   target_update_period=50)
D4PG_EPISODES = 60
MPO_CHECKS = {   # algo: (env seed, builder seed, config), 12 episodes of 60
    "mpo": (2, 4, dict(algo="mpo", hidden=32, batch_size=32,
                       min_replay_size=120, samples_per_insert=0,
                       mpo_samples=8, target_update_period=25)),
    "dmpo": (5, 5, dict(algo="dmpo", hidden=32, batch_size=32,
                        min_replay_size=120, samples_per_insert=0,
                        mpo_samples=8, vmin=0.0, vmax=60.0, num_atoms=21))}
MPO_EPISODES = 12
# Phase 18: ContinuousConfig()'s full width (hidden 256, batch 256, 51
# atoms over [0, 1000], 16 MPO samples) on PendulumSwingup's spec, card vs
# CPU step by step from the same state: losses and Adam's moments within
# CONTINUOUS_TOL of the CPU's largest magnitude per leaf, params within
# POLICY_PARAM_ATOL; the three 0-d MPO duals' moments within
# CONTINUOUS_DUAL_TOL of their own magnitude: each dual's gradient is a
# small difference of much larger terms (the temperature's of order max |Q|
# / T, up to ~500 here, against ~0.1), so f32 rounding in those terms is
# 1e-4 to 6e-4 of the gradient on any two devices (5.9e-4 seen on DMPO's
# temperature, card vs CPU, NVIDIA H100 80GB HBM3).
# A step from a state where a hidden ReLU's pre-activation lies within f32
# rounding of 0 (|z| <= CONTINUOUS_KINK_Z of its layer's largest) on one
# device and across it on the other takes that unit's gradient on one
# device only: such a step's moments are held to CONTINUOUS_KINK_TOL (one
# flip at z = -1.7e-8 moved DDPG's moments by 2.5e-4 of a leaf's largest,
# NVIDIA H100 80GB HBM3), every other step's to CONTINUOUS_TOL.
# DMPO's E-step weights softmax(Q / T) take Q from a C51 critic over [0,
# 1000] (Q ~ 500 at T ~ 1), so f32 rounding of Q, ~1e-7 of |Q|, moves them
# by ~|Q| / T times as much: its moments are held to 1e-4 (card vs CPU:
# 1.06e-5 at one step, NVIDIA H100 80GB HBM3).  MPO's expected critic
# keeps |Q| ~ 1.
CONTINUOUS_ALGOS = ("ddpg", "d4pg", "mpo", "dmpo")
CONTINUOUS_TOL = 1e-5
CONTINUOUS_ALGO_TOL = {"dmpo": 1e-4}
CONTINUOUS_KINK_Z = 1e-5
CONTINUOUS_KINK_TOL = 1e-3
CONTINUOUS_DUAL_TOL = 1e-3
CONTINUOUS_DUALS = ("log_temp", "log_alpha_mean", "log_alpha_std")
CONTINUOUS_BATCHES = 10
CONTINUOUS_TIMED_STEPS = 50
# Phase 19: examples/offline_bc.py (120 expert Catch episodes, BCConfig(),
# 400 learner steps, 25 eval episodes); the reference's BC and offline DQN
# acceptance (tests/test_system.py:51-104) and MCTS acceptance
# (tests/test_agents_learning.py:93-116); then make_agent(MCTSBuilder).
BC_EXAMPLE_EPISODES = 120
BC_EXAMPLE_STEPS = 400
BC_EXAMPLE_EVAL_EPISODES = 25
MCTS_ACCEPT = dict(num_simulations=48, search_depth=12, temperature=0.25)
MCTS_AGENT = dict(num_simulations=8, search_depth=6, batch_size=4,
                  min_replay_size=4)
MCTS_AGENT_EPISODES = 12
# Phase 20: fig17's inference placement (benchmarks/
# fig17_transformer_serving.py:60-77,141-152) at its top width: 4 actor
# processes, 3000 actor steps, no eval, each mode once; then the
# reference's two server acceptances (tests/test_policies.py:327-360) at
# the preset of phase 14 (backend "auto", so the server decodes on the
# kernel).
FIG17_POLICY = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                    head_dim=64, d_ff=512, window=8, sequence_length=16,
                    period=8, batch_size=16, min_replay_size=100,
                    samples_per_insert=0.0, backend="auto")
FIG17_ACTORS = 4
FIG17_STEPS = 3000
FIG17_TIMEOUT_S = 300.0
# Phase 21: the reference's distributed DQN acceptances on the card:
# tests/test_distributed.py:631-662 (2 replay shards, an evaluator, 4000
# actor steps) and tests/test_multi_learner.py:409-434 (2 replicas
# averaging every 10 steps, both launchers), at conftest's DQN preset
# (tests/conftest.py:32-46).
DQN_SMOKE = dict(min_replay_size=50, samples_per_insert=4.0, batch_size=16,
                 n_step=1, epsilon=0.2)
DIST_ACTORS = 2
DIST_STEPS = 4000
DIST_TIMEOUT_S = 240.0
CATCH_FLOOR = -0.6
ONE_REPLICA_STEPS = 10
# Phase 22: fault tolerance.  fig17's policy of phase 20 (inference
# "server", 4 actor processes, FIG17_STEPS actor steps) with two learner
# replicas exchanging through the async parameter service every 10 steps,
# run once with the reference's RestartPolicy(max_restarts=3) and a chaos
# kill of replica 1 and of the parameter service, and once without either
# (the like-for-like run the learner step's host ms is compared with).
# The replicas start once each shard holds min_replay_size sequences; the
# kill fires at replica 1's 10th step and at the service's 10th push or
# pull (5 exchanges), both in the first third of the replicas' steps.
FIG17_FAILOVER = dict(num_learner_replicas=2, learner_average_period=10,
                      learner_sync="async")
FIG17_KILL_AFTER = 10
FIG17_KILL_TARGETS = ("learner/replica_1", "learner/param_service")
# Then the reference's four resilience acceptances at its configs
# (tests/test_resilience.py:572-594,1148-1181,1232-1265 and
# tests/test_async_learner.py:584-616), conftest's DQN preset, 2 actors,
# 4000 actor steps, 20 eval episodes: (restart policy and chaos, other
# knobs, timeout s, whether the -0.6 learning gate applies on the card).
RESILIENCE_ACCEPTANCES = {
    "chaos_kill_actor": (dict(kill_after_steps=400,
                              kill_targets=("actor/0",)), {}, 240.0, False),
    "failover_kill_shard_and_replica": (
        dict(kill_after_steps=300,
             kill_targets=("replay/shard_0", "learner/replica_0")),
        dict(num_learner_replicas=2, learner_average_period=10,
             barrier_timeout_s=2.0, min_quorum=1), 300.0, True),
    "failover_kill_async_param_service": (
        dict(kill_after_steps=20, kill_targets=("learner/param_service",)),
        dict(num_learner_replicas=2, learner_average_period=10,
             learner_sync="async"), 300.0, False),
    "two_replica_async_multiprocess": (
        None, dict(num_learner_replicas=2, learner_average_period=10,
                   learner_sync="async"), 240.0, False),
}
# fig20's method and constants (benchmarks/fig20_async_learner.py:31-43,
# 47-52): two DQN replicas (min replay 32, SPI 0, batch 16, n-step 1), the
# first sleeping SLOW_STEP_S a step, one actor on threads; aggregate
# learner steps over the smoke window after every replica's warm-up steps,
# barrier then async; async must move SMOKE_MIN_SPEEDUP times as many.
FIG20_DQN = dict(min_replay_size=32, samples_per_insert=0.0, batch_size=16,
                 n_step=1)
FIG20_AVERAGE_PERIOD = 10
FIG20_SLOW_STEP_S = 0.05
FIG20_WARMUP_STEPS = 2
FIG20_WARMUP_TIMEOUT_S = 120.0
FIG20_MEASURE_S = 6.0
FIG20_MIN_SPEEDUP = 1.5
# The blends: three DQN states (stepped apart on the CPU) blended on the
# card and on the CPU, pushed at these steps, blended with these weights.
BLEND_STEPS = (12, 9, 10)
BLEND_WEIGHTS = (1e-3, 7.0, 2.5)

FLASH_CASES = [("sweep", 1, 1, 1, 128, 128, 64),
               ("sweep", 2, 2, 2, 256, 256, 64),
               ("sweep", 1, 4, 4, 256, 512, 128),
               ("sweep", 2, 1, 1, 512, 512, 32),
               ("ragged", 2, 4, 4, 100, 100, 64),
               ("past_keys", 1, 2, 2, 300, 100, 64),
               ("gqa", 2, 8, 2, 256, 256, 64),
               ("d16", 2, 4, 2, 100, 100, 16)]
FLASH_MASKS = [(True, None), (True, 64), (False, None)]
# SSD scan, phase 2: (label, b, s, h, p, n, chunk)
SSD_CASES = [("sweep", 1, 256, 2, 32, 16, 64),
             ("sweep", 2, 512, 4, 64, 32, 128),
             ("sweep", 1, 512, 2, 64, 64, 256),
             ("mamba2_n128", 2, 512, 8, 64, 128, 256),
             ("ragged_chunk", 1, 300, 3, 16, 24, 100)]
SSD_TOL = 1e-5            # of the output's largest magnitude
SSD_PATH_TOL = 1e-4       # at the path's shape (see phase 2 above)
# phase 2, the redesign's edges: flash at sq, sk around the 16-row warp
# tiles and the 64-row / 64-key block tiles, windows that end inside a key
# tile; the SSD scan with one chunk, 16 chunks, the ragged chunk 100 and
# d_state 128 over two state tiles: (label, b, s, h, p, n, chunk)
FLASH_EDGES = [1, 15, 16, 17, 63, 65, 127, 129]
FLASH_WINDOWS = [65, 100, 130]
SSD_CHUNKINGS = [("one_chunk", 2, 256, 4, 64, 64, 256),
                 ("16_chunks", 1, 1024, 3, 32, 16, 64),
                 ("chunk_100", 2, 400, 4, 64, 32, 100),
                 ("n128_p128", 1, 512, 4, 128, 128, 128)]


class SmokeFailure(RuntimeError):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


def card_line():
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(fn, warmup=20, launches=200, repeats=5, graph=True):
    """Median over ``repeats`` of the mean time of ``launches`` back-to-back
    calls, by CUDA events.

    ``graph=True`` captures the calls in a CUDA graph and times its replay:
    the device time, without the host's per-call cost.  ``graph=False``
    times eager calls, which the host's enqueue rate bounds when the device
    work is shorter than the call's Python cost.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            for _ in range(launches):
                fn()

        def batch():
            cuda_graph.replay()
    else:
        def batch():
            for _ in range(launches):
                fn()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        batch()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / launches)
    return statistics.median(samples)


def launch_floor(torch):
    """The time of the least kernel the card runs: one ``add_(1)`` on a
    one-element tensor, from a CUDA graph (device ms) and eager (host
    ms), timed as every kernel is.  A kernel whose bound lies far below
    this sits at its launch floor."""
    x = torch.zeros(1, device="cuda")
    return {"launch_floor_ms": time_ms(lambda: x.add_(1), graph=True),
            "eager_launch_floor_ms": time_ms(lambda: x.add_(1), graph=False)}


# ---------------------------------------------------------- decode attention
def decode_inputs(b, h, kv, s, d, lengths, dtype, rng):
    import torch
    q = torch.as_tensor(rng.randn(b, h, d).astype(np.float32))
    k = torch.as_tensor(rng.randn(b, s, kv, d).astype(np.float32))
    v = torch.as_tensor(rng.randn(b, s, kv, d).astype(np.float32))
    return (q.to("cuda", dtype), k.to("cuda", dtype), v.to("cuda", dtype),
            torch.as_tensor(np.asarray(lengths, np.int32)).cuda())


def serve_lengths(b, s, rng):
    """Mixed lengths as the serve step emits them: full rings, mid-prefix
    rows and length-1 pad/restart rows."""
    lengths = np.full((b,), s, np.int32)
    lengths[1::3] = rng.randint(2, s, len(lengths[1::3]))
    lengths[2::3] = 1
    return lengths


def edge_lengths(b, s, keys_per_split, rng):
    """Lengths at the split plan's edges: 0 (every key masked), inside the
    first split, one short of, at and one past a split's end, s, 1, then
    random ones."""
    edges = [0, max(keys_per_split // 2, 1), keys_per_split - 1,
             keys_per_split, keys_per_split + 1, s, 1]
    lengths = np.asarray(edges + list(rng.randint(0, s + 1, b)), np.int64)
    return np.clip(lengths[:b], 0, s + 1)


def decode_cases(rng, plan_splits, head_dims):
    """(label, b, h, kv, s, d, lengths) for phase 2: the serving shapes,
    the sweep, ragged and masked rows; caches of one key, one tile and one
    split and one key either side of them, and long ones over several
    splits, with lengths at the splits' edges; 1 to 8 query heads a KV
    head (12: two head blocks) at every head dim."""
    cases = []
    for b in (1, 8, 64):
        cases.append(("serve", b, 4, 2, 8, 64, serve_lengths(b, 8, rng)))
    for b, h, s, d in ((1, 1, 512, 64), (2, 4, 1024, 64), (1, 8, 512, 128),
                       (4, 2, 2048, 32)):
        cases.append(("sweep", b, h, h, s, d, rng.randint(1, s + 1, b)))
    cases.append(("ragged", 4, 4, 2, 1000, 64, rng.randint(1, 1001, 4)))
    cases.append(("masked", 4, 4, 2, 64, 64, np.asarray([0, 64, 0, 10])))
    for b, s in ((8, 1), (8, 63), (8, 64), (8, 65), (8, 127), (8, 128),
                 (8, 129), (8, 2048), (8, 4096), (64, 447), (64, 448),
                 (64, 449), (64, 2048)):
        keys = plan_splits(b, 2, s, 64)[1]
        cases.append(("split", b, 4, 2, s, 64, edge_lengths(b, s, keys, rng)))
    for group in (1, 2, 4, 8, 12):
        for d in head_dims:
            keys = plan_splits(8, 2, 300, d)[1]
            cases.append(("group", 8, 2 * group, 2, 300, d,
                          edge_lengths(8, 300, keys, rng)))
    return cases


def decode_bound(b, h, kv, s, d, lengths, itemsize):
    """Least time (ms) for these inputs: q and out once, the K and V rows
    each row attends to once (the valid prefix; all s keys when none is
    valid), lengths once; two multiply-adds per key, head and channel."""
    keys = sum(min(int(n), s) if n >= 1 else s for n in lengths)
    nbytes = itemsize * (2 * b * h * d + 2 * keys * kv * d) + 4 * b
    flops = 4 * keys * h * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def check_decode_attention(kernel, ref, torch, plan_splits, head_dims):
    rng = np.random.RandomState(SEED)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, b, h, kv, s, d, lengths in decode_cases(rng, plan_splits,
                                                       head_dims):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v, lens = decode_inputs(b, h, kv, s, d, lengths, dtype, rng)
            out = kernel(q, k, v, lens)
            torch.cuda.synchronize()
            expected = ref.decode_attention_ref(q, k, v, lens)
            check(out.shape == expected.shape and out.dtype == q.dtype,
                  f"decode_attention {label}: shape/dtype mismatch")
            check(bool(torch.isfinite(out).all()),
                  f"decode_attention {label}: non-finite output")
            err = (out.float() - expected.float()).abs().max().item()
            worst[name] = max(worst[name], err)
            log(f"  decode_attention {label:8s} b={b:<3d} h={h:<2d} kv={kv} "
                f"s={s:<5d} d={d:<3d} splits={plan_splits(b, kv, s, d)[0]:<3d}"
                f" {name:8s} max_abs_err={err:.3e}")
            check(err <= TOL[name], f"decode_attention {label} {name}: "
                  f"max_abs_err {err} > {TOL[name]}")
    # a second call at another split plan, on partials the allocator hands
    # back, matches the plain version; the first call repeats exactly
    big = decode_inputs(64, 4, 2, 2048, 64, rng.randint(0, 2049, 64),
                        torch.float32, rng)
    first = kernel(*big)
    small = decode_inputs(4, 8, 2, 300, 32, edge_lengths(4, 300, 64, rng),
                          torch.float32, rng)
    err = (kernel(*small) - ref.decode_attention_ref(*small)).abs().max(
        ).item()
    again = kernel(*big)
    torch.cuda.synchronize()
    check(err <= TOL["float32"] and torch.equal(again, first),
          f"decode_attention: a second call read stale partials ({err}) or "
          f"the first call did not repeat")
    log(f"  decode_attention second call at another split plan: "
        f"max_abs_err={err:.3e}; the first call repeats exactly")
    worst["float32"] = max(worst["float32"], err)
    return worst


def time_decode_attention(kernel, ref, torch, plan_splits, b, s,
                          lengths_value):
    """Kernel, plain version and scaled_dot_product_attention (the library
    yardstick, never called by the port) at the served head layout, and the
    CUDA kernels one call launches, counted by torch.profiler: the split
    plan's one, or two when it cuts the cache."""
    import torch.nn.functional as F
    h, kv, d = POLICY["num_heads"], POLICY["num_kv_heads"], POLICY["head_dim"]
    rng = np.random.RandomState(SEED + 1)
    lengths = np.full((b,), lengths_value, np.int32)
    q, k, v, lens = decode_inputs(b, h, kv, s, d, lengths, torch.float32, rng)
    err = (kernel(q, k, v, lens) - ref.decode_attention_ref(q, k, v, lens)
           ).abs().max().item()
    # the library call's own layout, prepared outside the timed region
    q4 = q[:, :, None, :]
    k4, v4 = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    bound, bound_by = decode_bound(b, h, kv, s, d, lengths, 4)
    calls = {
        "": lambda: kernel(q, k, v, lens),
        "plain_": lambda: ref.decode_attention_ref(q, k, v, lens),
        "library_": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True),
    }
    splits = plan_splits(b, kv, s, d)[0]
    timed = {"shape": {"b": b, "h": h, "kv": kv, "s": s, "d": d,
                       "lengths": int(lengths_value), "dtype": "float32",
                       "splits": splits},
             "max_abs_err_timed": err, "bound_ms": bound,
             "bound_by": bound_by}
    launched = device_kernels(torch, calls[""])
    if launched is None:
        log("  decode_attention: the profiler recorded no device activity; "
            "CUDA launches per call not measured")
        timed["cuda_launches_per_call"] = None
    else:
        names = [name for name, _ in launched]
        stages = ["decode_split_kernel"] + (
            ["decode_combine_kernel"] if splits > 1 else [])
        check(len(names) == len(stages)
              and all(stage in name for name, stage in zip(names, stages)),
              f"decode_attention: one call launched {names}, not {stages}")
        timed["cuda_launches_per_call"] = len(launched)
        timed["device_ms_by_kernel"] = {
            stage: ms for stage, (_, ms) in zip(stages, launched)}
    for prefix, fn in calls.items():
        timed[f"{prefix}ms"] = time_ms(fn, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, graph=False)
    return timed


# ------------------------------------------------------------------ V-trace
def vtrace_inputs(T, B, rng, batch_major=False):
    """(T, B) f32 on the card: ratios below and above the clips, discounts
    with zeros (episode ends).  Time-major, or with ``batch_major`` the
    (T, B) transposes of contiguous (B, T) tensors, as the learner passes
    its sequences."""
    import torch
    discounts = rng.rand(T, B) * 0.99
    discounts[rng.rand(T, B) < 0.1] = 0.0
    arrays = (rng.randn(T, B), rng.randn(T, B), rng.randn(T, B), discounts,
              np.abs(rng.randn(T, B)) + 0.1)
    if batch_major:
        return tuple(torch.as_tensor(np.ascontiguousarray(a.T),
                                     dtype=torch.float32,
                                     device="cuda").transpose(0, 1)
                     for a in arrays)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                 for a in arrays)


def vtrace_bound(T, B):
    """Least time (ms): five f32 inputs read once and two outputs written
    once; about 12 f32 operations per element."""
    by_bytes = 28 * T * B / HBM_BYTES_PER_S * 1e3
    by_ops = 12 * T * B / F32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def vtrace_error(kernel, ref, inputs, clip_rho=1.0, clip_c=1.0):
    out = kernel(*inputs, clip_rho, clip_c)
    expected = ref.vtrace_ref(*inputs, clip_rho=clip_rho, clip_c=clip_c)
    return max((a - e).abs().max().item() for a, e in zip(out, expected)), \
        out


def check_vtrace(kernel, ref, torch):
    rng = np.random.RandomState(SEED + 3)
    worst = 0.0
    cases = [(label, T, B, False) for label, T, B in VTRACE_SHAPES] + [
        ("edges", T, B, batch_major) for T in VTRACE_T for B in VTRACE_B
        for batch_major in (False, True)]
    edges = 0.0
    for label, T, B, batch_major in cases:
        inputs = vtrace_inputs(T, B, rng, batch_major)
        for clips in ((1.0, 1.0), (0.8, 1.5)):
            err, out = vtrace_error(kernel, ref, inputs, *clips)
            torch.cuda.synchronize()
            layout_ok = all((o.transpose(0, 1) if batch_major else o
                             ).is_contiguous() for o in out)
            check(layout_ok and all(o.shape == (T, B)
                                    and bool(torch.isfinite(o).all())
                                    for o in out),
                  f"vtrace {label} T={T} B={B} batch_major={batch_major}: "
                  f"bad output")
            worst = max(worst, err)
            if label == "edges":
                edges = max(edges, err)
            else:
                log(f"  vtrace {label:8s} T={T:<3d} B={B:<5d} clips={clips} "
                    f"max_abs_err={err:.3e}")
            check(err <= TOL["float32"], f"vtrace {label} T={T} B={B} "
                  f"batch_major={batch_major}: max_abs_err {err} > "
                  f"{TOL['float32']}")
    log(f"  vtrace edges T in {VTRACE_T} x B in {VTRACE_B}, both layouts, "
        f"both clips: max_abs_err={edges:.3e}")
    return worst


def time_vtrace(kernel, ref, torch, T, B, batch_major):
    """Kernel and plain version; no single PyTorch call computes a reverse
    linear recurrence, so there is no library yardstick."""
    inputs = vtrace_inputs(T, B, np.random.RandomState(SEED + 4),
                           batch_major)
    err, _ = vtrace_error(kernel, ref, inputs)
    bound, bound_by = vtrace_bound(T, B)
    timed = {"shape": {"T": T, "B": B, "dtype": "float32",
                       "layout": "batch-major views" if batch_major
                       else "time-major"},
             "max_abs_err_timed": err, "bound_ms": bound,
             "bound_by": bound_by, "library_ms": None}
    calls = {"": lambda: kernel(*inputs),
             "plain_": lambda: ref.vtrace_ref(*inputs)}
    launched = device_kernels(torch, calls[""])
    if launched is None:
        timed["cuda_launches_per_call"] = None
    else:
        names = [name for name, _ in launched]
        check(len(names) == 1 and "vtrace_kernel" in names[0],
              f"vtrace: one call launched {names}, not vtrace_kernel alone")
        timed["cuda_launches_per_call"] = 1
    for prefix, fn in calls.items():
        timed[f"{prefix}ms"] = time_ms(fn, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, graph=False)
    return timed


# ---------------------------------------------------------- flash attention
def flash_inputs(b, h, kv, sq, sk, d, dtype, rng):
    import torch
    return tuple(torch.as_tensor(rng.randn(*shape).astype(np.float32)
                                 ).to("cuda", dtype)
                 for shape in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d)))


def flash_pairs(sq, sk, causal, window):
    """(query, key) pairs the masks keep; a row that keeps none weighs all
    sk keys (the mean of V)."""
    if not causal:
        return sq * sk
    rows = np.arange(sq)
    last = np.minimum(rows, sk - 1)
    first = np.zeros_like(rows) if window is None else \
        np.maximum(rows - window + 1, 0)
    kept = np.maximum(last - first + 1, 0)
    return int(np.where(kept > 0, kept, sk).sum())


def bounds(nbytes, flops):
    """(bound_ms, bound_by) on CUDA cores in f32, and bound_tc_ms: the same
    bytes against 3 TF32 passes of the work on tensor cores."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    by_tc = TF32_PASSES * flops / TF32_FLOPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations",
            max(by_bytes, by_tc))


def flash_bound(b, h, kv, sq, sk, d, causal, window, itemsize):
    """Least time (ms): q, K, V and out once; two multiply-adds (q.k and
    p.v) per kept (query, key) pair and channel, per head."""
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * kv * sk)
    flops = 4 * d * b * h * flash_pairs(sq, sk, causal, window)
    return bounds(nbytes, flops)


def check_flash(kernel, ref, torch, cfg):
    """FLASH_CASES with every mask and dtype, then one shared-attention
    site of the scoring path with its own mask and dtype."""
    rng = np.random.RandomState(SEED + 5)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    path = ("zamba2_path", ZAMBA_BATCH, cfg.num_heads, cfg.num_kv_heads,
            ZAMBA_SEQ, ZAMBA_SEQ, cfg.head_dim)
    for label, b, h, kv, sq, sk, d in FLASH_CASES + [path]:
        on_path = label == "zamba2_path"
        masks = [(True, cfg.sliding_window)] if on_path else FLASH_MASKS
        dtypes = [("float32", torch.float32)] + (
            [] if on_path else [("bfloat16", torch.bfloat16)])
        for causal, window in masks:
            for name, dtype in dtypes:
                q, k, v = flash_inputs(b, h, kv, sq, sk, d, dtype, rng)
                out = kernel(q, k, v, causal, window)
                torch.cuda.synchronize()
                expected = ref.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window)
                check(out.shape == expected.shape and out.dtype == q.dtype,
                      f"flash_attention {label}: shape/dtype mismatch")
                check(bool(torch.isfinite(out).all()),
                      f"flash_attention {label}: non-finite output")
                err = (out.float() - expected.float()).abs().max().item()
                worst[name] = max(worst[name], err)
                log(f"  flash_attention {label:11s} b={b} h={h} kv={kv} "
                    f"sq={sq:<3d} sk={sk:<3d} d={d:<3d} causal={causal:d} "
                    f"window={window} {name:8s} max_abs_err={err:.3e}")
                check(err <= TOL[name], f"flash_attention {label} {name}: "
                      f"max_abs_err {err} > {TOL[name]}")
    worst["float32"] = max(worst["float32"],
                           check_flash_edges(kernel, ref, torch, rng))
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        err = check_flash_d16(kernel, ref, torch, rng, dtype)
        worst[name] = max(worst[name], err)
        log(f"  flash_attention d=16, sq=sk in {FLASH_D16_SEQS}, causal "
            f"windows {FLASH_D16_WINDOWS}, {name}: max_abs_err={err:.3e}")
    return worst


def check_flash_d16(kernel, ref, torch, rng, dtype):
    """Head dim 16 (the policy preset's): 64-byte f32 and 32-byte bf16 rows,
    two k-steps of S = Q.K^T, windows of 4 and 8 that empty whole key
    groups; GQA 2:1."""
    name = str(dtype).split(".")[-1]
    worst = 0.0
    for s in FLASH_D16_SEQS:
        for window in FLASH_D16_WINDOWS:
            q, k, v = flash_inputs(3, 4, 2, s, s, 16, dtype, rng)
            out = kernel(q, k, v, True, window)
            torch.cuda.synchronize()
            expected = ref.flash_attention_ref(q, k, v, causal=True,
                                               window=window)
            check(out.shape == expected.shape and out.dtype == dtype
                  and bool(torch.isfinite(out).all()),
                  f"flash_attention d=16 s={s} window={window}: bad output")
            err = (out.float() - expected.float()).abs().max().item()
            check(err <= TOL[name], f"flash_attention d=16 s={s} "
                  f"window={window} {name}: max_abs_err {err} > {TOL[name]}")
            worst = max(worst, err)
    return worst


def flash_error(kernel, ref, torch, q, k, v, causal, window, label):
    out = kernel(q, k, v, causal, window)
    torch.cuda.synchronize()
    expected = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    check(out.shape == expected.shape and bool(torch.isfinite(out).all()),
          f"flash_attention {label}: bad output")
    err = (out.float() - expected.float()).abs().max().item()
    check(err <= TOL["float32"], f"flash_attention {label}: max_abs_err "
          f"{err} > {TOL['float32']}")
    return err, out


def check_flash_edges(kernel, ref, torch, rng):
    """The tensor-core design's edges, in float32: sq, sk around the warp
    and block tiles; windows that end inside a key tile (causal tiles
    launch heaviest first); the model's strided views against contiguous
    copies (equal); one key per query with distinct V rows, which a wrong
    key order between P and V would show."""
    worst = 0.0
    for sq in FLASH_EDGES:
        for sk in FLASH_EDGES:
            for causal in (True, False):
                q, k, v = flash_inputs(1, 4, 2, sq, sk, 64, torch.float32,
                                       rng)
                err, _ = flash_error(kernel, ref, torch, q, k, v, causal,
                                     None, f"edge sq={sq} sk={sk}")
                worst = max(worst, err)
    log(f"  flash_attention edges sq, sk in {FLASH_EDGES}, causal and not: "
        f"max_abs_err={worst:.3e}")
    for window in FLASH_WINDOWS:
        q, k, v = flash_inputs(2, 4, 4, 300, 300, 64, torch.float32, rng)
        err, _ = flash_error(kernel, ref, torch, q, k, v, True, window,
                             f"window {window}")
        worst = max(worst, err)
        log(f"  flash_attention window={window} across key tiles s=300 "
            f"max_abs_err={err:.3e}")
    model = [torch.as_tensor(rng.randn(2, 200, heads, 64).astype(np.float32),
                             device="cuda") for heads in (8, 2, 2)]
    views = [t.transpose(1, 2) for t in model]
    err, out = flash_error(kernel, ref, torch, *views, True, 80,
                           "model-layout views")
    same = torch.equal(out, kernel(*(t.contiguous() for t in views), True,
                                   80))
    check(same and out.transpose(1, 2).is_contiguous(),
          "flash_attention: strided views differ from contiguous copies, "
          "or the output is not in the model's order")
    log(f"  flash_attention model-layout views: equal to contiguous copies, "
        f"max_abs_err={err:.3e}")
    for d in (32, 64, 128):
        target = rng.randint(0, d, 200)
        arrays = (np.eye(d)[target], np.eye(d) * 40.0 * d ** 0.5,
                  np.arange(d)[:, None] + 0.01 * rng.randn(d, d))
        q, k, v = (torch.as_tensor(a, dtype=torch.float32,
                                   device="cuda")[None, None]
                   for a in arrays)
        err, out = flash_error(kernel, ref, torch, q, k, v, False, None,
                               f"one key per query d={d}")
        picked = (out[0, 0] - v[0, 0, target]).abs().max().item()
        check(picked <= 1e-3, f"flash_attention: one key per query, d={d}: "
              f"output {picked} from that key's V row")
        log(f"  flash_attention one key per query d={d}: max_abs_err="
            f"{err:.3e}, {picked:.3e} from the chosen keys' V rows")
    return worst


def time_flash(kernel, ref, torch, cfg):
    """At the shape of one shared-attention site of the scoring path: the
    kernel on (b, heads, s, head_dim) views of (b, s, heads, head_dim)
    tensors, as models/attention.py passes them; its plain version; and
    scaled_dot_product_attention (the library yardstick, never called by
    the port) on contiguous (b, heads, s, head_dim) tensors.  The kernel
    must not be slower than the library call."""
    import torch.nn.functional as F
    b, h, kv, s, d = (ZAMBA_BATCH, cfg.num_heads, cfg.num_kv_heads,
                      ZAMBA_SEQ, cfg.head_dim)
    window = cfg.sliding_window
    q, k, v = flash_inputs(b, h, kv, s, s, d, torch.float32,
                           np.random.RandomState(SEED + 6))
    # the same values as (b, heads, s, d) views of (b, s, heads, d) tensors
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    err = (kernel(*views, True, window)
           - ref.flash_attention_ref(q, k, v, causal=True, window=window)
           ).abs().max().item()
    check(err <= TOL["float32"], f"flash_attention at the scoring shape: "
          f"max_abs_err {err} > {TOL['float32']}")
    bound, bound_by, bound_tc = flash_bound(b, h, kv, s, s, d, True, window,
                                            4)
    timed = {"shape": {"b": b, "h": h, "kv": kv, "sq": s, "sk": s, "d": d,
                       "causal": True, "window": window, "dtype": "float32",
                       "layout": "model (b, s, heads, d) views"},
             "max_abs_err_timed": err, "bound_ms": bound,
             "bound_by": bound_by, "bound_tc_ms": bound_tc}
    calls = {
        "": lambda: kernel(*views, True, window),
        "plain_": lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                  window=window),
        "library_": lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
    }
    for prefix, fn in calls.items():
        timed[f"{prefix}ms"] = time_ms(fn, warmup=3, launches=20, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, warmup=3, launches=20,
                                             graph=False)
    check(timed["ms"] <= timed["library_ms"], f"flash_attention at the "
          f"scoring shape: {timed['ms']} ms, slower than "
          f"scaled_dot_product_attention's {timed['library_ms']} ms")
    return timed


def time_flash_policy(kernel, ref, torch):
    """At the transformer policy learner's shape (fig17 width: b 16, h 4,
    kv 2, s 16, d 64, causal, window 8), on the model's strided views: the
    kernel, its plain version, and scaled_dot_product_attention with the
    same band as a boolean mask over K/V repeated to the query heads (the
    repeat made before timing)."""
    import torch.nn.functional as F
    b, h, kv, s, d = POLICY_FLASH_SHAPE
    window = POLICY["window"]
    q, k, v = flash_inputs(b, h, kv, s, s, d, torch.float32,
                           np.random.RandomState(SEED + 14))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    rows = torch.arange(s, device="cuda")
    band = (rows[:, None] >= rows[None, :]) & \
        (rows[:, None] - rows[None, :] < window)
    k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    expected = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    err = (kernel(*views, True, window) - expected).abs().max().item()
    lib_err = (F.scaled_dot_product_attention(q, k_rep, v_rep,
                                              attn_mask=band)
               - expected).abs().max().item()
    check(err <= TOL["float32"] and lib_err <= TOL["float32"],
          f"flash_attention at the learner's shape: max_abs_err {err}, "
          f"the library call's {lib_err}")
    bound, bound_by, bound_tc = flash_bound(b, h, kv, s, s, d, True, window,
                                            4)
    timed = {"shape": {"b": b, "h": h, "kv": kv, "sq": s, "sk": s, "d": d,
                       "causal": True, "window": window, "dtype": "float32",
                       "layout": "model (b, s, heads, d) views"},
             "max_abs_err_timed": err, "bound_ms": bound,
             "bound_by": bound_by, "bound_tc_ms": bound_tc}
    calls = {
        "": lambda: kernel(*views, True, window),
        "plain_": lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                  window=window),
        "library_": lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, attn_mask=band),
    }
    for prefix, fn in calls.items():
        timed[f"{prefix}ms"] = time_ms(fn, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, graph=False)
    return timed


# ------------------------------------------------------------------ SSD scan
def ssd_inputs(b, s, h, p, n, rng, model_like=False):
    """The sweep's inputs (dt in 0.01..0.4, A in -0.5..-3), or, with
    ``model_like``, Zamba2's: dt = softplus(N(0, 1) + dt_bias) with the
    init's dt_bias, A = -(1..h)."""
    import torch
    x = rng.randn(b, s, h, p)
    if model_like:
        bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                  h))))
        dt = np.logaddexp(rng.randn(b, s, h) + bias, 0.0)
        A = -np.arange(1, h + 1, dtype=np.float64)
    else:
        dt = np.abs(rng.randn(b, s, h)) * 0.1 + 0.01
        A = -(np.abs(rng.randn(h)) + 0.5)
    arrays = (x, dt, A, rng.randn(b, s, n), rng.randn(b, s, n))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device="cuda")
                 for a in arrays)


def ssd_bound(b, s, h, p, n, chunk):
    """Least time (ms): x, dt, B, C read once, y and the final state
    written once.  Multiply-adds per chunk: C.B^T over the kept (i, j)
    pairs once per batch row (B and C are shared by the heads), then per
    head M.x over the pairs, C.state and the state update (Q n p each)."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * n + h
                  + b * h * n * p)
    flops = 2 * b * nc * (pairs * n + h * (pairs * p + 2 * chunk * n * p))
    return bounds(nbytes, flops)


def ssd_errors(kernel, ref, inputs, chunk, h0=None):
    """(scaled error of y, of the final state, absolute error of y)."""
    y, final = kernel(*inputs, chunk, h0)
    y_ref, final_ref = ref.ssd_scan_ref(*inputs, chunk, h0=h0)

    def scaled(a, e):
        return ((a - e).abs().max() / (e.abs().max() + 1.0)).item()
    return scaled(y, y_ref), scaled(final, final_ref), \
        (y - y_ref).abs().max().item(), (y, final)


def check_ssd(kernel, ref, torch, cfg):
    rng = np.random.RandomState(SEED + 7)
    s_cfg = cfg.ssm
    path = ("zamba2_path", ZAMBA_BATCH, ZAMBA_SEQ,
            s_cfg.num_heads(cfg.d_model), s_cfg.head_dim, s_cfg.d_state,
            s_cfg.chunk_size)
    worst = 0.0
    for label, b, s, h, p, n, chunk in SSD_CASES + [path]:
        on_path = label == "zamba2_path"
        inputs = ssd_inputs(b, s, h, p, n, rng, model_like=on_path)
        h0s = [None] if on_path else [
            None, torch.as_tensor(rng.randn(b, h, n, p), dtype=torch.float32,
                                  device="cuda")]
        for h0 in h0s:
            err_y, err_state, _, (y, final) = ssd_errors(kernel, ref, inputs,
                                                         chunk, h0)
            torch.cuda.synchronize()
            check(y.shape == (b, s, h, p) and final.shape == (b, h, n, p)
                  and bool(torch.isfinite(y).all())
                  and bool(torch.isfinite(final).all()),
                  f"ssd_scan {label}: bad output")
            tol = SSD_PATH_TOL if on_path else SSD_TOL
            log(f"  ssd_scan {label:12s} b={b} s={s:<4d} h={h:<2d} p={p:<2d} "
                f"n={n:<3d} chunk={chunk:<3d} h0={h0 is not None:d} scaled "
                f"err y={err_y:.3e} state={err_state:.3e} (tol {tol})")
            check(max(err_y, err_state) <= tol, f"ssd_scan {label}: scaled "
                  f"error {max(err_y, err_state)} > {tol}")
            worst = max(worst, err_y, err_state)
    for label, b, s, h, p, n, chunk in SSD_CHUNKINGS:
        inputs = ssd_inputs(b, s, h, p, n, rng)
        for h0 in (None, torch.as_tensor(rng.randn(b, h, n, p),
                                         dtype=torch.float32,
                                         device="cuda")):
            err_y, err_state, _, _ = ssd_errors(kernel, ref, inputs, chunk,
                                                h0)
            log(f"  ssd_scan {label:12s} b={b} s={s:<4d} h={h:<2d} p={p:<3d} "
                f"n={n:<3d} chunk={chunk:<3d} h0={h0 is not None:d} scaled "
                f"err y={err_y:.3e} state={err_state:.3e} (tol {SSD_TOL})")
            check(max(err_y, err_state) <= SSD_TOL, f"ssd_scan {label}: "
                  f"scaled error {max(err_y, err_state)} > {SSD_TOL}")
            worst = max(worst, err_y, err_state)
    # a second call at another shape, on scratch the allocator hands back,
    # matches the plain version; the first call repeats exactly
    big = ssd_inputs(2, 1024, 8, 64, 64, rng)
    first = kernel(*big, 256)
    torch.cuda.synchronize()
    small = ssd_inputs(1, 300, 3, 16, 24, rng)
    h0 = torch.as_tensor(rng.randn(1, 3, 24, 16), dtype=torch.float32,
                         device="cuda")
    err_y, err_state, _, _ = ssd_errors(kernel, ref, small, 100, h0)
    again = kernel(*big, 256)
    check(max(err_y, err_state) <= SSD_TOL
          and all(torch.equal(a, f) for a, f in zip(again, first)),
          f"ssd_scan: a second call read stale scratch ({err_y}, "
          f"{err_state}) or the first call did not repeat")
    log(f"  ssd_scan second call at another shape: scaled err y="
        f"{err_y:.3e} state={err_state:.3e}; the first call repeats exactly")
    return max(worst, err_y, err_state)


def device_kernels(torch, fn):
    """The device kernels that one call of ``fn`` launches, in order, with
    their device times in ms, from torch.profiler's trace of the call
    (copies and fills are not kernels); None if the profiler recorded no
    device activity.  A session can miss its first launches, so the
    traced call follows a warm-up call and a marker kernel
    (``torch.cuda._sleep``'s ``spin_kernel``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    if not marks:
        return None
    return [(e.name, e.device_time_total / 1e3)
            for e in events[marks[-1] + 1:]
            if not e.name.startswith(("Memcpy", "Memset"))]


def time_ssd(kernel, ref, torch, cfg):
    """At the shape of one Mamba2 layer of the scoring path: the kernel and
    its plain version; no single PyTorch call computes the SSD scan, so
    there is no library yardstick.  One call must launch the design's four
    CUDA kernels once each, in order, and nothing else."""
    s_cfg = cfg.ssm
    b, s, h, p, n, chunk = (ZAMBA_BATCH, ZAMBA_SEQ,
                            s_cfg.num_heads(cfg.d_model), s_cfg.head_dim,
                            s_cfg.d_state, s_cfg.chunk_size)
    inputs = ssd_inputs(b, s, h, p, n, np.random.RandomState(SEED + 8),
                        model_like=True)
    err_y, err_state, abs_err, _ = ssd_errors(kernel, ref, inputs, chunk)
    bound, bound_by, bound_tc = ssd_bound(b, s, h, p, n, chunk)
    timed = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n,
                       "chunk": chunk, "dtype": "float32"},
             "max_abs_err_timed": abs_err,
             "max_scaled_err_timed": max(err_y, err_state),
             "bound_ms": bound, "bound_by": bound_by,
             "bound_tc_ms": bound_tc, "library_ms": None}
    calls = {"": lambda: kernel(*inputs, chunk),
             "plain_": lambda: ref.ssd_scan_ref(*inputs, chunk)}
    launched = device_kernels(torch, calls[""])
    if launched is None:
        log("  ssd_scan: the profiler recorded no device activity; CUDA "
            "launches per call not measured")
        timed["cuda_launches_per_call"] = None
    else:
        names = [name for name, _ in launched]
        stages = ("scores", "states", "pass", "output")
        check(len(names) == len(stages)
              and all(f"ssd_{stage}_kernel" in name
                      for name, stage in zip(names, stages)),
              f"ssd_scan: one call launched {names}, not the design's four "
              f"kernels in order")
        timed["cuda_launches_per_call"] = len(launched)
        timed["device_ms_by_kernel"] = {
            f"ssd_{stage}_kernel": ms
            for stage, (_, ms) in zip(stages, launched)}
    for prefix, fn in calls.items():
        timed[f"{prefix}ms"] = time_ms(fn, warmup=3, launches=20, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, warmup=3, launches=20,
                                             graph=False)
    return timed


# ------------------------------------------------------------ engine parity
def engine_parity(torch, policy_cfg):
    from repro_torch.policies import PolicyEngine, network
    from repro_torch.policies.actors import _WindowBuffer

    arch = network.make_arch(policy_cfg, NUM_ACTIONS)
    params = network.init(torch.Generator().manual_seed(SEED), arch,
                          int(np.prod(OBS_SHAPE)), NUM_ACTIONS, device="cuda")
    engines = [PolicyEngine(arch, OBS_SHAPE, NUM_ACTIONS, num_slots=8,
                            epsilon=0.0, backend=backend, device="cuda")
               for backend in ("kernel", "ref")]
    rng = np.random.RandomState(SEED + 2)
    window = policy_cfg.window
    bufs = [_WindowBuffer(window, OBS_SHAPE) for _ in range(8)]
    keys = [f"row{i}" for i in range(8)]
    worst = 0.0
    for t in range(3 * window):
        if t == 5:
            bufs[1].reset()
            bufs[3].reset()
        if t == 13:
            bufs[6].reset()
        if t == 10:
            for engine in engines:
                engine.pool.invalidate_all()
        for buf in bufs:
            buf.push((rng.rand(*OBS_SHAPE) < 0.2).astype(np.float32))
        windows = np.stack([buf.window_array() for buf in bufs])
        positions = [buf.t for buf in bufs]
        (a0, q0), (a1, q1) = (e.select_with_q(params, keys, windows,
                                              positions) for e in engines)
        check(np.array_equal(a0, a1), f"engine parity: actions differ at "
              f"step {t}: {a0} vs {a1}")
        worst = max(worst, float(np.abs(q0 - q1).max()))
        check(worst <= 1e-4, f"engine parity: Q differs by {worst} at {t}")
    stats = engines[0].stats()
    check(stats["decode_rows"] > 0 and stats["stale_reprefills"] > 0,
          f"engine parity: paths not exercised {stats}")
    log(f"  engine parity: {3 * window} steps x 8 rows, actions equal, "
        f"max |dQ| = {worst:.3e}, decode_rows={stats['decode_rows']}, "
        f"prefill_rows={stats['prefill_rows']}")
    return worst


# --------------------------------------------------------------- main path
def serving_path(torch, policy_cfg, kernels):
    from repro_torch.core import EnvironmentLoop, VariableSource
    from repro_torch.envs import Catch
    from repro_torch.policies import (TransformerInferenceServer,
                                      TransformerPolicy, network)
    from repro_torch.policies.actors import WindowedInferenceClientActor
    from repro_torch.telemetry import registry as telemetry

    arch = network.make_arch(policy_cfg, NUM_ACTIONS)
    params = network.init(torch.Generator().manual_seed(SEED), arch,
                          int(np.prod(OBS_SHAPE)), NUM_ACTIONS, device="cuda")

    class StaticSource(VariableSource):
        def get_variables(self, names=()):
            return [params for _ in names]

    telemetry.configure(enabled=True, node="chip_smoke")
    policy = TransformerPolicy(arch, OBS_SHAPE, NUM_ACTIONS,
                               epsilon=policy_cfg.epsilon,
                               backend=policy_cfg.backend,
                               cache_slots=policy_cfg.cache_slots,
                               slot_timeout_s=policy_cfg.slot_timeout_s)
    engine = policy.make_engine(num_slots=policy_cfg.cache_slots)
    server = TransformerInferenceServer(engine, StaticSource(),
                                        max_batch_size=64, max_wait_ms=2)
    results, errors = [], []

    def client(i):
        try:
            loop = EnvironmentLoop(Catch(seed=i),
                                   WindowedInferenceClientActor(server))
            results.extend(loop.run(num_episodes=EPISODES))
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(CLIENTS)]
    try:
        for kernel in kernels:
            kernel["wrapper"].launches = 0
        t0 = time.monotonic()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=600)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
    finally:
        server.stop()
        snap = telemetry.snapshot()
        telemetry.unconfigure()
    check(not any(thread.is_alive() for thread in threads),
          "main path: a client did not finish")
    if errors:
        raise errors[0]
    stats = server.stats()
    returns = [r["episode_return"] for r in results]
    steps = sum(r["episode_length"] for r in results)
    decode_ms = snap.get("inference/engine/decode_ms", {})
    log(f"  episodes={len(returns)} mean_return={np.mean(returns):.3f} "
        f"env_steps={steps} seconds={seconds:.3f} "
        f"steps_per_s={steps / seconds:.1f}")
    log(f"  batches={stats['batches']} avg_rows_per_batch="
        f"{stats['avg_rows_per_batch']:.3f} decode_batches="
        f"{stats['decode_batches']} decode_rows={stats['decode_rows']} "
        f"prefill_batches={stats['prefill_batches']} prefill_rows="
        f"{stats['prefill_rows']} launches={launches}")
    log(f"  decode batch host time (ms): p50={decode_ms.get('p50', 0):.3f} "
        f"p95={decode_ms.get('p95', 0):.3f} count={decode_ms.get('count')}")
    check(len(returns) == CLIENTS * EPISODES,
          f"main path: {len(returns)} episodes, expected "
          f"{CLIENTS * EPISODES}")
    check(all(r in (-1.0, 1.0) for r in returns),
          f"main path: returns not +-1: {sorted(set(returns))}")
    check(stats["decode_rows"] > 0, "main path: no decode rows")
    check(stats["prefill_rows"] >= CLIENTS, "main path: too few prefills")
    check(stats["avg_rows_per_batch"] > 1, "main path: no batching")
    check(launches["decode_attention"]
          == stats["decode_batches"] * arch.num_layers,
          f"main path: decode_attention launched "
          f"{launches['decode_attention']} times, expected "
          f"{stats['decode_batches']} x {arch.num_layers}")
    check(launches["decode_attention"] > 0,
          "main path: kernel decode_attention never launched")
    return {"launches": launches, "stats": stats, "steps_per_s":
            steps / seconds, "decode_ms_p50": decode_ms.get("p50")}


# ------------------------------------------------------------------- IMPALA
def impala_path(torch, kernels):
    from repro_torch import tree
    from repro_torch.agents import make_agent
    from repro_torch.agents.impala import IMPALABuilder, IMPALAConfig
    from repro_torch.core import (VectorizedEnvironmentLoop,
                                  make_environment_spec)
    from repro_torch.envs import Catch, VectorEnv
    from repro_torch.telemetry import registry as telemetry

    env = VectorEnv(lambda seed: Catch(seed=seed), IMPALA_ENVS, seed=SEED)
    agent = make_agent(IMPALABuilder(make_environment_spec(env),
                                     IMPALAConfig(), seed=SEED),
                       num_envs=IMPALA_ENVS, telemetry=True)
    loop = VectorizedEnvironmentLoop(env, agent)
    try:
        for kernel in kernels:
            kernel["wrapper"].launches = 0
        t0 = time.monotonic()
        results = loop.run(num_episodes=IMPALA_EPISODES)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
        snap = telemetry.snapshot()
    finally:
        telemetry.unconfigure()
    learner = agent.learner
    steps = int(learner.state.steps)
    env_steps = sum(r["episode_length"] for r in results)
    step_ms = snap.get("learner/step_ms", {})
    metrics = learner.metrics
    log(f"  episodes={len(results)} env_steps={env_steps} "
        f"seconds={seconds:.3f} env_steps_per_s={env_steps / seconds:.1f} "
        f"learner_steps={steps} learner_steps_per_s={steps / seconds:.2f} "
        f"learner_walltime_s={learner.learner_walltime:.3f}")
    log(f"  learner step host time (ms): p50={step_ms.get('p50', 0):.3f} "
        f"p95={step_ms.get('p95', 0):.3f} count={step_ms.get('count')} "
        f"launches={launches} last metrics={json.dumps(metrics)}")
    check(len(results) >= IMPALA_EPISODES, "IMPALA path: too few episodes")
    check(steps >= IMPALA_MIN_LEARNER_STEPS,
          f"IMPALA path: {steps} learner steps < {IMPALA_MIN_LEARNER_STEPS}")
    check(launches["vtrace"] == steps, f"IMPALA path: vtrace launched "
          f"{launches['vtrace']} times for {steps} learner steps")
    check(step_ms.get("count") == steps,
          f"IMPALA path: {step_ms.get('count')} step times for {steps}")
    check(all(math.isfinite(v) for v in metrics.values()),
          f"IMPALA path: non-finite metrics {metrics}")
    check(all(bool(torch.isfinite(x).all()) for x in
              tree.leaves(learner.state.params)),
          "IMPALA path: non-finite params")
    return {"launches": launches, "learner_steps": steps,
            "env_steps_per_s": env_steps / seconds,
            "learner_steps_per_s": steps / seconds,
            "learner_step_ms_p50": step_ms.get("p50"),
            "learner_step_ms_p95": step_ms.get("p95")}


def impala_batch(cfg, seed):
    """A (B, T) batch as the FIFO queue serves it: Catch-like boards,
    episode ends and zero-padded tails."""
    from repro_torch.replay import ReplaySample, SampleInfo
    B, T = cfg.batch_size, cfg.sequence_length
    rng = np.random.RandomState(seed)
    obs = np.zeros((B, T, *OBS_SHAPE), np.float32)
    rows, cols = np.arange(B)[:, None], np.arange(T)[None]
    obs[rows, cols, rng.randint(0, 10, (B, T)), rng.randint(0, 5, (B, T))] = 1
    obs[rows, cols, 9, rng.randint(0, 5, (B, T))] = 1
    lengths = rng.randint(1, T + 1, B)
    mask = (cols < lengths[:, None]).astype(np.float32)
    discount = (rng.rand(B, T) > 0.1).astype(np.float32) * mask
    data = {"observation": obs * mask[..., None, None],
            "action": (rng.randint(0, NUM_ACTIONS, (B, T)) * mask
                       ).astype(np.int32),
            "reward": (rng.randint(-1, 2, (B, T)) * (discount == 0)
                       ).astype(np.float32),
            "discount": discount,
            "behavior_logits": (rng.randn(B, T, NUM_ACTIONS)
                                * mask[..., None]).astype(np.float32),
            "mask": mask}
    return ReplaySample(SampleInfo(np.arange(B), np.ones(B)), data)


def sync_count(torch, fn):
    """How many times ``fn()`` made the host wait for the device, as
    PyTorch's sync debug mode reports it."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA" in str(w.message) for w in caught)


def rel_error(a, b):
    """max |a - b| over max |b| (float64 on the host)."""
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / max(np.abs(b).max(), 1e-30))


def learner_parity(torch, vtrace_kernel):
    """Same params, same 10 batches: V-trace on the kernel vs on the plain
    version (the plain version swapped in for the second learner only)."""
    from unittest import mock

    from repro_torch import tree
    from repro_torch.agents import impala
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.kernels import ops, ref

    cfg = impala.IMPALAConfig()
    spec = make_environment_spec(Catch())
    batches = [impala_batch(cfg, SEED + i) for i in range(10)]
    learners = [impala.make_learner(spec, cfg, iter(batches),
                                    torch.Generator().manual_seed(SEED),
                                    device="cuda") for _ in range(2)]
    before = vtrace_kernel.launches
    syncs = []
    for _ in batches:
        syncs.append(sync_count(torch, learners[0].step))
        with mock.patch.object(ops, "vtrace", ref.vtrace_ref):
            learners[1].step()
    check(vtrace_kernel.launches - before == len(batches),
          "learner parity: the kernel learner did not launch V-trace once "
          "per step, or the plain learner launched it")
    log(f"  device syncs per learner step: {syncs}")
    check(all(n == 1 for n in syncs), f"learner parity: a step synced "
          f"{syncs} times; its metrics copy should be its only sync")
    kernel_state, plain_state = (lr.state for lr in learners)
    worst = {}
    for name, a, b in (
            ("params", kernel_state.params, plain_state.params),
            ("mu", kernel_state.opt_state.mu, plain_state.opt_state.mu),
            ("nu", kernel_state.opt_state.nu, plain_state.opt_state.nu)):
        worst[name] = max((x - y).abs().max().item() for x, y in
                          zip(tree.leaves(a), tree.leaves(b)))
    log(f"  learner parity over {len(batches)} steps: max |d| {worst}; "
        f"loss {learners[0].metrics['loss']:.6f} vs "
        f"{learners[1].metrics['loss']:.6f}")
    check(max(worst.values()) <= LEARNER_TOL,
          f"learner parity: {worst} > {LEARNER_TOL}")
    check(int(kernel_state.opt_state.step) == len(batches),
          "learner parity: Adam step count")
    return worst


def learning(torch, vtrace_kernel):
    from repro_torch.agents import make_agent
    from repro_torch.agents.impala import IMPALABuilder, IMPALAConfig
    from repro_torch.core import EnvironmentLoop, make_environment_spec
    from repro_torch.envs import Catch

    env = Catch(seed=2)
    cfg = IMPALAConfig(sequence_length=5, batch_size=4, learning_rate=3e-3,
                       entropy_cost=0.02)
    agent = make_agent(IMPALABuilder(make_environment_spec(env), cfg, seed=1))
    loop = EnvironmentLoop(env, agent)
    before = vtrace_kernel.launches
    t0 = time.monotonic()
    rets = [loop.run_episode()["episode_return"] for _ in range(600)]
    seconds = time.monotonic() - t0
    steps = int(agent.learner.state.steps)
    first, last = float(np.mean(rets[:50])), float(np.mean(rets[-50:]))
    log(f"  600 episodes in {seconds:.2f} s, learner_steps={steps}, "
        f"vtrace launches={vtrace_kernel.launches - before}; mean return "
        f"first 50 {first:.3f}, last 50 {last:.3f}")
    check(vtrace_kernel.launches - before == steps > 0,
          "learning: V-trace not launched once per learner step")
    check(last > first + 0.3, f"learning: last 50 mean {last} does not "
          f"beat first 50 mean {first} by 0.3")
    return {"first50": first, "last50": last, "learner_steps": steps}


# ------------------------------------------------------- Zamba2 scoring
def zamba2_batches(cfg):
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_SEQ))
            for _ in range(ZAMBA_BATCHES)]


def profile_step(torch, step, params, tokens):
    """Device time by kernel over one scoring step, from torch.profiler,
    and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # device-side entries (kernels, copies); an operator's own entry
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    if device_ms == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    log(f"  profile of one step: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                    for e in top]}


def zamba2_path(torch, kernels, cfg):
    """make_prefill_step over the full model: one unmeasured step first
    (cuBLAS plans, the allocator's pool), then the counted run of
    ZAMBA_BATCHES batches, then more steps over the same batches in turn,
    ZAMBA_TIMED_STEPS timed steps in all, for the step-time distribution."""
    batches, batch, seq = ZAMBA_BATCHES, ZAMBA_BATCH, ZAMBA_SEQ
    from repro_torch import tree
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    t0 = time.monotonic()
    params = transformer.init(torch.Generator().manual_seed(SEED), cfg,
                              device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    sites = cfg.num_layers // cfg.hybrid_attn_every
    log(f"  {cfg.name}: {n_params} parameters (float32) initialized from "
        f"seed {SEED} in {init_s:.2f} s; {cfg.num_layers} Mamba2 layers, "
        f"{sites} shared-attention sites")
    step = make_prefill_step(cfg)
    tokens = zamba2_batches(cfg)
    step(params, {"tokens": tokens[0]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kernel in kernels:
        kernel["wrapper"].launches = 0
    times, outs = [], []
    for i in range(ZAMBA_TIMED_STEPS):
        t0 = time.monotonic()
        out = step(params, {"tokens": tokens[i % batches]})
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
        if i < batches:
            outs.append(out)
        if i == batches - 1:
            launches = {k["name"]: k["wrapper"].launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()

    steps = len(times)
    seconds = sum(times) / 1e3
    p50 = float(np.percentile(times, 50))
    p95 = float(np.percentile(times, 95))
    log(f"  {batches} counted batches of {batch} requests x {seq} tokens, "
        f"launches={launches}; {steps} timed steps in {seconds:.3f} s: "
        f"{steps * batch / seconds:.3f} requests/s, "
        f"{steps * batch * seq / seconds:.1f} tokens/s; step ms min="
        f"{min(times):.3f} p50={p50:.3f} p95={p95:.3f} max={max(times):.3f}"
        f"; peak device memory {peak / 2 ** 30:.3f} GiB")
    check(launches["flash_attention"] == sites * batches,
          f"scoring path: flash_attention launched "
          f"{launches['flash_attention']} times, expected {sites} x "
          f"{batches}")
    check(launches["ssd_scan"] == cfg.num_layers * batches,
          f"scoring path: ssd_scan launched {launches['ssd_scan']} times, "
          f"expected {cfg.num_layers} x {batches}")
    check(launches["decode_attention"] == launches["vtrace"] == 0,
          f"scoring path launched another slice's kernel: {launches}")
    for out in outs:
        actions, logits = out["actions"], out["last_logits"]
        check(actions.shape == (batch, seq) and actions.dtype == torch.int32,
              f"scoring path: actions {tuple(actions.shape)} {actions.dtype}")
        check(int(actions.min()) >= 0
              and int(actions.max()) < cfg.vocab_size,
              "scoring path: an action outside the vocabulary")
        check(logits.shape == (batch, cfg.padded_vocab_size)
              and bool(torch.isfinite(logits).all()),
              "scoring path: bad last_logits")
    profile = profile_step(torch, step, params, tokens[0])
    return {"launches": launches, "params": params, "step": step,
            "tokens": tokens, "outs": outs, "init_s": init_s,
            "n_params": n_params, "step_ms": times, "step_ms_p50": p50,
            "step_ms_p95": p95, "requests_per_s": steps * batch / seconds,
            "tokens_per_s": steps * batch * seq / seconds,
            "peak_bytes": peak, "profile": profile}


def plain_scoring(torch, step, params, tokens):
    """The step with flash attention and the SSD scan on their plain
    versions; also returns the features, for the top-2 margins."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer

    captured = {}
    features = transformer.forward_features

    def capture(*args, **kwargs):
        captured["feats"] = features(*args, **kwargs)[0]
        return captured["feats"], {}

    with mock.patch.object(ops, "flash_attention",
                           ref.flash_attention_ref), \
            mock.patch.object(ops, "ssd_scan", ref.ssd_scan_ref), \
            mock.patch.object(transformer, "forward_features", capture):
        out = step(params, {"tokens": tokens})
    return out, captured["feats"]


def compare_scoring(torch, cfg, params, out, plain, plain_feats, rel_tol,
                    what):
    """Last logits within tol = ``rel_tol`` x the largest plain |logit| (of
    the real vocabulary); greedy actions equal wherever the plain route's
    top-2 margin exceeds 2 tol.  Returns the max |d|, tol and counts."""
    from repro_torch.models import layers, transformer

    tol = rel_tol * plain["last_logits"][:, :cfg.vocab_size].abs().max(
        ).item()
    err = (out["last_logits"].float().cpu()
           - plain["last_logits"].float().cpu()).abs().max().item()
    check(err <= tol, f"{what}: last_logits differ by {err} > {tol}")
    table = transformer.unembed_table(params, cfg).to(plain_feats.device)
    margins = []
    for i in range(0, plain_feats.shape[1], 1024):
        logits = transformer.mask_pad_logits(
            layers.unembed(table, plain_feats[:, i:i + 1024]), cfg)
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.append(top2[..., 0] - top2[..., 1])
    margins = torch.cat(margins, dim=1).cpu()
    decided = margins > 2 * tol
    same = out["actions"].cpu() == plain["actions"].cpu()
    check(bool(same[decided].all()), f"{what}: greedy actions differ at "
          f"{int((~same & decided).sum())} positions with a plain top-2 "
          f"margin above {2 * tol}")
    return {"max_abs_err": err, "tol": tol, "positions": same.numel(),
            "decided": int(decided.sum()), "equal": int(same.sum())}


def zamba2_parity(torch, cfg, path):
    """The first batch on the plain route at full size, and a reduced
    Zamba2 with a tail on the card's kernels against the CPU's plain
    versions with the same weights."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    plain, feats = plain_scoring(torch, path["step"], path["params"],
                                 path["tokens"][0])
    full = compare_scoring(torch, cfg, path["params"], path["outs"][0],
                           plain, feats, ZAMBA_LOGIT_REL_TOL,
                           "scoring parity")
    log(f"  full size, first batch: max |d last_logits| = "
        f"{full['max_abs_err']:.3e} (tol {full['tol']:.3e} = "
        f"{ZAMBA_LOGIT_REL_TOL} x max |logit|); actions equal at "
        f"{full['equal']} of "
        f"{full['positions']} positions, {full['decided']} of them with a "
        f"top-2 margin above 2 tol, all of which agree")

    small = dataclasses.replace(configs.reduced(cfg), num_layers=3,
                                hybrid_attn_every=2)
    params = transformer.init(torch.Generator().manual_seed(SEED), small,
                              device="cpu")
    params_card = tree.map(lambda t: t.to("cuda"), params)
    tokens = np.random.RandomState(SEED).randint(0, small.vocab_size,
                                                 (2, 64))
    step = make_prefill_step(small)
    out = step(params_card, {"tokens": tokens})
    cpu, cpu_feats = plain_scoring(torch, step, params, tokens)
    reduced = compare_scoring(torch, small, params, out, cpu, cpu_feats,
                              REDUCED_TOL, "reduced parity")
    log(f"  reduced Zamba2 (3 Mamba2 layers in a group of 2 and a tail, "
        f"d_model {small.d_model}), card kernels vs CPU plain route: max "
        f"|d last_logits| = {reduced['max_abs_err']:.3e} (tol "
        f"{reduced['tol']:.3e} = {REDUCED_TOL} x max |logit|); actions "
        f"equal at {reduced['equal']} of {reduced['positions']}, "
        f"{reduced['decided']} with a top-2 margin above 2 tol")
    return full, reduced


# ------------------------------------------------------------- DQN on Catch
def dqn_quickstart_config(num_episodes=DQN_EPISODES, eval_every=50,
                          eval_episodes=20):
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.envs import Catch
    from repro_torch.experiments import ExperimentConfig
    return ExperimentConfig(
        builder_factory=lambda spec: DQNBuilder(
            spec, DQNConfig(**DQN_QUICKSTART), seed=0, device="cuda"),
        environment_factory=lambda seed: Catch(seed=seed),
        seed=1, num_episodes=num_episodes, eval_every=eval_every,
        eval_episodes=eval_episodes, telemetry=True)


def dqn_profile(torch):
    """A short run of the same config under torch.profiler: the device's
    busy time against the run's wall time, and the kernels it ran most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.experiments import run_experiment
    from repro_torch.telemetry import registry as telemetry
    config = dqn_quickstart_config(num_episodes=DQN_PROFILED_EPISODES,
                                   eval_every=0, eval_episodes=0)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            result = run_experiment(config)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        telemetry.unconfigure()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log(f"  profiled run of {DQN_PROFILED_EPISODES} episodes "
        f"({result.learner_steps} learner steps, under the profiler): wall "
        f"{wall_ms:.1f} ms, device busy {device_ms:.1f} ms, idle share "
        f"{1 - device_ms / wall_ms:.4f}")
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "learner_steps": result.learner_steps}


def dqn_path(torch, kernels):
    """run_experiment with the quickstart's DQN config on the card (seed 1,
    250 episodes, an eval every 50), held to the quickstart's acceptance
    and to scripts/ci.sh's; this path runs none of the four kernels, so
    every count must stay 0."""
    from repro_torch import tree
    from repro_torch.experiments import run_experiment
    from repro_torch.telemetry import registry as telemetry

    config = dqn_quickstart_config()
    try:
        for kernel in kernels:
            kernel["wrapper"].launches = 0
        t0 = time.monotonic()
        result = run_experiment(config)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
    finally:
        telemetry.unconfigure()
    learner = result.learner
    env_steps = result.actor_steps[-1]
    step_ms = result.extras["telemetry"]["merged"].get("learner/step_ms", {})
    last50 = float(np.mean(result.train_returns[-50:]))
    first20 = float(np.mean(result.train_returns[:20]))
    final = result.final_eval_return
    log(f"  {len(result.train_returns)} episodes, {env_steps} env steps, "
        f"{result.learner_steps} learner steps in {seconds:.3f} s: "
        f"{env_steps / seconds:.1f} env steps/s, "
        f"{result.learner_steps / seconds:.1f} learner steps/s; learner "
        f"walltime {learner.learner_walltime:.3f} s")
    log(f"  learner step host time (ms): p50={step_ms.get('p50', 0):.3f} "
        f"p95={step_ms.get('p95', 0):.3f} count={step_ms.get('count')}; "
        f"launches={launches}")
    log(f"  evals {[(s, r) for s, r in result.eval_returns]}; train return "
        f"mean of the last 50 {last50:.3f}, of the first 20 {first20:.3f}")
    check(all(n == 0 for n in launches.values()),
          f"DQN path launched a kernel of another slice: {launches}")
    check(step_ms.get("count") == result.learner_steps > 0,
          f"DQN path: {step_ms.get('count')} step times for "
          f"{result.learner_steps} learner steps")
    check(all(t.device.type == "cuda"
              for t in tree.leaves(learner.state)),
          "DQN path: the learner's state is not on the card")
    check(all(bool(torch.isfinite(t).all())
              for t in tree.leaves(learner.state.params)),
          "DQN path: non-finite params")
    check(last50 > 0, f"DQN path (quickstart acceptance): the mean of the "
          f"last 50 train returns is {last50}, not > 0")
    check(final is not None and final > first20,
          f"DQN path (ci acceptance): final eval {final} does not beat the "
          f"mean of the first 20 train returns {first20}")
    return {"launches": launches, "episodes": len(result.train_returns),
            "env_steps": env_steps, "learner_steps": result.learner_steps,
            "seconds": seconds, "env_steps_per_s": env_steps / seconds,
            "learner_steps_per_s": result.learner_steps / seconds,
            "learner_walltime_s": learner.learner_walltime,
            "learner_step_ms_p50": step_ms.get("p50"),
            "learner_step_ms_p95": step_ms.get("p95"),
            "last50": last50, "first20": first20, "final_eval": final,
            "evals": result.eval_returns}


def dqn_batches(count):
    """Replay batches as the quickstart's table serves them: n-step-1
    Catch transitions (boards, actions, rewards at episode ends, discount
    0 there), keys and sampling probabilities."""
    from repro_torch.core.types import Transition
    from repro_torch.replay import ReplaySample, SampleInfo
    batch = DQN_QUICKSTART["batch_size"]
    rng = np.random.RandomState(SEED)
    rows = np.arange(batch)
    out = []
    for i in range(count):
        boards = []
        for _ in range(2):
            obs = np.zeros((batch, *OBS_SHAPE), np.float32)
            obs[rows, rng.randint(0, 9, batch), rng.randint(0, 5, batch)] = 1
            obs[rows, 9, rng.randint(0, 5, batch)] = 1
            boards.append(obs)
        ended = rng.rand(batch) < 0.12
        data = Transition(
            boards[0], rng.randint(0, NUM_ACTIONS, batch).astype(np.int32),
            np.where(ended, rng.choice([-1.0, 1.0], batch), 0.0
                     ).astype(np.float32),
            np.where(ended, 0.0, 1.0).astype(np.float32), boards[1], ())
        out.append(ReplaySample(SampleInfo(
            np.arange(batch, dtype=np.int64) + i * batch,
            rng.rand(batch) * 1e-3 + 1e-4), data))
    return out


def dqn_learner_parity(torch):
    """The quickstart's learner on the card and on the CPU, from the same
    init (a CPU generator) on the same 10 batches: losses, |td| priorities,
    params, target params and Adam moments within DQN_TOL of the CPU's
    largest magnitude per leaf; each card step syncs with the device once."""
    from repro_torch import tree
    from repro_torch.agents import dqn
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch

    cfg = dqn.DQNConfig(**DQN_QUICKSTART)
    spec = make_environment_spec(Catch())
    batches = dqn_batches(10)
    devices = {"card": "cuda", "cpu": "cpu"}
    priorities = {label: [] for label in devices}
    learners = {label: dqn.make_learner(
        spec, cfg, iter(batches), torch.Generator().manual_seed(SEED),
        priority_update_cb=lambda k, p, label=label:
        priorities[label].append(p), device=device)
        for label, device in devices.items()}
    syncs, losses = [], []
    for _ in batches:
        syncs.append(sync_count(torch, learners["card"].step))
        learners["cpu"].step()
        losses.append((learners["card"].metrics["loss"],
                       learners["cpu"].metrics["loss"]))
    log(f"  device syncs per card learner step: {syncs}")
    check(all(n == 1 for n in syncs), f"DQN learner parity: a card step "
          f"synced {syncs} times; its one host copy should be its only sync")

    card, cpu = learners["card"].state, learners["cpu"].state
    worst = {"loss": max(rel_error(a, b) for a, b in losses),
             "priorities": max(rel_error(a, b) for a, b in
                               zip(priorities["card"], priorities["cpu"]))}
    for name, a, b in (
            ("params", card.params, cpu.params),
            ("target_params", card.target_params, cpu.target_params),
            ("mu", card.opt_state.mu, cpu.opt_state.mu),
            ("nu", card.opt_state.nu, cpu.opt_state.nu)):
        worst[name] = max(rel_error(x.cpu().numpy(), y.numpy()) for x, y in
                          zip(tree.leaves(a), tree.leaves(b)))
    log(f"  card vs CPU over {len(batches)} steps, max |d| / max |cpu| "
        f"per leaf: {json.dumps(worst)}; last loss {losses[-1][0]:.8f} vs "
        f"{losses[-1][1]:.8f}")
    check(len(priorities["card"]) == len(batches),
          "DQN learner parity: priorities not sent once per step")
    check(max(worst.values()) <= DQN_TOL,
          f"DQN learner parity: {worst} > {DQN_TOL}")
    check(int(card.steps) == int(cpu.steps) == len(batches),
          "DQN learner parity: step counters")
    return {"syncs": syncs, "max_rel_err": worst}


def dqn_step_profile(torch, steps=DQN_PROFILED_STEPS):
    """Where the DQN path's time goes, on the card: a learner step (after
    10 warm-up steps) and an acting call (the behaviour policy on one
    observation, as ``FeedForwardActor`` makes it: upload, forward, draws,
    copy back), each timed on the host clock over ``steps`` calls, then
    traced by torch.profiler for the device kernels and copies a call
    launches and the device's busy time a call."""
    import itertools

    from repro_torch.agents import dqn
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch

    cfg = dqn.DQNConfig(**DQN_QUICKSTART)
    spec = make_environment_spec(Catch())
    learner = dqn.make_learner(
        spec, cfg, itertools.cycle(dqn_batches(10)),
        torch.Generator().manual_seed(SEED),
        priority_update_cb=lambda keys, priorities: None, device="cuda")
    policy = dqn.make_behavior_policy(spec, cfg)
    generator = torch.Generator(device="cuda")
    obs = np.zeros((1, *OBS_SHAPE), np.float32)

    def act():
        generator.manual_seed(SEED)
        policy(learner.state.params, generator,
               torch.as_tensor(obs, device="cuda")).cpu()

    return profile_calls(torch, {"learner_step": learner.step, "act": act},
                         steps)


def profile_calls(torch, calls, steps):
    """For each named call: its host ms (mean over ``steps`` calls after 10
    warm-up calls), then, traced by torch.profiler over ``steps`` more, the
    device kernels and copies a call launches and the device's busy ms a
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = [e for e in events
                  if e.name.startswith(("Memcpy", "Memset"))]
        busy_ms = sum(e.device_time_total for e in events) / 1e3 / steps
        out[name] = {"host_ms": host_ms,
                     "kernels": (len(events) - len(copies)) / steps,
                     "copies": len(copies) / steps,
                     "device_busy_ms": busy_ms}
        log(f"  {name}: {host_ms:.3f} ms a call on the host clock; per "
            f"call {out[name]['kernels']:.1f} device kernels and "
            f"{out[name]['copies']:.1f} copies, device busy {busy_ms:.4f} "
            f"ms ({steps} traced calls)")
    return out


# ------------------------------------------- gradients through the kernels
def param_grads(torch, params, loss_fn):
    """Every leaf's gradient of ``loss_fn(params)`` (autograd.grad raises
    if a leaf gets none)."""
    from repro_torch import tree
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    grads = torch.autograd.grad(loss_fn(tree.unflatten(treedef, leaves)),
                                leaves)
    check(all(g is not None for g in grads), "a parameter got no gradient")
    return grads


def grad_errors(torch, grads, plain, what):
    """Max over leaves of max |d| / (max |plain| + 1e-30), checked against
    GRAD_TOL; every gradient finite."""
    worst = 0.0
    for g, p in zip(grads, plain):
        check(bool(torch.isfinite(g).all()), f"{what}: a non-finite grad")
        worst = max(worst, ((g - p).abs().max()
                            / (p.abs().max() + 1e-30)).item())
    check(worst <= GRAD_TOL, f"{what}: grads differ from the plain route's "
          f"by {worst} of their largest magnitude > {GRAD_TOL}")
    return worst


def plain_route():
    """ops.flash_attention and ops.ssd_scan patched to their plain
    versions (the gradients' reference)."""
    from unittest import mock

    from repro_torch.kernels import ops, ref

    def ssd(x, dt, A, B, C, *, chunk=256, h0=None):
        return ref.ssd_scan_ref(x, dt, A, B, C, chunk, h0=h0)
    return (mock.patch.object(ops, "flash_attention",
                              ref.flash_attention_ref),
            mock.patch.object(ops, "ssd_scan", ssd))


def time_backward(torch, fn, inputs, repeats=3):
    """Eager ms of the forward with grad on, of its backward, and of the
    plain route's forward + backward (CUDA events, median of ``repeats``
    after one warm-up)."""
    outs = fn(*inputs)
    weights = [torch.randn_like(o) for o in
               (outs if isinstance(outs, tuple) else (outs,))]
    del outs

    def run(times):
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        mid.record()
        torch.autograd.grad(outs, inputs, weights)
        end.record()
        end.synchronize()
        times.append((start.elapsed_time(mid), mid.elapsed_time(end)))

    warm = []
    run(warm)
    times = []
    for _ in range(repeats):
        run(times)
    return (statistics.median(t[0] for t in times),
            statistics.median(t[1] for t in times))


def kernel_grads(torch, kernels, zamba):
    """Phase 13: the grads of a q_sequence loss over the fig17 serving
    policy's params, and of a reduced Zamba2's logits loss, with flash
    attention and the SSD scan on their kernels (the autograd Functions:
    kernel forward, plain-recompute backward) against the same calls on
    the plain route; then the backward's time beside the forward kernel's
    at the scoring path's shapes."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers, transformer
    from repro_torch.policies import TransformerPolicyConfig, network

    out = {}
    cfg = TransformerPolicyConfig(**POLICY, epsilon=0.0)
    arch = network.make_arch(cfg, NUM_ACTIONS)
    obs_dim = int(np.prod(OBS_SHAPE))
    params = network.init(torch.Generator().manual_seed(SEED), arch, obs_dim,
                          NUM_ACTIONS, device="cuda")
    rng = np.random.RandomState(SEED + 13)
    obs = torch.as_tensor(rng.rand(GRAD_POLICY_BATCH, POLICY["window"],
                                   obs_dim) < 0.04,
                          dtype=torch.float32, device="cuda")
    weights = torch.as_tensor(rng.randn(GRAD_POLICY_BATCH, POLICY["window"],
                                        NUM_ACTIONS),
                              dtype=torch.float32, device="cuda")

    def policy_loss(p):
        return (network.q_sequence(p, arch, obs) * weights).sum()

    for kernel in kernels:
        kernel["wrapper"].launches = 0
    grads = param_grads(torch, params, policy_loss)
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    flash_route, ssd_route = plain_route()
    with flash_route:
        plain = param_grads(torch, params, policy_loss)
    err = grad_errors(torch, grads, plain, "q_sequence grads")
    log(f"  q_sequence (fig17 policy, {GRAD_POLICY_BATCH} windows of "
        f"{POLICY['window']}): {len(grads)} leaves, launches {launches}; "
        f"max |d grad| / max |plain grad| = {err:.3e} (tol {GRAD_TOL})")
    check(launches["flash_attention"] == arch.num_layers
          and launches["ssd_scan"] == 0,
          f"q_sequence grads: launches {launches}, expected flash "
          f"attention once per layer ({arch.num_layers})")
    out["q_sequence"] = {"leaves": len(grads), "launches": launches,
                         "max_rel_err": err}

    small = dataclasses.replace(configs.reduced(zamba), **GRAD_ZAMBA)
    params = transformer.init(torch.Generator().manual_seed(SEED), small,
                              device="cuda")
    tokens = rng.randint(0, small.vocab_size, GRAD_ZAMBA_TOKENS)
    weights = torch.as_tensor(
        rng.randn(*GRAD_ZAMBA_TOKENS, small.padded_vocab_size),
        dtype=torch.float32, device="cuda")

    def zamba_loss(p):
        feats, _ = transformer.forward_features(p, small, {"tokens": tokens})
        logits = layers.unembed(transformer.unembed_table(p, small), feats)
        return (logits * weights).sum()

    for kernel in kernels:
        kernel["wrapper"].launches = 0
    grads = param_grads(torch, params, zamba_loss)
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in kernels}
    with flash_route, ssd_route:
        plain = param_grads(torch, params, zamba_loss)
    err = grad_errors(torch, grads, plain, "reduced Zamba2 grads")
    sites = small.num_layers // small.hybrid_attn_every
    log(f"  reduced Zamba2 ({small.num_layers} Mamba2 layers, {sites} "
        f"shared-attention sites, d_model {small.d_model}, "
        f"{GRAD_ZAMBA_TOKENS[0]} x {GRAD_ZAMBA_TOKENS[1]} tokens, f32): "
        f"{len(grads)} leaves, launches {launches}; max |d grad| / max "
        f"|plain grad| = {err:.3e} (tol {GRAD_TOL})")
    check(launches["flash_attention"] == sites
          and launches["ssd_scan"] == small.num_layers,
          f"reduced Zamba2 grads: launches {launches}, expected flash "
          f"attention {sites} and the SSD scan {small.num_layers}")
    out["zamba2_reduced"] = {"leaves": len(grads), "launches": launches,
                             "max_rel_err": err}

    # the backward's cost at the scoring path's shapes
    b, h, kv, s, d = (ZAMBA_BATCH, zamba.num_heads, zamba.num_kv_heads,
                      ZAMBA_SEQ, zamba.head_dim)
    window = zamba.sliding_window
    qkv = [t.requires_grad_() for t in flash_inputs(
        b, h, kv, s, s, d, torch.float32, np.random.RandomState(SEED + 6))]
    fwd, bwd = time_backward(torch, lambda *t: ops.flash_attention(
        *t, causal=True, window=window), qkv)
    plain_fwd, plain_bwd = time_backward(torch, lambda *t:
                                         ref.flash_attention_ref(
                                             *t, causal=True, window=window),
                                         qkv)
    out["flash_attention"] = {"fwd_ms": fwd, "bwd_ms": bwd,
                              "plain_fwd_ms": plain_fwd,
                              "plain_bwd_ms": plain_bwd}
    log(f"  flash_attention at the scoring shape, eager ms: forward kernel "
        f"{fwd:.3f}, backward (plain recompute) {bwd:.3f}; plain route "
        f"forward {plain_fwd:.3f}, backward {plain_bwd:.3f}")
    del qkv
    s_cfg = zamba.ssm
    chunk = s_cfg.chunk_size
    inputs = [t.requires_grad_() for t in ssd_inputs(
        ZAMBA_BATCH, ZAMBA_SEQ, s_cfg.num_heads(zamba.d_model),
        s_cfg.head_dim, s_cfg.d_state, np.random.RandomState(SEED + 8),
        model_like=True)]
    fwd, bwd = time_backward(torch, lambda *t: ops.ssd_scan(
        *t, chunk=chunk), inputs)
    plain_fwd, plain_bwd = time_backward(torch, lambda *t: ref.ssd_scan_ref(
        *t, chunk), inputs)
    out["ssd_scan"] = {"fwd_ms": fwd, "bwd_ms": bwd,
                       "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd}
    log(f"  ssd_scan at the scoring shape, eager ms: forward kernel "
        f"{fwd:.3f}, backward (plain recompute) {bwd:.3f}; plain route "
        f"forward {plain_fwd:.3f}, backward {plain_bwd:.3f}")
    return out


# ------------------------------------------ the transformer policy learns
def policy_catch_config():
    """The reference acceptance's preset and schedule, on the card."""
    from repro_torch.envs import Catch
    from repro_torch.experiments import ExperimentConfig
    from repro_torch.policies import (TransformerPolicyBuilder,
                                      TransformerPolicyConfig)
    return ExperimentConfig(
        builder_factory=lambda spec: TransformerPolicyBuilder(
            spec, TransformerPolicyConfig(**POLICY_PRESET), seed=SEED,
            device="cuda"),
        environment_factory=lambda seed: Catch(seed=seed), seed=SEED,
        num_episodes=POLICY_EPISODES, eval_every=0,
        eval_episodes=POLICY_EVAL_EPISODES, telemetry=True)


def policy_path(torch, kernels):
    """Phase 14, first part: run_experiment with TransformerPolicyBuilder
    at the reference acceptance's preset on the card.  Acting decodes on
    the decode kernel (prefill runs the plain path); every learner step
    runs flash attention once a layer for the online pass (through
    FlashAttentionFunction) and once for the target pass.  The final eval
    must beat the mean of the first 30 train returns."""
    from repro_torch import tree
    from repro_torch.experiments import run_experiment
    from repro_torch.telemetry import registry as telemetry

    config = policy_catch_config()
    try:
        for kernel in kernels:
            kernel["wrapper"].launches = 0
        t0 = time.monotonic()
        result = run_experiment(config)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
    finally:
        telemetry.unconfigure()
    learner = result.learner
    env_steps = result.actor_steps[-1]
    step_ms = result.extras["telemetry"]["merged"].get("learner/step_ms", {})
    early = float(np.mean(result.train_returns[:30]))
    final = result.final_eval_return
    layers = POLICY_PRESET["num_layers"]
    log(f"  {len(result.train_returns)} episodes, {env_steps} env steps, "
        f"{result.learner_steps} learner steps in {seconds:.3f} s "
        f"({env_steps / seconds:.1f} env steps/s); learner step host time "
        f"(ms): p50={step_ms.get('p50', 0):.3f} "
        f"p95={step_ms.get('p95', 0):.3f}; launches={launches}")
    log(f"  final eval {final} vs the mean of the first 30 train returns "
        f"{early:.3f}")
    check(launches["decode_attention"] > 0,
          "policy path: acting never launched the decode kernel")
    check(launches["flash_attention"] == 2 * layers * result.learner_steps
          > 0, f"policy path: {launches['flash_attention']} flash launches "
          f"for {result.learner_steps} learner steps of {layers} layer(s), "
          f"expected two a layer a step")
    check(launches["vtrace"] == launches["ssd_scan"] == 0,
          f"policy path launched a kernel of another slice: {launches}")
    check(all(t.device.type == "cuda" for t in tree.leaves(learner.state)),
          "policy path: the learner's state is not on the card")
    check(all(bool(torch.isfinite(t).all())
              for t in tree.leaves(learner.state.params)),
          "policy path: non-finite params")
    check(final is not None and np.isfinite(final) and final > early,
          f"policy path (the reference's acceptance): final eval {final} "
          f"does not beat the mean of the first 30 train returns {early}")
    return {"launches": launches, "episodes": len(result.train_returns),
            "env_steps": env_steps, "learner_steps": result.learner_steps,
            "seconds": seconds, "env_steps_per_s": env_steps / seconds,
            "learner_step_ms_p50": step_ms.get("p50"),
            "learner_step_ms_p95": step_ms.get("p95"),
            "first30": early, "final_eval": final}


def policy_batches(cfg, count, seed=SEED):
    """Replayed Catch windows as the SequenceAdder writes them: boards,
    actions, rewards at episode ends, discounts, start-of-episode flags
    (some rows mid-episode), the padding mask, keys and probabilities."""
    from repro_torch.replay import ReplaySample, SampleInfo
    B, T = cfg.batch_size, cfg.sequence_length
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        lengths = rng.randint(2, T + 1, B)
        mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
        obs = np.zeros((B, T) + OBS_SHAPE, np.float32)
        rows, steps = np.meshgrid(np.arange(B), np.arange(T), indexing="ij")
        obs[rows, steps, rng.randint(0, 9, (B, T)),
            rng.randint(0, 5, (B, T))] = 1.0
        obs[rows, steps, 9, rng.randint(0, 5, (B, T))] = 1.0
        obs *= mask[..., None, None]
        ended = np.zeros((B, T), bool)
        ended[np.arange(B), lengths - 1] = rng.rand(B) < 0.6
        starts = np.zeros((B, T), bool)
        starts[:, 0] = rng.rand(B) < 0.5
        data = {"observation": obs,
                "action": (rng.randint(0, NUM_ACTIONS, (B, T)) * mask
                           ).astype(np.int32),
                "reward": np.where(ended, rng.choice([-1.0, 1.0], (B, T)),
                                   0.0).astype(np.float32),
                "discount": (mask * ~ended).astype(np.float32),
                "start_of_episode": starts, "mask": mask}
        out.append(ReplaySample(SampleInfo(
            np.arange(B, dtype=np.int64) + i * B,
            rng.rand(B) * 1e-2 + 1e-4), data))
    return out


def policy_learner_profile(torch, kernels):
    """Phase 14, second part: the learner alone at the served width (fig17's
    top policy, T 16, B 16): host ms a step (p50, p95 over
    POLICY_TIMED_STEPS after 10 warm-up steps; each step ends in its one
    host copy), flash launches a step, then a windowed actor on the same
    weights for one Catch episode: decode launches and host ms a decode
    call."""
    import itertools

    from repro_torch.core import VariableClient, make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.policies import (TransformerPolicyBuilder,
                                      TransformerPolicyConfig, learning)

    cfg = TransformerPolicyConfig(**POLICY_LEARNER)
    spec = make_environment_spec(Catch())
    learner = learning.make_learner(
        spec, cfg, itertools.cycle(policy_batches(cfg, 10)),
        torch.Generator().manual_seed(SEED),
        priority_update_cb=lambda keys, priorities: None, device="cuda")
    flash, decode = (next(k["wrapper"] for k in kernels if k["name"] == n)
                     for n in ("flash_attention", "decode_attention"))
    for _ in range(10):
        learner.step()
    torch.cuda.synchronize()
    before = flash.launches
    times = []
    for _ in range(POLICY_TIMED_STEPS):
        t0 = time.monotonic()
        learner.step()
        times.append((time.monotonic() - t0) * 1e3)
    per_step = (flash.launches - before) / POLICY_TIMED_STEPS
    check(per_step == 2 * cfg.num_layers, f"policy learner: {per_step} "
          f"flash launches a step, expected {2 * cfg.num_layers}")

    builder = TransformerPolicyBuilder(spec, cfg, seed=SEED, device="cuda")
    actor = builder.make_actor(builder.make_policy(), VariableClient(learner),
                               adder=None)
    env = Catch(seed=SEED)
    ts = env.reset()
    actor.observe_first(ts)
    actor.select_action(ts.observation)          # the episode's prefill
    decode_launches, act_ms = [], []
    while True:
        ts = env.step(0)
        if ts.last():
            break
        before = decode.launches
        t0 = time.monotonic()
        actor.select_action(ts.observation)
        act_ms.append((time.monotonic() - t0) * 1e3)
        decode_launches.append(decode.launches - before)
    check(set(decode_launches) == {cfg.num_layers}, f"policy acting: decode "
          f"launches a call {decode_launches}, expected {cfg.num_layers}")
    out = {"learner_step_ms_p50": float(np.percentile(times, 50)),
           "learner_step_ms_p95": float(np.percentile(times, 95)),
           "flash_launches_per_learner_step": per_step,
           "decode_launches_per_acting_call": cfg.num_layers,
           "acting_call_ms_p50": float(np.percentile(act_ms, 50))}
    log(f"  fig17-width learner (T {cfg.sequence_length}, B "
        f"{cfg.batch_size}): {json.dumps(out)}")
    # where a step's and an acting call's time goes (decode calls: each
    # call is one step past the last, so it takes the decode path)
    obs = np.zeros(OBS_SHAPE, np.float32)
    out["profile"] = profile_calls(torch, {
        "learner_step": learner.step,
        "act": lambda: actor.select_action(obs)}, 20)
    return out


def policy_learner_parity(torch):
    """Phase 15: the transformer policy's learner on the card (flash
    attention on the kernel) against the same learner on the CPU (the plain
    version) on the same 10 batches, at the served width and at the preset
    (head_dim 16).  Step by step from the same state (the CPU's, copied to
    the card before each step): losses, priorities and Adam's moments
    within POLICY_TOL of the CPU's largest magnitude per leaf, params
    within POLICY_PARAM_ATOL, one sync a card step.  Then 10 free-running
    steps from the same init, gated at POLICY_DRIFT_TOL: there, weights
    whose gradient is near Adam's eps differ by up to ~lr / 50 after a step
    and feed later gradients, so differences grow step by step."""
    from repro_torch import tree
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.policies import TransformerPolicyConfig, learning

    spec = make_environment_spec(Catch())

    def learners(cfg, batches, priorities):
        return {side: learning.make_learner(
            spec, cfg, iter(batches), torch.Generator().manual_seed(SEED),
            priority_update_cb=lambda k, p, side=side:
            priorities[side].append(p), device=device)
            for side, device in (("card", "cuda"), ("cpu", "cpu"))}

    def errors(card, cpu, losses, priorities, worst):
        worst["loss"] = max([worst.get("loss", 0.0)] + [
            rel_error(a, b) for a, b in losses])
        worst["priorities"] = max([worst.get("priorities", 0.0)] + [
            rel_error(a, b) for a, b in zip(priorities["card"],
                                            priorities["cpu"])])
        for name, a, b in (
                ("params", card.params, cpu.params),
                ("target_params", card.target_params, cpu.target_params),
                ("mu", card.opt_state.mu, cpu.opt_state.mu),
                ("nu", card.opt_state.nu, cpu.opt_state.nu)):
            pairs = [(x.cpu().numpy(), y.numpy()) for x, y in
                     zip(tree.leaves(a), tree.leaves(b))]
            worst[name] = max([worst.get(name, 0.0)] + [
                rel_error(x, y) for x, y in pairs])
            if name in ("params", "target_params"):
                worst["params_abs"] = max([worst.get("params_abs", 0.0)] + [
                    float(np.abs(x - y).max()) for x, y in pairs])
        return worst

    def gate(worst, tol, what):
        gated = {k: v for k, v in worst.items()
                 if k not in ("params", "target_params", "params_abs")}
        check(max(gated.values()) <= tol, f"{what}: {gated} > {tol}")
        check(worst["params_abs"] <= POLICY_PARAM_ATOL, f"{what}: params "
              f"differ by {worst['params_abs']} > {POLICY_PARAM_ATOL}")

    out = {}
    for label, kw in (("fig17", POLICY_LEARNER),
                      ("preset_d16", dict(POLICY_PRESET,
                                          target_update_period=3))):
        cfg = TransformerPolicyConfig(**kw)
        batches = policy_batches(cfg, 10, seed=SEED + 15)
        # step by step from the CPU's state
        priorities = {"card": [], "cpu": []}
        pair = learners(cfg, batches, priorities)
        syncs, per_step = [], {}
        for _ in batches:
            pair["card"].state = tree.map(lambda t: t.to("cuda"),
                                          pair["cpu"].state)
            syncs.append(sync_count(torch, pair["card"].step))
            pair["cpu"].step()
            errors(pair["card"].state, pair["cpu"].state,
                   [(pair["card"].metrics["loss"],
                     pair["cpu"].metrics["loss"])],
                   {side: p[-1:] for side, p in priorities.items()},
                   per_step)
        check(all(n == 1 for n in syncs), f"policy learner parity {label}: "
              f"a card step synced {syncs} times")
        check(len(priorities["card"]) == len(batches),
              f"policy learner parity {label}: priorities not sent a step")
        gate(per_step, POLICY_TOL, f"policy learner parity {label}, step by "
             f"step")
        # free running from the same init
        priorities = {"card": [], "cpu": []}
        pair = learners(cfg, batches, priorities)
        losses = []
        for _ in batches:
            pair["card"].step()
            pair["cpu"].step()
            losses.append((pair["card"].metrics["loss"],
                           pair["cpu"].metrics["loss"]))
        drift = errors(pair["card"].state, pair["cpu"].state, losses,
                       priorities, {})
        check(int(pair["card"].state.steps) == len(batches),
              f"policy learner parity {label}: step counter")
        log(f"  {label}: device syncs per card step {syncs}; max |d| / max "
            f"|cpu| per leaf, step by step from the same state "
            f"{json.dumps(per_step)}; after {len(batches)} free-running "
            f"steps {json.dumps(drift)}; last loss {losses[-1][0]:.8f} vs "
            f"{losses[-1][1]:.8f}")
        gate(drift, POLICY_DRIFT_TOL, f"policy learner parity {label}, "
             f"free running")
        out[label] = {"syncs": syncs, "step_by_step": per_step,
                      "free_running": drift}
    return out


# ------------------------------------------- R2D2, DQfD and R2D3 on the card
def sequence_agents(torch, kernels):
    """Phase 16: the reference's learning acceptances for R2D2
    (tests/test_agents_learning.py), DQfD (the same file) and R2D3
    (tests/test_r2d3.py), at their configs and seeds, on the card; their
    learners run no kernel.  Prints each learner step's host ms."""
    from repro_torch import tree
    from repro_torch.agents import make_agent
    from repro_torch.agents.dqfd import (DQfDBuilder, DQfDConfig,
                                         generate_deep_sea_demos,
                                         generate_sequence_demos)
    from repro_torch.agents.r2d2 import R2D2Builder, R2D2Config
    from repro_torch.agents.r2d3 import R2D3Builder, R2D3Config
    from repro_torch.core import EnvironmentLoop, make_environment_spec
    from repro_torch.envs import DeepSea, MemoryChain

    def r2d2():
        env = MemoryChain(memory_length=5, seed=3)
        cfg = R2D2Config(sequence_length=6, period=3, burn_in=0,
                         batch_size=16, min_replay_size=60,
                         samples_per_insert=0, target_update_period=40,
                         epsilon=0.15)
        return env, R2D2Builder(make_environment_spec(env), cfg, seed=2,
                                device="cuda"), 350

    def dqfd():
        env = DeepSea(size=6, seed=1)
        demos = generate_deep_sea_demos(DeepSea(size=6, seed=1),
                                        num_demos=20)
        cfg = DQfDConfig(min_replay_size=60, samples_per_insert=0,
                         batch_size=32, n_step=1, demo_ratio=0.5,
                         epsilon=0.1)
        return env, DQfDBuilder(make_environment_spec(env), demos, cfg,
                                seed=0, device="cuda"), 250

    def r2d3():
        env = DeepSea(size=5, seed=1)
        demos = generate_sequence_demos(
            DeepSea(size=5, seed=1), lambda e: e.optimal_action(),
            num_demos=15, sequence_length=5, period=4)
        cfg = R2D3Config(sequence_length=5, period=4, burn_in=0,
                         batch_size=16, min_replay_size=40,
                         samples_per_insert=0, target_update_period=40,
                         epsilon=0.1, demo_ratio=0.5)
        return env, R2D3Builder(make_environment_spec(env), demos, cfg,
                                seed=3, device="cuda"), 250

    out = {}
    for name, make in (("r2d2", r2d2), ("dqfd", dqfd), ("r2d3", r2d3)):
        env, builder, episodes = make()
        agent = make_agent(builder)
        learner = agent.learner
        step_ms = time_learner_steps(learner)
        for kernel in kernels:
            kernel["wrapper"].launches = 0
        loop = EnvironmentLoop(env, agent)
        t0 = time.monotonic()
        rets = [loop.run_episode()["episode_return"] for _ in range(episodes)]
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {k["name"]: k["wrapper"].launches for k in kernels}
        steps = int(learner.state.steps)
        if name == "r2d2":
            score, gate, what = float(np.mean(rets[-60:])), 0.3, \
                "mean return of the last 60"
        else:
            score, gate, what = float(np.mean(np.asarray(rets[-50:]) > 0.5)), \
                0.2, "treasure share of the last 50"
        entry = {"episodes": episodes, "learner_steps": steps,
                 "seconds": seconds, what: score,
                 "learner_step_ms_p50": float(np.percentile(step_ms, 50)),
                 "learner_step_ms_p95": float(np.percentile(step_ms, 95)),
                 "launches": launches}
        log(f"  {name}: {json.dumps(entry)}")
        check(steps == len(step_ms) > 0, f"{name}: {steps} learner steps, "
              f"{len(step_ms)} timed")
        check(all(n == 0 for n in launches.values()),
              f"{name} launched a kernel: {launches}")
        check(all(t.device.type == "cuda"
                  for t in tree.leaves(learner.state)),
              f"{name}: the learner's state is not on the card")
        check(score > gate, f"{name} (the reference's acceptance): {what} "
              f"is {score}, not > {gate}")
        out[name] = entry
    return out


# ------------------------------- continuous control, offline and planning
def kernel_launches(kernels):
    return {k["name"]: k["wrapper"].launches for k in kernels}


def zero_launches(kernels):
    for kernel in kernels:
        kernel["wrapper"].launches = 0


def time_learner_steps(learner):
    """Wrap ``learner.step`` to record each step's host ms (a step ends in
    its one host copy); returns the list it appends to."""
    step, step_ms = learner.step, []

    def timed_step():
        t0 = time.monotonic()
        metrics = step()
        step_ms.append((time.monotonic() - t0) * 1e3)
        return metrics

    learner.step = timed_step
    return step_ms


def continuous_control(torch, kernels):
    """Phase 17: the reference's D4PG acceptance and its MPO and DMPO
    run-and-update checks on the card, through ``make_agent`` and an
    ``EnvironmentLoop`` on PendulumSwingup; no kernel launches.  Prints env
    steps/s and each learner step's host ms p50/p95."""
    from repro_torch import tree
    from repro_torch.agents import make_agent
    from repro_torch.agents.continuous import (ContinuousBuilder,
                                               ContinuousConfig)
    from repro_torch.core import EnvironmentLoop, make_environment_spec
    from repro_torch.envs import PendulumSwingup

    runs = {"d4pg": (1, 3, 120, D4PG_ACCEPT, D4PG_EPISODES)}
    runs.update({algo: (env_seed, seed, 60, knobs, MPO_EPISODES)
                 for algo, (env_seed, seed, knobs) in MPO_CHECKS.items()})
    out = {}
    for name, (env_seed, seed, length, knobs, episodes) in runs.items():
        env = PendulumSwingup(seed=env_seed, episode_len=length)
        agent = make_agent(ContinuousBuilder(
            make_environment_spec(env), ContinuousConfig(**knobs), seed=seed,
            device="cuda"))
        learner = agent.learner
        step_ms = time_learner_steps(learner)
        zero_launches(kernels)
        loop = EnvironmentLoop(env, agent)
        t0 = time.monotonic()
        results = [loop.run_episode() for _ in range(episodes)]
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = kernel_launches(kernels)
        rets = [r["episode_return"] for r in results]
        env_steps = sum(r["episode_length"] for r in results)
        steps = int(learner.state.steps)
        entry = {"episodes": episodes, "env_steps": env_steps,
                 "learner_steps": steps, "seconds": seconds,
                 "env_steps_per_s": env_steps / seconds,
                 "learner_step_ms_p50": float(np.percentile(step_ms, 50)),
                 "learner_step_ms_p95": float(np.percentile(step_ms, 95)),
                 "first10": float(np.mean(rets[:10])),
                 "last10": float(np.mean(rets[-10:])),
                 "launches": launches}
        log(f"  {name}: {json.dumps(entry)}")
        check(steps == len(step_ms) > 0, f"{name}: {steps} learner steps, "
              f"{len(step_ms)} timed")
        check(all(n == 0 for n in launches.values()),
              f"{name} launched a kernel: {launches}")
        check(all(t.device.type == "cuda"
                  for t in tree.leaves(learner.state)),
              f"{name}: the learner's state is not on the card")
        check(np.isfinite(rets).all(), f"{name}: non-finite returns {rets}")
        if name == "d4pg":
            check(entry["last10"] > entry["first10"], f"d4pg (the "
                  f"reference's acceptance): the mean of the last 10 "
                  f"returns {entry['last10']} does not beat the first 10's "
                  f"{entry['first10']}")
        out[name] = entry
    return out


def continuous_batches(count, batch):
    """Replay batches as the n-step adder writes them on PendulumSwingup:
    (cos, sin, velocity / 8) observations, (1,) actions in [-1, 1], 3-step
    rewards (each step's in [0, 1]) and discounts, keys and
    probabilities."""
    from repro_torch.core.types import Transition
    from repro_torch.replay import ReplaySample, SampleInfo
    rng = np.random.RandomState(SEED + 18)
    out = []
    for i in range(count):
        th = rng.uniform(-np.pi, np.pi, (2, batch))
        thd = rng.uniform(-8, 8, (2, batch))
        obs = np.stack([np.cos(th), np.sin(th), thd / 8.0], -1
                       ).astype(np.float32)
        data = Transition(
            obs[0], rng.uniform(-1, 1, (batch, 1)).astype(np.float32),
            (rng.rand(batch) * 3).astype(np.float32),
            np.full(batch, 0.99 ** 3, np.float32), obs[1], ())
        out.append(ReplaySample(SampleInfo(
            np.arange(batch, dtype=np.int64) + i * batch,
            np.full(batch, 1e-4)), data))
    return out


def shared_normal(torch):
    """One normal stream for the card's learner and the CPU's: each draw is
    made on the CPU from the seed the learner gave its generator (17 *
    STEP_MOD + step) and the draw's rank (the critic's (B, A), then the
    E-step's (S, B, A)), and reaches the card from pinned memory, a copy
    queued without a wait."""
    def learner_normal(generator, shape):
        cpu = torch.Generator().manual_seed(
            generator.initial_seed() * 4 + len(shape))
        x = torch.randn(tuple(shape), generator=cpu)
        if generator.device.type == "cuda":
            return x.pin_memory().to(generator.device, non_blocking=True)
        return x
    return learner_normal


def relu_kinks(torch, cfg, state, batch):
    """Hidden ReLU units whose pre-activation has one sign on the card and
    the other on the CPU, in the learner's differentiated forward paths
    (the policy on the observations, the critic on the replayed actions,
    and for DDPG and D4PG the critic on the policy's actions), computed from
    the same params and batch on both: their count, and the largest |z|
    among them over its layer's largest |z| (CPU)."""
    from repro_torch.agents import continuous

    def preacts(device):
        params = {k: state.params[k] for k in ("policy", "critic")}
        params = {k: [{n: w.to(device) for n, w in layer.items()}
                      for layer in v] for k, v in params.items()}
        obs = torch.as_tensor(batch.data.observation).to(device)
        act = torch.as_tensor(batch.data.action).to(device)
        out = []

        def walk(layers, h):
            for i, layer in enumerate(layers):
                h = h @ layer["w"] + layer["b"]
                if i < len(layers) - 1:
                    out.append(h.cpu())
                    h = torch.relu(h)
            return h

        head = walk(params["policy"], obs)
        walk(params["critic"], torch.cat([obs, act], -1))
        if not continuous._mpo_family(cfg):
            walk(params["critic"], torch.cat([obs, torch.tanh(head)], -1))
        return out

    flips, worst = 0, 0.0
    for card, cpu in zip(preacts("cuda"), preacts("cpu")):
        flipped = (card > 0) != (cpu > 0)
        if bool(flipped.any()):
            flips += int(flipped.sum())
            worst = max(worst, float(cpu[flipped].abs().max()
                                     / cpu.abs().max()))
    return flips, worst


def continuous_parity(torch):
    """Phase 18: DDPG, D4PG, MPO and DMPO learners at ContinuousConfig()'s
    full width on the card against the same learners on the CPU, on the
    same 10 batches, step by step from the CPU's state (MPO and DMPO on
    one shared normal stream: CPU and CUDA generators differ): losses and
    the policy Adam's moments within CONTINUOUS_TOL of the CPU's largest
    magnitude per leaf (DMPO's within CONTINUOUS_ALGO_TOL, the 0-d duals
    within CONTINUOUS_DUAL_TOL; a step with ReLU kink flips,
    ``relu_kinks``, within CONTINUOUS_KINK_TOL),
    params within POLICY_PARAM_ATOL, the critic's Adam never stepped, one
    sync a card step.  Then each learner step at that width on the card: host ms
    (p50, p95), kernels and copies a step and device ms (torch.profiler)."""
    import itertools
    from unittest import mock

    from repro_torch import tree
    from repro_torch.agents import continuous
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import PendulumSwingup

    spec = make_environment_spec(PendulumSwingup())
    out = {}
    for algo in CONTINUOUS_ALGOS:
        cfg = continuous.ContinuousConfig(algo=algo)
        batches = continuous_batches(CONTINUOUS_BATCHES, cfg.batch_size)
        with mock.patch.object(continuous, "learner_normal",
                               shared_normal(torch)):
            pair = {side: continuous.make_learner(
                spec, cfg, iter(batches), torch.Generator().manual_seed(SEED),
                device=device) for side, device in (("card", "cuda"),
                                                    ("cpu", "cpu"))}
            card, cpu = pair["card"], pair["cpu"]
            syncs, worst, kinks = [], {}, []
            for step, batch in enumerate(batches):
                flips, flip_z = relu_kinks(torch, cfg, cpu.state, batch)
                card.state = tree.map(lambda t: t.to("cuda"), cpu.state)
                syncs.append(sync_count(torch, card.step))
                cpu.step()
                here = {k: rel_error(card.metrics[k], cpu.metrics[k])
                        for k in ("critic_loss", "policy_loss", "loss")}
                (popt, copt), (cpu_popt, cpu_copt) = (card.state.opt_state,
                                                      cpu.state.opt_state)
                for field in ("mu", "nu"):
                    mine, theirs = getattr(popt, field), getattr(cpu_popt,
                                                                 field)
                    for name in mine:
                        key = (f"{field}.{name}" if name in CONTINUOUS_DUALS
                               else field)
                        here[key] = max([here.get(key, 0.0)] + [
                            rel_error(x.cpu().numpy(), y.numpy())
                            for x, y in zip(tree.leaves(mine[name]),
                                            tree.leaves(theirs[name]))])
                here["params_abs"] = max(
                    float((x.cpu() - y).abs().max()) for x, y in zip(
                        tree.leaves((card.state.params,
                                     card.state.target_params)),
                        tree.leaves((cpu.state.params,
                                     cpu.state.target_params))))
                duals = {k: v for k, v in here.items() if "." in k}
                rest = {k: v for k, v in here.items()
                        if "." not in k and k != "params_abs"}
                tol = CONTINUOUS_ALGO_TOL.get(algo, CONTINUOUS_TOL)
                if flips:
                    kinks.append({"step": step, "flips": flips,
                                  "max_abs_z_rel": flip_z,
                                  "max_rel_err": max(rest.values())})
                    check(flip_z <= CONTINUOUS_KINK_Z, f"{algo} step {step}: "
                          f"a ReLU unit {flip_z} of its layer's largest "
                          f"|z| from 0 has another sign on the card")
                    tol = CONTINUOUS_KINK_TOL
                check(max(rest.values()) <= tol, f"{algo} learner parity, "
                      f"step {step} ({flips} ReLU kink flips): {rest} > "
                      f"{tol}")
                check(not duals or max(duals.values()) <= CONTINUOUS_DUAL_TOL,
                      f"{algo} learner parity, step {step}: duals {duals} > "
                      f"{CONTINUOUS_DUAL_TOL}")
                check(here["params_abs"] <= POLICY_PARAM_ATOL,
                      f"{algo} learner parity, step {step}: params differ by "
                      f"{here['params_abs']} > {POLICY_PARAM_ATOL}")
                check(int(copt.step) == int(cpu_copt.step) == 0,
                      f"{algo}: the critic's Adam was stepped")
                worst = {k: max(v, worst.get(k, 0.0)) for k, v in here.items()}
        log(f"  {algo} card vs CPU, step by step from the same state: "
            f"syncs {syncs}; max |d| / max |cpu| per leaf {json.dumps(worst)}"
            f"; steps with ReLU kink flips {json.dumps(kinks)}")
        check(all(n == 1 for n in syncs), f"{algo} learner parity: a card "
              f"step synced {syncs} times")
        check(int(card.state.steps) == len(batches),
              f"{algo} learner parity: step counter")

        # the learner step on the card, its own draws
        learner = continuous.make_learner(
            spec, cfg, itertools.cycle(batches),
            torch.Generator().manual_seed(SEED), device="cuda")
        for _ in range(10):
            learner.step()
        torch.cuda.synchronize()
        times = []
        for _ in range(CONTINUOUS_TIMED_STEPS):
            t0 = time.monotonic()
            learner.step()
            times.append((time.monotonic() - t0) * 1e3)
        entry = {"syncs": syncs, "max_rel_err": worst, "kink_steps": kinks,
                 "learner_step_ms_p50": float(np.percentile(times, 50)),
                 "learner_step_ms_p95": float(np.percentile(times, 95))}
        entry.update(profile_calls(torch, {f"{algo}_learner_step":
                                           learner.step},
                                   CONTINUOUS_TIMED_STEPS)[
            f"{algo}_learner_step"])
        check(all(bool(torch.isfinite(t).all())
                  for t in tree.leaves(learner.state.params)),
              f"{algo}: non-finite params after the timed steps")
        out[algo] = entry
    return out


def catch_data(episodes, seed, explore):
    """Transitions of the track-the-ball Catch policy, a random action
    with probability ``explore`` (``examples/offline_bc.py``'s expert data
    at 0, ``tests/test_system.py``'s at 0.2), through an n-step-1 adder."""
    from repro_torch.adders import NStepTransitionAdder
    from repro_torch.envs import Catch
    from repro_torch.replay import MinSize, Table, Uniform

    env = Catch(seed=seed)
    table = Table("data", 1 << 20, Uniform(0), MinSize(1))
    adder = NStepTransitionAdder(table, 1, 0.99)
    rng = np.random.RandomState(seed)
    for _ in range(episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            board = ts.observation
            ball = int(np.argmax(board[:-1].max(axis=0)))
            paddle = int(np.argmax(board[-1]))
            a = int(1 + np.sign(ball - paddle))
            if explore and rng.rand() < explore:
                a = int(rng.randint(3))
            ts = env.step(a)
            adder.add(a, ts)
    return [table._items[k].data for k in table._order]


def offline_and_planning(torch, kernels):
    """Phase 19: ``run_offline_experiment`` with examples/offline_bc.py's
    config; the reference's BC and offline-DQN acceptance
    (tests/test_system.py) and MCTS acceptance
    (tests/test_agents_learning.py) on the card; a few episodes of
    ``make_agent(MCTSBuilder)``.  No kernel launches.  Each MCTS search
    must sync with the device once per network evaluation (the priors'
    copy to the host)."""
    from repro_torch import tree
    from repro_torch.agents import bc, dqn, make_agent, mcts
    from repro_torch.core import (EnvironmentLoop, FeedForwardActor,
                                  VariableClient, VariableServer,
                                  make_environment_spec)
    from repro_torch.envs import Catch
    from repro_torch.experiments import (ExperimentConfig,
                                         run_offline_experiment)
    from repro_torch.replay import dataset_from_list

    out = {}
    # examples/offline_bc.py through run_offline_experiment
    items = catch_data(BC_EXAMPLE_EPISODES, 0, 0.0)
    config = ExperimentConfig(
        builder_factory=lambda spec: bc.BCBuilder(spec, items, bc.BCConfig(),
                                                  seed=0, device="cuda"),
        environment_factory=lambda seed: Catch(seed=seed), seed=0,
        eval_episodes=BC_EXAMPLE_EVAL_EPISODES)
    zero_launches(kernels)
    t0 = time.monotonic()
    result = run_offline_experiment(config, num_learner_steps=BC_EXAMPLE_STEPS)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    walltime = result.learner.learner_walltime
    out["offline_bc_example"] = entry = {
        "dataset_size": result.extras["dataset_size"],
        "learner_steps": result.learner_steps, "seconds": seconds,
        "learner_walltime_s": walltime,
        "learner_steps_per_s": result.learner_steps / walltime,
        "final_eval": result.final_eval_return,
        "launches": kernel_launches(kernels)}
    log(f"  offline_bc example: {json.dumps(entry)}")
    check(result.learner_steps == BC_EXAMPLE_STEPS
          and entry["dataset_size"] == len(items),
          f"offline BC: {result.learner_steps} learner steps over "
          f"{entry['dataset_size']} items")
    check(np.isfinite(entry["final_eval"]), "offline BC: no final eval")
    check(all(t.device.type == "cuda"
              for t in tree.leaves(result.learner.state)),
          "offline BC: the learner's state is not on the card")

    # the reference's acceptance: BC and offline DQN on 20%-explore data
    spec = make_environment_spec(Catch(seed=5))
    items = catch_data(120, 5, 0.2)
    bcfg = bc.BCConfig()
    bl = bc.make_learner(spec, bcfg, dataset_from_list(items, 64),
                         torch.Generator().manual_seed(1), device="cuda")
    for _ in range(300):
        bl.step()
    actor = FeedForwardActor(bc.make_eval_policy(spec, bcfg),
                             VariableClient(bl), device="cuda")
    loop = EnvironmentLoop(Catch(seed=9), actor)
    bc_return = float(np.mean([loop.run_episode()["episode_return"]
                               for _ in range(20)]))
    qcfg = dqn.DQNConfig(prioritized=False)
    ql = dqn.make_learner(spec, qcfg, dataset_from_list(items, 64),
                          torch.Generator().manual_seed(0), device="cuda")
    losses = [ql.step()["loss"] for _ in range(400)]
    out["offline_acceptance"] = entry = {
        "bc_eval": bc_return, "dqn_loss_first5": float(np.mean(losses[:5])),
        "dqn_loss_last50": float(np.mean(losses[-50:])),
        "launches": kernel_launches(kernels)}
    log(f"  offline acceptance: {json.dumps(entry)}")
    check(bc_return > 0.3, f"BC (the reference's acceptance): eval "
          f"{bc_return}, not > 0.3")
    check(np.isfinite(losses).all(), "offline DQN: non-finite losses")
    check(entry["dqn_loss_last50"] < entry["dqn_loss_first5"],
          f"offline DQN (the reference's acceptance): loss over the last 50 "
          f"{entry['dqn_loss_last50']} not below the first 5's "
          f"{entry['dqn_loss_first5']}")

    # the reference's MCTS acceptance, the real env as the model
    env = Catch(seed=4)
    spec = make_environment_spec(env)
    cfg = mcts.MCTSConfig(**MCTS_ACCEPT)
    init, _, _, _ = mcts.make_network(spec, cfg, device="cuda")
    server = VariableServer(policy=init(torch.Generator().manual_seed(0)))
    actor = mcts.MCTSActor(spec, cfg, VariableClient(server), model_env=env,
                           seed=0, device="cuda")
    evaluate, evaluations = actor._evaluate, [0]

    def counted(obs):
        evaluations[0] += 1
        return evaluate(obs)

    actor._evaluate = counted
    search_ms, search_evals, rets, first = [], [], [], None
    for _ in range(10):
        ts = env.reset()
        total = 0.0
        while not ts.last():
            before = evaluations[0]
            t0 = time.monotonic()
            if first is None:       # the first search, under sync counting
                action = []
                first = sync_count(torch, lambda: action.append(
                    actor.select_action(ts.observation)))
                action = action[0]
                first = (first, evaluations[0] - before)
            else:
                action = actor.select_action(ts.observation)
            search_ms.append((time.monotonic() - t0) * 1e3)
            search_evals.append(evaluations[0] - before)
            ts = env.step(action)
            total += ts.reward
        rets.append(total)
    out["mcts_acceptance"] = entry = {
        "mean_return": float(np.mean(rets)), "searches": len(search_ms),
        "search_ms_mean": float(np.mean(search_ms)),
        "search_ms_p50": float(np.percentile(search_ms, 50)),
        "search_ms_p95": float(np.percentile(search_ms, 95)),
        "evaluations_per_search": float(np.mean(search_evals)),
        "first_search_syncs_and_evaluations": first,
        "launches": kernel_launches(kernels)}
    log(f"  mcts acceptance: {json.dumps(entry)}")
    check(first[0] == first[1] > 0, f"MCTS: the first search synced "
          f"{first[0]} times for {first[1]} network evaluations")
    check(entry["mean_return"] > 0.4, f"MCTS (the reference's acceptance): "
          f"mean return {entry['mean_return']}, not > 0.4")

    # the agent make_agent builds from MCTSBuilder
    env = Catch(seed=0)
    agent = make_agent(mcts.MCTSBuilder(
        make_environment_spec(env), lambda seed: Catch(seed=seed),
        mcts.MCTSConfig(**MCTS_AGENT), seed=0, device="cuda"))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"]
            for _ in range(MCTS_AGENT_EPISODES)]
    out["mcts_agent"] = entry = {
        "episodes": MCTS_AGENT_EPISODES,
        "learner_steps": int(agent.learner.state.steps),
        "returns": rets, "launches": kernel_launches(kernels)}
    log(f"  mcts agent: {json.dumps(entry)}")
    check(entry["learner_steps"] > 0, "MCTS agent: the learner never stepped")
    check(np.isfinite(rets).all(), "MCTS agent: non-finite returns")
    check(all(n == 0 for n in entry["launches"].values()),
          f"phase 19 launched a kernel: {entry['launches']}")
    return out


# ----------------------------------------------- distributed execution
class CardBuilder:
    """``spec -> builder`` on the card: ``kind`` "policy" gives a
    ``TransformerPolicyBuilder`` over ``cfg`` (``TransformerPolicyConfig``
    fields), "dqn" a ``DQNBuilder`` over ``DQNConfig`` fields; builder seed
    SEED.  At the script's top level, so that the actor processes the
    multiprocess launcher spawns can unpickle it: they re-import this file
    (its work stays under ``__main__``) and build their own builder."""

    def __init__(self, kind, **cfg):
        self.kind = kind
        self.cfg = cfg

    def __call__(self, spec):
        if self.kind == "dqn":
            from repro_torch.agents.dqn import DQNBuilder, DQNConfig
            return DQNBuilder(spec, DQNConfig(**self.cfg), seed=SEED,
                              device="cuda")
        from repro_torch.policies import (TransformerPolicyBuilder,
                                          TransformerPolicyConfig)
        return TransformerPolicyBuilder(
            spec, TransformerPolicyConfig(**self.cfg), seed=SEED,
            device="cuda")


def catch_env(seed):
    """``seed -> Catch``, at top level for the spawned actor processes."""
    from repro_torch.envs import Catch
    return Catch(seed=seed)


def distributed_run(torch, kernels, config, **kwargs):
    """``run_distributed_experiment`` with the launch counts zeroed just
    before and read just after (in this process: the learner, replay,
    parameter server and inference server live here; actors are spawned
    processes under the multiprocess launcher); the telemetry registry is
    released after."""
    from repro_torch.experiments import run_distributed_experiment
    from repro_torch.telemetry import registry as telemetry

    try:
        zero_launches(kernels)
        t0 = time.monotonic()
        result = run_distributed_experiment(config, **kwargs)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = kernel_launches(kernels)
    finally:
        telemetry.unconfigure()
    steps = int(result.counts.get("actor_steps", 0))
    wall = result.extras["walltime"]
    entry = {"actor_steps": steps, "learner_steps": result.learner_steps,
             "walltime_s": wall, "seconds_with_setup": seconds,
             "env_steps_per_s": steps / wall,
             "learner_steps_per_s": result.learner_steps / wall,
             "spi_effective": result.extras["spi_effective"],
             "launches": launches}
    merged = (result.extras.get("telemetry") or {}).get("merged", {})
    for name, key in (("learner/step_ms", "learner_step_ms"),
                      ("inference/queue_wait_ms", "inference_queue_wait_ms"),
                      ("courier/server/inference/select_action/latency_ms",
                       "select_action_rpc_ms")):
        if name in merged:
            entry[f"{key}_p50"] = merged[name].get("p50")
            entry[f"{key}_p95"] = merged[name].get("p95")
    if "inference" in result.extras:
        stats = result.extras["inference"]
        entry["inference"] = {key: stats.get(key) for key in (
            "batches", "requests", "rows", "avg_rows_per_batch",
            "decode_rows", "prefill_rows", "decode_batches",
            "prefill_batches", "padded_rows") if key in stats}
    if "learners" in result.extras:
        entry["learners"] = result.extras["learners"]
    if "replay" in result.extras:
        entry["per_shard_inserts"] = [
            s["inserts"] for s in result.extras["replay"]["per_shard"]]
        entry["per_shard_samples"] = [
            s["samples"] for s in result.extras["replay"]["per_shard"]]
    entry["final_eval"] = result.final_eval_return
    return result, entry


def fig17_placement(torch, kernels, policy):
    """Phase 20: fig17's tier 2 at d_model 256 on the card, once per
    inference mode, then the reference's two server acceptances.  In
    "server" mode the inference node (this process) decodes on the decode
    kernel — one launch a layer a decode batch — and the learner (this
    process) runs flash attention twice a layer a step; the actors hold no
    network.  In "local" mode each actor process decodes on its own copy of
    the policy on the card, so this process launches flash attention only.
    Which mode moves more env steps a second is printed, not gated (fig17's
    claim that the server wins at the top width is a TPU-era one)."""
    from repro_torch.experiments import ExperimentConfig

    layers = FIG17_POLICY["num_layers"]
    out = {}
    for mode in ("server", "local"):
        config = ExperimentConfig(
            builder_factory=CardBuilder("policy", **FIG17_POLICY),
            environment_factory=catch_env, seed=SEED, eval_episodes=0,
            launcher="multiprocess", inference=mode, telemetry=True)
        result, entry = distributed_run(
            torch, kernels, config, num_actors=FIG17_ACTORS,
            max_actor_steps=FIG17_STEPS, timeout_s=FIG17_TIMEOUT_S)
        launches = entry["launches"]
        log(f"  fig17 placement, inference={mode!r}: {json.dumps(entry)}")
        check(entry["actor_steps"] >= FIG17_STEPS, f"fig17 {mode}: "
              f"{entry['actor_steps']} actor steps in {FIG17_TIMEOUT_S} s")
        check(entry["learner_steps"] > 0, f"fig17 {mode}: the learner never "
              f"stepped")
        check(launches["flash_attention"]
              == 2 * layers * entry["learner_steps"], f"fig17 {mode}: "
              f"{launches['flash_attention']} flash launches for "
              f"{entry['learner_steps']} learner steps of {layers} layers")
        check(launches["vtrace"] == launches["ssd_scan"] == 0,
              f"fig17 {mode} launched a kernel of another slice: {launches}")
        if mode == "server":
            # the stats are read before the program stops, the counts
            # after: a decode batch may land between the two
            stats = entry["inference"]
            decoded = launches["decode_attention"]
            check(decoded % layers == 0
                  and decoded >= layers * stats["decode_batches"] > 0,
                  f"fig17 server: {decoded} decode launches for "
                  f"{stats['decode_batches']} decode batches of {layers} "
                  f"layers")
        else:
            check(launches["decode_attention"] == 0, f"fig17 local: this "
                  f"process decoded ({launches['decode_attention']} "
                  f"launches); the actors should")
        out[mode] = entry
    faster = max(out, key=lambda m: out[m]["env_steps_per_s"])
    alone = policy["fig17_learner"]["learner_step_ms_p50"]
    log(f"  fig17 at d_model 256: {faster!r} moves more env steps a second "
        f"(server {out['server']['env_steps_per_s']:.1f}, local "
        f"{out['local']['env_steps_per_s']:.1f}); learner step host ms p50: "
        f"{out['server'].get('learner_step_ms_p50')} beside the server, "
        f"{out['local'].get('learner_step_ms_p50')} beside local actors, "
        f"{alone} alone (phase 14)")
    out["faster_mode"] = faster
    out["learner_step_ms_p50_alone"] = alone

    # the reference's acceptances: the local launcher with two vectorized
    # actors (400 steps), then the multiprocess launcher (300 steps)
    for launcher, steps, timeout in (("local", 400, 120.0),
                                     ("multiprocess", 300, 400.0)):
        config = ExperimentConfig(
            builder_factory=CardBuilder("policy", **POLICY_PRESET),
            environment_factory=catch_env, seed=SEED, launcher=launcher,
            inference="server", num_envs_per_actor=2)
        result, entry = distributed_run(torch, kernels, config,
                                        num_actors=2, max_actor_steps=steps,
                                        timeout_s=timeout)
        stats = entry["inference"]
        log(f"  server acceptance, {launcher} launcher: {json.dumps(entry)}")
        check(entry["actor_steps"] > 0, f"server acceptance ({launcher}): "
              f"no actor steps")
        check(stats["decode_rows"] > 0 and stats["prefill_rows"] > 0,
              f"server acceptance ({launcher}): {stats}")
        if launcher == "local":
            check(entry["learner_steps"] > 0 and stats["batches"] > 0
                  and stats["decode_rows"] > stats["prefill_rows"],
                  f"server acceptance (local): {entry}")
        check(entry["launches"]["decode_attention"] > 0,
              f"server acceptance ({launcher}): no decode launches")
        out[f"acceptance_{launcher}"] = entry
    return out


def distributed_dqn(torch, kernels):
    """Phase 21: the reference's distributed DQN acceptances on the card —
    the multiprocess smoke (2 shards, an evaluator) and the two-replica
    run on both launchers — then a one-replica MultiLearner against the
    plain learner on the card over ONE_REPLICA_STEPS batches, bit for bit.
    DQN runs none of the four kernels."""
    from repro_torch import tree
    from repro_torch.experiments import ExperimentConfig
    from repro_torch.learners import MultiLearner

    out = {}
    runs = [("multiprocess_smoke", dict(num_replay_shards=2,
                                        launcher="multiprocess"), True)]
    runs += [(f"two_replicas_{launcher}",
              dict(num_learner_replicas=2, learner_average_period=10,
                   launcher=launcher), False)
             for launcher in ("local", "multiprocess")]
    for name, knobs, evaluator in runs:
        config = ExperimentConfig(
            builder_factory=CardBuilder("dqn", **DQN_SMOKE),
            environment_factory=catch_env, seed=SEED, eval_episodes=20,
            telemetry=True, **knobs)
        result, entry = distributed_run(
            torch, kernels, config, num_actors=DIST_ACTORS,
            max_actor_steps=DIST_STEPS, timeout_s=DIST_TIMEOUT_S,
            with_evaluator=evaluator)
        log(f"  {name}: {json.dumps(entry)}")
        check(all(n == 0 for n in entry["launches"].values()),
              f"{name} launched a kernel: {entry['launches']}")
        check(entry["actor_steps"] >= DIST_STEPS and
              entry["learner_steps"] > 50, f"{name}: {entry}")
        check(all(t.device.type == "cuda"
                  for t in tree.leaves(result.learner.state)),
              f"{name}: the learner's state is not on the card")
        final = result.final_eval_return
        check(final is not None and final > CATCH_FLOOR,
              f"{name}: final eval {final}, not > {CATCH_FLOOR}")
        if evaluator:
            check(1.0 < entry["spi_effective"] < 8.0,
                  f"{name}: spi_effective {entry['spi_effective']}")
            check(len(result.extras["evaluator_returns"]) >= 1,
                  f"{name}: the evaluator reported no return")
            check(all(n > 0 for n in entry["per_shard_inserts"]),
                  f"{name}: a shard saw no insert")
        else:
            learners = entry["learners"]
            check(learners["num_replicas"] == 2 and learners["rounds"] >= 1
                  and all(n > 0 for n in learners["per_replica_steps"])
                  and all(n > 0 for n in entry["per_shard_samples"]),
                  f"{name}: {learners}, samples a shard "
                  f"{entry['per_shard_samples']}")
        out[name] = entry

    # one replica is the plain learner, bit for bit, on the card
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    spec = make_environment_spec(Catch(seed=0))
    builder = DQNBuilder(spec, DQNConfig(**DQN_QUICKSTART), seed=SEED,
                         device="cuda")
    batches = dqn_batches(ONE_REPLICA_STEPS)
    plain = builder.make_learner(iter(list(batches)))
    multi = MultiLearner([builder.make_learner(iter(list(batches)))],
                         average_period=4)
    for _ in range(ONE_REPLICA_STEPS):
        plain.step()
        multi.step()
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(plain.state), tree.leaves(multi.state)))
    check(same and multi.param_server.rounds == ONE_REPLICA_STEPS // 4,
          "one-replica MultiLearner differs from the plain learner on the "
          "card")
    out["one_replica_bit_identical_steps"] = ONE_REPLICA_STEPS
    log(f"  one-replica MultiLearner == plain learner after "
        f"{ONE_REPLICA_STEPS} steps on the card, bit for bit")
    return out


# ------------------------------------------------------- fault tolerance
def histogram_summary(merged, name):
    """count, p50, p95 and max of a merged telemetry histogram (None when
    the run recorded none)."""
    entry = merged.get(name)
    if not entry or not entry.get("count"):
        return None
    return {key: entry.get(key) for key in ("count", "p50", "p95", "max")}


class RestoreLog:
    """Records, right after each service restore of the watchdog, the
    async service's rounds and every replica's steps (wraps
    ``ServiceWatchdog._respawn`` while in a ``with``)."""

    def __init__(self, replicas):
        self.replicas = replicas
        self.restores = []

    def __enter__(self):
        from repro_torch.resilience import failover
        self._original = original = failover.ServiceWatchdog._respawn
        log = self

        def respawn(watchdog, name):
            original(watchdog, name)
            if name in watchdog._down:      # the re-bind is retried later
                return
            program = watchdog._launcher.program
            log.restores.append({
                "service": name,
                "rounds": program.resolve("learner/param_service").rounds,
                "replica_steps": [
                    program.resolve(f"learner/replica_{i}").steps_taken
                    for i in range(log.replicas)]})
        failover.ServiceWatchdog._respawn = respawn
        return self

    def __exit__(self, *exc):
        from repro_torch.resilience import failover
        failover.ServiceWatchdog._respawn = self._original


def fig17_failover(torch, kernels, fig17):
    """Phase 22, part 1: fig17's policy with two async learner replicas on
    the card, with a chaos kill of replica 1 and of the parameter service
    under the reference's restart policy, then the same run without
    either.  Each replica's learner runs flash attention (twice a layer a
    step) and the inference node decodes (once a layer a decode batch), in
    this process: both counts are held exactly to the steps and batches the
    run's telemetry counted after the stop (a replica restored from a
    snapshot redoes the steps it lost, so its launches exceed the steps it
    reports)."""
    from repro_torch.experiments import ExperimentConfig
    from repro_torch.resilience import ChaosPolicy, RestartPolicy

    layers = FIG17_POLICY["num_layers"]
    replicas = FIG17_FAILOVER["num_learner_replicas"]
    out = {}
    for name, resilience in (
            ("with_failover", dict(
                restart_policy=RestartPolicy(max_restarts=3),
                chaos=ChaosPolicy(kill_after_steps=FIG17_KILL_AFTER,
                                  kill_targets=FIG17_KILL_TARGETS,
                                  max_kills=1))),
            ("without_failover", {})):
        config = ExperimentConfig(
            builder_factory=CardBuilder("policy", **FIG17_POLICY),
            environment_factory=catch_env, seed=SEED, eval_episodes=0,
            launcher="multiprocess", inference="server", telemetry=True,
            **FIG17_FAILOVER, **resilience)
        with RestoreLog(replicas) as restores:
            result, entry = distributed_run(
                torch, kernels, config, num_actors=FIG17_ACTORS,
                max_actor_steps=FIG17_STEPS, timeout_s=FIG17_TIMEOUT_S)
        merged = result.extras["telemetry"]["merged"]
        learners = result.extras["learners"]
        executed = merged["learner/step_ms"]["count"]
        decode_batches = merged["inference/engine/decode_ms"]["count"]
        entry.update({
            "resilience": result.extras.get("resilience"),
            "restores": restores.restores,
            "learner_steps_executed": executed,
            "decode_batches": decode_batches,
            "learner_steps_per_s_a_replica": [
                n / entry["walltime_s"]
                for n in learners["per_replica_steps"]],
            "pushes": learners["service"]["pushes"],
            "pulls": learners["service"]["pulls"],
            "push_staleness": histogram_summary(
                merged, "learner/push_staleness"),
            "pull_age_steps": histogram_summary(
                merged, "learner/pull_age_steps"),
            "snapshot_ms": histogram_summary(merged,
                                             "resilience/snapshot_ms"),
            "snapshot_ms_by_service": {
                key.rsplit("resilience/snapshot_ms/", 1)[1]:
                    histogram_summary(merged, key)
                for key in merged
                if key.startswith("resilience/snapshot_ms/")},
            "restore_ms": histogram_summary(merged, "resilience/restore_ms"),
        })
        log(f"  fig17 async, {name}: {json.dumps(entry)}")
        launches = entry["launches"]
        check(entry["actor_steps"] >= FIG17_STEPS, f"fig17 {name}: "
              f"{entry['actor_steps']} actor steps")
        check(all(n > 0 for n in learners["per_replica_steps"])
              and learners["sync"] == "async" and learners["rounds"] >= 1,
              f"fig17 {name}: {learners}")
        check(launches["flash_attention"] == 2 * layers * executed
              and executed >= sum(learners["per_replica_steps"]),
              f"fig17 {name}: {launches['flash_attention']} flash launches "
              f"for {executed} learner steps executed "
              f"({learners['per_replica_steps']} kept) of {layers} layers")
        check(launches["decode_attention"] == layers * decode_batches > 0,
              f"fig17 {name}: {launches['decode_attention']} decode "
              f"launches for {decode_batches} decode batches")
        check(launches["vtrace"] == launches["ssd_scan"] == 0,
              f"fig17 {name} launched a kernel of another slice: {launches}")
        if resilience:
            stats = entry["resilience"]
            check(stats["service_restarts"]
                  == {target: 1 for target in FIG17_KILL_TARGETS}
                  and stats["restarts"] == {},
                  f"fig17 {name}: restarts {stats}")
            check(sorted(r["service"] for r in restores.restores)
                  == sorted(FIG17_KILL_TARGETS),
                  f"fig17 {name}: restores {restores.restores}")
            last = restores.restores[-1]
            service = next(r for r in restores.restores
                           if r["service"] == "learner/param_service")
            check(learners["rounds"] > service["rounds"],
                  f"fig17 {name}: rounds {learners['rounds']} not past "
                  f"{service['rounds']} at the service's restore")
            check(all(n > at for n, at in zip(learners["per_replica_steps"],
                                              last["replica_steps"])),
                  f"fig17 {name}: a replica did not step after the last "
                  f"restore: {learners['per_replica_steps']} vs "
                  f"{last['replica_steps']}")
            check(entry["snapshot_ms"] is not None
                  and entry["restore_ms"]["count"] == 2,
                  f"fig17 {name}: snapshots {entry['snapshot_ms']}, "
                  f"restores {entry['restore_ms']}")
        out[name] = entry
    alone = fig17["learner_step_ms_p50_alone"]
    out["learner_step_ms_p50"] = {
        "with_failover": out["with_failover"].get("learner_step_ms_p50"),
        "without_failover": out["without_failover"].get(
            "learner_step_ms_p50"),
        "phase_20_server": fig17["server"].get("learner_step_ms_p50"),
        "phase_14_alone": alone}
    log(f"  fig17 async: learner step host ms p50 "
        f"{json.dumps(out['learner_step_ms_p50'])}; snapshot ms "
        f"{json.dumps(out['with_failover']['snapshot_ms'])}")
    return out


def resilience_acceptances(torch, kernels):
    """Phase 22, part 2: the reference's four resilience acceptances with
    the port's DQN on the card, their mechanics held as the reference's
    tests hold them; the -0.6 learning gate where RESILIENCE_ACCEPTANCES
    says, and every final eval printed."""
    from repro_torch.experiments import ExperimentConfig
    from repro_torch.resilience import CRASH, ChaosPolicy, RestartPolicy

    out = {}
    for name, (chaos, knobs, timeout, gated) in \
            RESILIENCE_ACCEPTANCES.items():
        if chaos is not None:
            knobs = dict(knobs, restart_policy=RestartPolicy(max_restarts=3),
                         chaos=ChaosPolicy(max_kills=1, **chaos))
        config = ExperimentConfig(
            builder_factory=CardBuilder("dqn", **DQN_SMOKE),
            environment_factory=catch_env, seed=SEED, eval_episodes=20,
            launcher="multiprocess", telemetry=True, **knobs)
        result, entry = distributed_run(
            torch, kernels, config, num_actors=DIST_ACTORS,
            max_actor_steps=DIST_STEPS, timeout_s=timeout)
        stats = result.extras.get("resilience", {})
        entry["resilience"] = stats
        log(f"  {name}: {json.dumps(entry)}")
        check(entry["actor_steps"] >= DIST_STEPS, f"{name}: {entry}")
        check(all(n == 0 for n in entry["launches"].values()),
              f"{name} launched a kernel: {entry['launches']}")
        learners = entry.get("learners", {})
        if name == "chaos_kill_actor":
            check(stats["restarts"].get("actor/0") == 1
                  and CRASH in stats["exit_kinds"]["actor/0"],
                  f"{name}: {stats}")
        elif name == "failover_kill_shard_and_replica":
            check(all(stats["service_restarts"].get(target) == 1
                      and CRASH in stats["service_exit_kinds"][target]
                      for target in chaos["kill_targets"])
                  and stats["restarts"] == {} and learners["rounds"] > 0,
                  f"{name}: {stats}, {learners}")
        elif name == "failover_kill_async_param_service":
            check(stats["service_restarts"].get("learner/param_service") == 1
                  and stats["restarts"] == {}
                  and learners["sync"] == "async" and learners["rounds"] > 0
                  and all(n > 0 for n in learners["per_replica_steps"]),
                  f"{name}: {stats}, {learners}")
        else:
            check(entry["learner_steps"] > 50
                  and learners["num_replicas"] == 2
                  and learners["sync"] == "async" and learners["rounds"] >= 1
                  and learners["service"]["pushes"] >= 2
                  and all(n > 0 for n in learners["per_replica_steps"])
                  and all(n > 0 for n in entry["per_shard_samples"]),
                  f"{name}: {learners}, {entry.get('per_shard_samples')}")
        final = result.final_eval_return
        check(final is not None, f"{name}: no final eval")
        if gated:
            check(final > CATCH_FLOOR,
                  f"{name}: final eval {final}, not > {CATCH_FLOOR}")
        out[name] = entry
    return out


class SlowLearner:
    """fig20's straggler: a learner whose every step sleeps first."""

    def __init__(self, inner, sleep_s):
        self.inner = inner
        self.sleep_s = sleep_s

    def step(self):
        time.sleep(self.sleep_s)
        return self.inner.step()

    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        self.inner.state = value

    def get_variables(self, names=("policy",)):
        return self.inner.get_variables(names)


class SlowFirstReplicaBuilder:
    """fig20's builder: the first learner it makes (replica 0) is a
    ``SlowLearner``; everything else passes through."""

    def __init__(self, inner, sleep_s):
        self.inner = inner
        self.sleep_s = sleep_s
        self.learners_made = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def make_learner(self, dataset, **kwargs):
        learner = self.inner.make_learner(dataset, **kwargs)
        self.learners_made += 1
        if self.learners_made == 1:
            return SlowLearner(learner, self.sleep_s)
        return learner


def fig20_async_learner(torch):
    """Phase 22, part 3: fig20's measurement on the card (its smoke
    window): aggregate learner steps a second of two DQN replicas, one a
    straggler, under barrier and under async sync."""
    from repro_torch.agents.builders import make_distributed_agent
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.core import make_environment_spec

    out = {}
    for sync in ("barrier", "async"):
        spec = make_environment_spec(catch_env(0))
        builder = SlowFirstReplicaBuilder(
            DQNBuilder(spec, DQNConfig(**FIG20_DQN), seed=0, device="cuda"),
            FIG20_SLOW_STEP_S)
        dist = make_distributed_agent(
            builder, catch_env, num_actors=1, seed=0,
            num_learner_replicas=2, learner_average_period=FIG20_AVERAGE_PERIOD,
            learner_sync=sync)
        try:
            t0 = time.time()
            while time.time() - t0 < FIG20_WARMUP_TIMEOUT_S:
                steps = dist.learner_stats()["per_replica_steps"]
                if all(n >= FIG20_WARMUP_STEPS for n in steps):
                    break
                time.sleep(0.1)
            start = dist.learner_stats()["per_replica_steps"]
            t1 = time.time()
            time.sleep(FIG20_MEASURE_S)
            end = dist.learner_stats()
            wall = time.time() - t1
        finally:
            dist.stop()
        per_replica = [e - b for b, e in zip(start,
                                             end["per_replica_steps"])]
        out[sync] = {"sgd_per_s": sum(per_replica) / wall,
                     "per_replica": per_replica, "rounds": end["rounds"],
                     "window_s": wall}
        check(all(n >= FIG20_WARMUP_STEPS for n in start),
              f"fig20 {sync}: replicas never warmed up: {start}")
        check(all(n > 0 for n in per_replica) and end["rounds"] >= 1,
              f"fig20 {sync}: {out[sync]}")
    out["async_over_barrier"] = (out["async"]["sgd_per_s"]
                                 / max(out["barrier"]["sgd_per_s"], 1e-9))
    log(f"  fig20 on the card: {json.dumps(out)}")
    check(out["async_over_barrier"] >= FIG20_MIN_SPEEDUP,
          f"fig20: async moved {out['async_over_barrier']:.2f}x the barrier "
          f"fleet's learner steps, under {FIG20_MIN_SPEEDUP}x")
    return out


def blends_card_vs_cpu(torch):
    """Phase 22, part 4: ``weighted_average_states`` and the async
    service's three merges of three DQN states (stepped apart on the CPU
    from different seeds and batches) blend to the same bits on the card
    as on the CPU; a one-replica async MultiLearner on the card is the
    plain learner after ONE_REPLICA_STEPS steps, bit for bit."""
    from repro_torch import tree
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.core import make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.learners import (AsyncParameterService, MultiLearner,
                                      weighted_average_states)
    spec = make_environment_spec(Catch(seed=0))
    cpu_states = []
    for r in range(3):
        learner = DQNBuilder(spec, DQNConfig(**DQN_QUICKSTART), seed=r,
                             device="cpu").make_learner(
            iter(dqn_batches(r + 2)))
        for _ in range(r + 2):
            learner.step()
        cpu_states.append(learner.state)
    blends = {}
    for label, device in (("card", "cuda"), ("cpu", "cpu")):
        states = [tree.map(lambda x: x.to(device), s) for s in cpu_states]
        blends[(label, "weighted")] = weighted_average_states(
            states, BLEND_WEIGHTS)
        for merge in ("mean", "ema", "step_weighted"):
            service = AsyncParameterService(3, merge=merge)
            for rid, (state, step) in enumerate(zip(states, BLEND_STEPS)):
                service.push(rid, state, step)
            blends[(label, merge)] = service.pull()
    out = {}
    for merge in ("weighted", "mean", "ema", "step_weighted"):
        pairs = list(zip(tree.leaves(blends[("card", merge)]),
                         tree.leaves(blends[("cpu", merge)])))
        equal = all(x.device.type == "cuda" and x.dtype == y.dtype
                    and torch.equal(x.cpu(), y) for x, y in pairs)
        out[merge] = {"leaves": len(pairs), "bit_equal": equal}
        check(equal, f"the {merge} blend on the card differs from the CPU's")
    builder = DQNBuilder(spec, DQNConfig(**DQN_QUICKSTART), seed=SEED,
                         device="cuda")
    batches = dqn_batches(ONE_REPLICA_STEPS)
    plain = builder.make_learner(iter(list(batches)))
    multi = MultiLearner([builder.make_learner(iter(list(batches)))],
                         average_period=4,
                         async_service=AsyncParameterService(1))
    for _ in range(ONE_REPLICA_STEPS):
        plain.step()
        multi.step()
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(plain.state), tree.leaves(multi.state)))
    check(same, "one-replica async MultiLearner differs from the plain "
          "learner on the card")
    out["one_replica_async_bit_identical_steps"] = ONE_REPLICA_STEPS
    log(f"  blends card vs CPU: {json.dumps(out)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    start = time.monotonic()

    def phase(message):
        """A phase's heading, with the seconds since the script began."""
        log(f"{message} [t = {time.monotonic() - start:.1f} s]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import configs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as decode_module
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import ssd_scan as ssd_module
    from repro_torch.kernels import vtrace as vtrace_module
    from repro_torch.policies import TransformerPolicyConfig
    from repro_torch.policies.engine import _bucket

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    kernels = [{"name": wrapper.name, "wrapper": wrapper,
                "source": module.SOURCE, "replaces": module.REPLACES}
               for module, wrapper in (
                   (decode_module, decode_module.decode_attention),
                   (vtrace_module, vtrace_module.vtrace),
                   (flash_module, flash_module.flash_attention),
                   (ssd_module, ssd_module.ssd_scan))]
    zamba = configs.get_arch(ZAMBA)

    phase("phase 1: build")
    t0 = time.monotonic()
    report = build.build([k["name"] for k in kernels])
    log(f"  built {len(report)} kernel libraries in "
        f"{time.monotonic() - t0:.2f} s")
    for name, entry in report.items():
        usage = [line.strip() for line in entry["log"].splitlines()
                 if "registers" in line or "spill" in line]
        log(f"  {name}: nvcc {entry['seconds']:.2f} s; ptxas: "
            f"{'; '.join(sorted(set(usage)))}")

    phase("phase 2: kernels against their plain versions")
    decode = decode_module.decode_attention
    vtrace = vtrace_module.vtrace
    plan_splits = decode_module.plan_splits
    worst = check_decode_attention(decode, ref, torch, plan_splits,
                                   decode_module.HEAD_DIMS)
    worst_vtrace = check_vtrace(vtrace, ref, torch)
    flash = flash_module.flash_attention
    ssd = ssd_module.ssd_scan
    worst_flash = check_flash(flash, ref, torch, zamba)
    worst_ssd = check_ssd(ssd, ref, torch, zamba)

    policy_cfg = TransformerPolicyConfig(
        **POLICY, epsilon=0.1, backend="auto")
    phase("phase 3: engine parity (kernel vs plain) at the served width")
    engine_parity(torch, TransformerPolicyConfig(**POLICY, epsilon=0.0))

    phase(f"phase 4: serving path — {CLIENTS} Catch clients x {EPISODES} "
        f"episodes through TransformerInferenceServer")
    path = serving_path(torch, policy_cfg, kernels)

    phase("phase 5: timing at the main paths' shapes")
    floor = launch_floor(torch)
    log(f"  launch floor (one add_ on one element) {json.dumps(floor)}")
    stats = path["stats"]
    rows = _bucket(math.ceil(stats["decode_rows"] / stats["decode_batches"]))
    timed = time_decode_attention(decode, ref, torch, plan_splits, rows,
                                  POLICY["window"], POLICY["window"])
    log(f"  decode_attention {json.dumps(timed)}; "
        f"{timed['ms'] / floor['launch_floor_ms']:.2f}x the launch floor")
    long_cache = time_decode_attention(decode, ref, torch, plan_splits, 64,
                                       2048, 2048)
    log(f"  decode_attention, long cache (not on the main path) "
        f"{json.dumps(long_cache)}; "
        f"{long_cache['bound_ms'] / long_cache['ms']:.3f} of its bound")
    check(long_cache["ms"] <= long_cache["plain_ms"]
          and long_cache["ms"] <= long_cache["library_ms"],
          f"decode_attention at the long cache: {long_cache['ms']} ms, slower "
          f"than its plain version ({long_cache['plain_ms']} ms) or "
          f"scaled_dot_product_attention ({long_cache['library_ms']} ms)")
    vtrace_timed = {}
    for T, B, batch_major in VTRACE_TIMED:
        entry = time_vtrace(vtrace, ref, torch, T, B, batch_major)
        vtrace_timed[(T, B, batch_major)] = entry
        log(f"  vtrace {json.dumps(entry)}; "
            f"{entry['ms'] / floor['launch_floor_ms']:.2f}x the launch floor, "
            f"{entry['bound_ms'] / entry['ms']:.3f} of its bound")
    flash_timed = time_flash(flash, ref, torch, zamba)
    log(f"  flash_attention {json.dumps(flash_timed)}")
    flash_policy = time_flash_policy(flash, ref, torch)
    log(f"  flash_attention at the policy learner's shape "
        f"{json.dumps(flash_policy)}; "
        f"{flash_policy['ms'] / floor['launch_floor_ms']:.2f}x the launch "
        f"floor")
    ssd_timed = time_ssd(ssd, ref, torch, zamba)
    log(f"  ssd_scan {json.dumps(ssd_timed)}")

    phase(f"phase 6: IMPALA path — make_agent(IMPALABuilder) over "
        f"{IMPALA_ENVS} Catch envs, {IMPALA_EPISODES} episodes")
    impala = impala_path(torch, kernels)

    phase("phase 7: IMPALA learner parity (V-trace kernel vs plain)")
    learner_parity(torch, vtrace)

    phase("phase 8: IMPALA learns Catch (the reference's acceptance)")
    learning(torch, vtrace)

    phase(f"phase 9: scoring path — make_prefill_step({ZAMBA}) at full width "
        f"and depth, {ZAMBA_BATCHES} batches of {ZAMBA_BATCH} x {ZAMBA_SEQ} "
        f"tokens")
    scoring = zamba2_path(torch, kernels, zamba)

    phase("phase 10: scoring path, kernel route vs plain route")
    zamba2_parity(torch, zamba, scoring)

    phase(f"phase 11: DQN path — run_experiment with the quickstart's config "
        f"on the card, {DQN_EPISODES} episodes")
    dqn = dqn_path(torch, kernels)
    dqn["profile"] = dqn_profile(torch)
    log(f"  dqn_path {json.dumps(dqn)}")

    phase("phase 12: DQN learner parity (card vs CPU), and where a step's "
        "time goes")
    dqn_learner_parity(torch)
    dqn["steps"] = dqn_step_profile(torch)
    log(f"  dqn_steps {json.dumps(dqn['steps'])}")

    phase("phase 13: gradients through flash attention and the SSD scan")
    grads = kernel_grads(torch, kernels, zamba)

    phase(f"phase 14: the transformer policy learns Catch on the card — "
        f"run_experiment(TransformerPolicyBuilder), the reference "
        f"acceptance's preset, {POLICY_EPISODES} episodes; then the learner "
        f"at the served width")
    policy = policy_path(torch, kernels)
    policy["fig17_learner"] = policy_learner_profile(torch, kernels)
    log(f"  policy_path {json.dumps(policy)}")

    phase("phase 15: the transformer policy's learner, card vs CPU")
    policy["parity"] = policy_learner_parity(torch)

    phase("phase 16: R2D2, DQfD and R2D3 learn on the card (the reference's "
        "acceptances)")
    sequence_agents(torch, kernels)

    # phases 17-19 run none of the four kernels: each zeros the launch
    # counts before it and holds them at 0 after
    for number, heading, run in (
            (17, f"phase 17: continuous control on the card — the D4PG "
             f"acceptance ({D4PG_EPISODES} episodes), MPO and DMPO",
             continuous_control),
            (18, "phase 18: DDPG, D4PG, MPO and DMPO learners at full width, "
             "card vs CPU, and their step times",
             lambda torch, kernels: continuous_parity(torch)),
            (19, "phase 19: offline (BC, run_offline_experiment, offline "
             "DQN) and planning (MCTS) on the card", offline_and_planning)):
        phase(heading)
        zero_launches(kernels)
        result = run(torch, kernels)
        launches = kernel_launches(kernels)
        check(all(n == 0 for n in launches.values()),
              f"phase {number} launched a kernel: {launches}")
        log(f"  phase {number} {json.dumps(result)}")

    phase(f"phase 20: fig17's inference placement at d_model 256 — "
          f"{FIG17_ACTORS} actor processes, {FIG17_STEPS} actor steps, "
          f"inference 'server' then 'local'; the reference's server "
          f"acceptances")
    fig17 = fig17_placement(torch, kernels, policy)

    phase("phase 21: distributed DQN on the card — the reference's "
          "multiprocess and two-replica acceptances, one replica vs the "
          "plain learner")
    zero_launches(kernels)
    dist_dqn = distributed_dqn(torch, kernels)
    launches = kernel_launches(kernels)
    check(all(n == 0 for n in launches.values()),
          f"phase 21 launched a kernel: {launches}")

    phase(f"phase 22: fault tolerance on the card — fig17's policy with two "
          f"async replicas, {FIG17_ACTORS} actor processes, {FIG17_STEPS} "
          f"actor steps, chaos kills of {' and '.join(FIG17_KILL_TARGETS)} "
          f"and a run without; the reference's four resilience "
          f"acceptances; fig20's async vs barrier; blends card vs CPU")
    failover = {"fig17": fig17_failover(torch, kernels, fig17),
                "acceptances": resilience_acceptances(torch, kernels)}
    zero_launches(kernels)
    failover["fig20"] = fig20_async_learner(torch)
    failover["blends"] = blends_card_vs_cpu(torch)
    launches = kernel_launches(kernels)
    check(all(n == 0 for n in launches.values()),
          f"phase 22's fig20 and blends launched a kernel: {launches}")

    vtrace_main = vtrace_timed[VTRACE_TIMED[0]]
    kernel_lines = [{
        "name": "decode_attention", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": path["launches"]["decode_attention"],
        "max_abs_err": max(worst["float32"], timed["max_abs_err_timed"]),
        "max_abs_err_bf16": worst["bfloat16"],
        "ms": timed["ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"], "eager_ms": timed["eager_ms"],
        "eager_plain_ms": timed["eager_plain_ms"],
        "eager_library_ms": timed["eager_library_ms"],
        "cuda_launches_per_call": timed["cuda_launches_per_call"],
        "shape": timed["shape"],
        "launches_by_path": {
            "serving": path["launches"]["decode_attention"],
            "transformer_policy_catch": policy["launches"][
                "decode_attention"],
            "fig17_server": fig17["server"]["launches"]["decode_attention"],
            "fig17_local_parent": fig17["local"]["launches"][
                "decode_attention"],
            "fig17_async_failover": failover["fig17"]["with_failover"][
                "launches"]["decode_attention"]},
        "launches_per_acting_call_fig17": policy["fig17_learner"][
            "decode_launches_per_acting_call"],
        "long_cache": {key: long_cache[key] for key in (
            "shape", "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "cuda_launches_per_call", "device_ms_by_kernel",
            "max_abs_err_timed") if key in long_cache},
    }, {
        "name": "vtrace", "route": "cuda",
        "source": kernels[1]["source"], "replaces": kernels[1]["replaces"],
        "launches": impala["launches"]["vtrace"],
        "max_abs_err": max([worst_vtrace] + [
            t["max_abs_err_timed"] for t in vtrace_timed.values()]),
        "ms": vtrace_main["ms"], "plain_ms": vtrace_main["plain_ms"],
        "bound_ms": vtrace_main["bound_ms"],
        "bound_by": vtrace_main["bound_by"], "library_ms": None,
        "eager_ms": vtrace_main["eager_ms"],
        "eager_plain_ms": vtrace_main["eager_plain_ms"],
        "cuda_launches_per_call": vtrace_main["cuda_launches_per_call"],
        "shape": vtrace_main["shape"],
        "timed_shapes": [
            {key: entry[key] for key in ("shape", "ms", "eager_ms",
                                         "plain_ms", "bound_ms",
                                         "max_abs_err_timed")}
            for entry in vtrace_timed.values()],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": kernels[2]["source"], "replaces": kernels[2]["replaces"],
        "launches": scoring["launches"]["flash_attention"],
        "max_abs_err": max(worst_flash["float32"],
                           flash_timed["max_abs_err_timed"]),
        "max_abs_err_bf16": worst_flash["bfloat16"],
        "ms": flash_timed["ms"], "plain_ms": flash_timed["plain_ms"],
        "bound_ms": flash_timed["bound_ms"],
        "bound_by": flash_timed["bound_by"],
        "bound_tc_ms": flash_timed["bound_tc_ms"],
        "library_ms": flash_timed["library_ms"],
        "eager_ms": flash_timed["eager_ms"],
        "eager_plain_ms": flash_timed["eager_plain_ms"],
        "eager_library_ms": flash_timed["eager_library_ms"],
        "shape": flash_timed["shape"],
        "grad_path_launches": (
            grads["q_sequence"]["launches"]["flash_attention"]
            + grads["zamba2_reduced"]["launches"]["flash_attention"]),
        "backward": grads["flash_attention"],
        "launches_by_path": {
            "scoring": scoring["launches"]["flash_attention"],
            "transformer_policy_catch": policy["launches"][
                "flash_attention"],
            "fig17_server": fig17["server"]["launches"]["flash_attention"],
            "fig17_local": fig17["local"]["launches"]["flash_attention"],
            "fig17_async_failover": failover["fig17"]["with_failover"][
                "launches"]["flash_attention"]},
        "policy_learner": dict(flash_policy, launches_per_learner_step=(
            policy["fig17_learner"]["flash_launches_per_learner_step"])),
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": kernels[3]["source"], "replaces": kernels[3]["replaces"],
        "launches": scoring["launches"]["ssd_scan"],
        "max_abs_err": ssd_timed["max_abs_err_timed"],
        "max_scaled_err": max(worst_ssd, ssd_timed["max_scaled_err_timed"]),
        "ms": ssd_timed["ms"], "plain_ms": ssd_timed["plain_ms"],
        "bound_ms": ssd_timed["bound_ms"], "bound_by": ssd_timed["bound_by"],
        "bound_tc_ms": ssd_timed["bound_tc_ms"],
        "cuda_launches_per_call": ssd_timed["cuda_launches_per_call"],
        "library_ms": None, "eager_ms": ssd_timed["eager_ms"],
        "eager_plain_ms": ssd_timed["eager_plain_ms"],
        "shape": ssd_timed["shape"],
        "grad_path_launches": grads["zamba2_reduced"]["launches"][
            "ssd_scan"],
        "backward": grads["ssd_scan"],
    }]
    log(f"  phase 21 {json.dumps(dist_dqn)}")
    log(f"  phase 22 {json.dumps(failover)}")
    log(f"all phases passed in {time.monotonic() - start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernel_lines, **floor}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
