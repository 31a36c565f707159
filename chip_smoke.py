"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   with nvcc, one process per source, all started together (the two
   backward kernels' libraries finish in a thread beside phases 2-12,
   which launch neither, and phase 13 waits for them and reports their
   entries' registers and spills); the flash and SSD libraries' entries
   with ptxas's registers, spills and shared memory, and the HGMMA
   instructions in each entry's SASS (cuobjdump; "not measured" where the
   toolkit has none); the SSD scan's main-path entries (forward here,
   backward in phase 13) must spill nothing and hold HGMMA;
2. hold each kernel against its plain PyTorch version on the card: decode
   attention at the serve shapes, the sweep shapes, a ragged cache, fully
   masked rows, caches of 1 key, of one tile and of one split and one key
   either side of them, long caches over several splits with lengths at
   the splits' edges, inside the first split and 0, 1 to 8 query heads a
   KV head (and 12, two head blocks) at every head dim, and a second call
   at another split plan that must not read the first call's partials;
   decode attention over a bfloat16 cache under float32 queries (b 1 and
   8, s 1, 384 and 1500, 1, 2, 3 and 6 query heads a KV head, d 64 and
   128, and Whisper's cross-attention shape) against the plain version on
   the upcast cache (1e-4), each call requesting from the allocator no
   more than its output and partials (no cache-sized copy);
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
   designs' edges in both dtypes: sq, sk around each route's warp, block
   and key tiles and one past its ring (the bf16 route at every head dim,
   the f32 route at d 64 and d 128), windows that end inside a key tile,
   the model's strided views (equal to contiguous copies) and one key per
   query with distinct V rows, which a wrong key order between P and V
   would show, and at the
   model zoo's shapes (phase 23): Whisper's encoder (b 4, h 8, s 1500, d
   64, non-causal, its last key tile ragged) and cross-attention (sq 448
   over sk 1500), qwen3-1.7b's GQA 16/8 at d 128 (s 2048, causal), in
   float32 and bfloat16, and internvl2-26b's GQA 48/8 at d 128 in
   bfloat16 (the same tolerances); the SSD scan at the sweep shapes, d_state 128, the Zamba2
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
   after, and every decode batch must have launched the decode kernel
   once per layer and every prefill batch flash attention once per layer;
5. time the launch floor (one ``add_(1)`` on a one-element tensor), then
   each kernel, its plain version and, where one exists, one PyTorch
   library call for the same function, at the main paths' shapes, beside
   the least time the card could take: CUDA events over 200 calls, median
   of 5 (20 calls for flash attention and the SSD scan at the Zamba2
   path's shapes, flash attention on the model's strided views, and for
   V-trace's plain version, a Python loop over T), both
   replayed from a CUDA graph (device time: ``ms``) and called eagerly
   (with the host's per-call cost: ``eager_ms``).  Flash attention and the
   SSD scan also carry their tensor-core bound (``bound_tc_ms``: three
   TF32 passes at 495 TFLOP/s) and, for the SSD scan, the CUDA kernels one
   call launches (3: the chunk launch, state passing, the output), each
   launch's device ms, and a second row at the training shape keeping its
   scratch for the backward, counted by torch.profiler (``cuda_launches_per_call``,
   also for decode attention and V-trace); decode attention is also timed
   at a long cache (b 64, s 2048) and V-trace at shapes up to
   (100, 65536), beyond L2, in both layouts; flash attention fails the run
   if it is slower than ``scaled_dot_product_attention`` on the same
   inputs, and decode attention at the long cache if it is slower than its
   plain version or than ``scaled_dot_product_attention``; flash attention
   is also timed at the transformer policy learner's shape (b 16, h 4,
   kv 2, s 16, d 64, window 8) beside ``scaled_dot_product_attention``
   with the same band as a mask, and at phase 2's four model-zoo shapes
   in their path's dtype beside ``scaled_dot_product_attention`` (K/V
   repeated to the query heads before timing) and, in bfloat16, the
   native bf16 tensor-core bound (989 TFLOP/s), each row with the kernel's
   route, its entry's registers, spills, shared memory and HGMMA
   instructions; there a kernel slower than the library call is reported,
   not failed;
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
   1.2 B parameters in float32 from seed 0 on the card's generator), 3
   batches of 4 requests x 2048
   tokens from ``numpy.random.RandomState(0)``; launch counts are zeroed
   just before and read just after those 3, and each step must launch
   flash attention 6 times and the SSD scan 38 times; then the same
   batches in turn up to 8 timed steps, for requests/s, tokens/s and the
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
   then profiles a 10-episode run of the same config for the device's idle
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
   (forward and backward kernels) against the same calls on the plain
   route; every leaf gets a grad within 1e-4 of the plain grad's largest
   magnitude; counts zeroed before and read after each, one flash launch
   and one flash backward launch per site and one SSD and one SSD backward
   launch per layer; then the backward kernels alone against their plain
   versions and against autograd of the plain forwards, every gradient
   within 1e-4 (f32) or 2e-2 (bf16) of its largest magnitude and a repeat
   call bit-equal: flash at FLASH_CASES x FLASH_MASKS in both dtypes (with
   past_keys' rows that see no key), the zoo's FLASH_ZOO shapes and the
   policy learner's s 16, with the forward's log-sum-exp held to its plain
   version; the SSD scan at SSD_CASES and SSD_CHUNKINGS with and without
   h0 in f32 and bf16; then, at the training path's shapes (Zamba2-1.2B
   at 4 x 1024 tokens), at qwen3-1.7b's d 128 (4 x 2048, f32 and bf16)
   and, for flash over every key, at Whisper-base's encoder (4 x 1500, f32),
   each backward kernel (CUDA graph and eager), its forward, its plain
   version and the plain recompute it replaced, and for flash
   ``scaled_dot_product_attention``'s backward in the path's dtype and in
   bf16 (K/V repeated), beside the bound; one call must launch the
   designs' CUDA kernels in order (3 for flash, 6 for the SSD scan);
14. the transformer policy learns Catch on the card: ``run_experiment``
   with ``TransformerPolicyBuilder`` at the reference acceptance's preset
   and schedule (``tests/conftest.py:67-70``, seed 0, 250 episodes, 20
   eval episodes, backend "auto", head dim 16); launch counts are zeroed
   just before and read just after: acting must launch the decode kernel
   and flash attention once a layer a window prefill, and every learner
   step flash attention twice a layer (the online pass through
   ``FlashAttentionFunction``, the target pass), and the final eval must
   beat the mean of the first 30 train returns (the reference's
   acceptance); then the learner alone at the served width (T 16, B 16):
   host ms a step (p50, p95), flash launches a step, flash launches of an
   episode's first acting call (its window prefill), decode launches and
   host ms of an acting call on the same weights, and the acting prefill
   (16 rows of window 8) on flash beside the same call on the masked
   softmax;
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
   (the multiprocess launcher) for 1500 actor steps (half of fig17's
   3000, for the script's time limit), once with
   ``inference="server"`` and once with ``"local"``, telemetry on; launch
   counts are zeroed just before each run and read just after, in this
   process: in server mode the inference node here must launch the decode
   kernel once a layer a decode batch and flash attention once a layer a
   prefill batch, and in both modes the learner here flash attention twice
   a layer a step (local-mode actors act in their own processes); prints env steps/s, the server's batches, rows a batch,
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
22. fault tolerance on the card: phase 20's policy in server mode, for
   1500 actor steps, with two learner replicas
   exchanging through the async parameter service every 10 steps (``learner_sync="async"``), once under the reference's
   ``RestartPolicy(max_restarts=3)`` with a chaos kill of
   ``learner/replica_1`` and ``learner/param_service`` at their 10th step
   or push/pull, and once without either: each target restored once from
   its snapshot, no worker restarted, the rounds and both replicas'
   steps growing after the restores, flash launches exactly twice a layer
   a learner step executed and once a layer a prefill batch, and decode
   launches once a layer a decode batch (all counted by the run's
   telemetry after the stop); prints env
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
   learner after 10 steps;
23. the model zoo's scoring path: ``make_prefill_step`` over
   ``transformer.init`` (drawn from seed 0 on the card's generator) of one
   config of each remaining family at full width and depth:
   qwen3-1.7b (dense, float32, 4 x 2048 tokens), granite-moe-3b-a800m
   (MoE, float32, 4 x 2048), whisper-base (audio, float32, 4 x 448 text
   tokens over 1500 frames) and internvl2-26b (VLM, bfloat16: its 79.4 GB
   of float32 weights do not fit; 4 x (256 vision + 1792 text)), 3
   batches each from ``numpy.random.RandomState(0)``: launch counts are
   zeroed just before and read just after, and each step must launch
   flash attention 28, 32, 18 (6 encoder, 6 causal, 6 cross) and 48
   times; then the same batches in turn up to 5 timed steps, for
   requests/s, tokens/s, step p50/p95, peak memory, the seconds of init
   and a profile of one step; the first batch again on the plain route,
   by phase 10's rule (float32: 1e-4 of the largest plain |logit|;
   bfloat16: 5e-2, from the measured difference), and for MoE the router
   choices that differ between the two routes (a token that some layer
   routes to another expert on one route, a near-tie that rounding
   decides, is left out of the rule and counted); each model is freed before
   the next (Zamba2's phase-9 weights went after phase 10); then a
   reduced config of each family on the card's kernel against the same
   weights on the CPU's plain version, by the same rule (1e-4);
24. the model zoo's serving path: ``BatchedServer.generate`` (weights from
   seed 0 on the card's generator, float32) at full width and depth for
   qwen3-1.7b (with a float32 cache, then ``init_cache``'s default
   bfloat16 cache), granite-moe-3b-a800m, mamba2-780m, zamba2-1.2b and
   whisper-base, and internvl2-26b in bfloat16 through BatchedServer's
   loop over ``make_serve_step`` (its float32 weights do not fit): 8 slots
   x 256 prompt tokens from ``numpy.random.RandomState(0)`` in one
   batched prefill for dense and MoE, 32 a serve step a token otherwise,
   then 32 greedy tokens; launch counts zeroed just before and read just after:
   the decode kernel once a layer a step (a shared-attention site for
   Zamba2, self and cross for Whisper, none for Mamba2), flash once a
   layer a batched prefill, the SSD scan and V-trace never; prefill and
   decode tokens/s and the decode steps' p50/p95, from CUDA events after
   each call of the generate, which syncs once (at its end), as users run
   it, and the step at the cache's last position synced after each call
   beside the same unsynced; peak memory, the bytes one decode step
   requests (under the bfloat16 cache less than one layer's K and V in
   float32: no cache-sized copy) and a profile of it with the idle share;
   the kernel route against the plain route teacher-forced on the same
   tokens by phase 10's rule at every step (MoE tokens a router sends
   elsewhere on one route left out and counted, at most 1%); the decode
   kernel at qwen3-1.7b's (float32 and bfloat16 cache) and internvl2-26b's
   serving shapes beside its bound and SDPA; fig17's tier 1 (batched
   prefill at least 4x one serve step a token, reduced qwen3-1.7b, 8 x 32
   tokens); and a reduced config of each family served on the card against
   the CPU (1e-4), under a float32 cache and under a bfloat16 cache; under
   the bfloat16 cache, whose rounding each device does on its own, the
   CPU's cache is copied to the card before each step, and the cache
   elements the two write differently are counted, with their largest gap
   over their leaf's largest |value|;
25. training: (a) ``repro_torch.launch.train.main`` as a user runs it on
   Zamba2-1.2B at full width and depth (``--full-size --steps 20 --batch
   4 --seq 1024``: float32, remat "none", Adam with a cosine schedule and
   clip 1.0, weights from seed 0 on the card's generator), each step
   timed by CUDA events: it must return 0 (the CE fell), and each step
   launch the SSD scan 38 times and flash attention 6 times; prints the
   CE first and last, steps/s, tokens/s, step p50/p95, the peak memory,
   then one more step under torch.profiler (device ms in GEMMs, in the
   flash and SSD kernels, and in their autograd Functions' backwards,
   the backward kernels; the idle share) with the optimizer update's own
   peak in param-sized copies, and the two backwards timed at the step's
   shapes; each step must also launch the SSD backward 38 times and flash
   attention's backward 6 times; (b) qwen3-1.7b at its published width and 4 of its 28
   layers (Adam's update holds ~11 param-sized float32 copies: the full
   depth would need ~89 GB) through ``make_train_step(remat="full",
   microbatches=2)``, 3 steps of 4 x 2048 tokens: flash launched 16 times
   a step (twice a layer a microbatch) and its backward 8, the first
   step's loss and grads
   (Adam's first moments) equal to remat "none"'s within 1e-6 of each
   leaf's largest, step ms and peak memory; (c) one ``remat="full"`` step
   of a reduced config of each family (and the DQN objective for dense
   and MoE) on the card against the CPU's plain versions from the same
   state: metrics, params, Adam's moments and the target within 1e-4 of
   each leaf's largest, exact launch counts, MoE tokens rerouted between
   the two routes at most 1%.
26. the launch layer: (a) ``make_host_mesh("cuda")`` is a (1, 1) mesh
   with the axes data and model on cuda:0 (phase 25's ``train.main``
   builds it and runs under its ``ShardingRules``), and a reduced
   qwen3-1.7b through ``train.main`` under it (5 steps of 4 x 64 tokens)
   gives every step's metrics and every param leaf bit-equal to the same
   run without rules, leaving no process group up, each run launching
   flash attention 10 times (2 layers x 5 steps) and the SSD scan none; (b) the dry run
   (``python -m repro_torch.launch.dryrun``) of whisper-base x decode_32k
   and x train_4k on the single production mesh (256 fake ranks, the
   plain route, the card hidden), each in a subprocess started at the
   phase's start: each record must be ``ok`` with 256 ranks, fit the
   card's 80 GB, name a dominant term and count FLOPs (the JAX package's
   dry-run test); prints each record's memory, roofline terms and trace
   seconds, and whether it traced within 60 s (a figure, not a gate: the
   trace's seconds follow the host's speed); (c) phase 25's step
   (Zamba2-1.2B, 4 x 1024 tokens, float32, remat "none", Adam with clip
   1.0) dry-run on a (1, 1) fake mesh: its predicted peak bytes and its
   update's peak in param-sized copies beside phase 25's measured ones,
   and ``total_memory`` beside ``HBM_PER_CHIP`` (no gate: the plain route
   keeps score tensors the kernels do not).

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
import re
import statistics
import subprocess
import sys
import tempfile
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
BF16_FLOPS_PER_S = 989e12
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
ZAMBA_TIMED_STEPS = 8
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
DQN_PROFILED_EPISODES = 10
DQN_PROFILED_STEPS = 50
# the card learner against the CPU learner after 10 steps, max |d| over
# the CPU's largest magnitude per leaf (TF32 off: the same f32 math in
# another summation order)
DQN_TOL = 1e-5
# Gradients through the kernels against the plain route's: max |d| over the
# plain gradient's largest magnitude per leaf, at the kernels' f32
# tolerance (the forward outputs differ by up to 1e-4); the backward
# kernels against their plain versions and autograd of the plain forwards
# by the same rule, GRAD_BF16_TOL in bf16 (P and dS rounded to bf16).
GRAD_TOL = 1e-4
GRAD_BF16_TOL = 2e-2
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
# the acting prefill timed on flash and on the masked softmax: one bucket of
# rows of the served policy's full window
POLICY_PREFILL_ROWS = 16
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
CONTINUOUS_TIMED_STEPS = 25
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
# processes, 1500 actor steps (fig17's 3000 halved: the script's time
# limit), no eval, each mode once; then the
# reference's two server acceptances (tests/test_policies.py:327-360) at
# the preset of phase 14 (backend "auto", so the server decodes on the
# kernel).
FIG17_POLICY = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                    head_dim=64, d_ff=512, window=8, sequence_length=16,
                    period=8, batch_size=16, min_replay_size=100,
                    samples_per_insert=0.0, backend="auto")
FIG17_ACTORS = 4
FIG17_STEPS = 1500
# phase 22's two fig17 runs (with failover and without): half of fig17's
# 3000, for the script's time limit.  The chaos kill of the parameter
# service lands at about its 5th exchange (each replica's step 25-35) and
# the check after it needs a round past the service's restore: at 750
# actor steps the replicas took 3-22 steps past the restore before the
# run ended, within one exchange period of 10, so a slow host could end
# the run before any round followed the restore.
FIG17_FAILOVER_STEPS = 1500
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
# "server", 4 actor processes) with two learner
# replicas exchanging through the async parameter service every 10 steps,
# run once with the reference's RestartPolicy(max_restarts=3) and a chaos
# kill of replica 1 and of the parameter service, and once without either
# (the like-for-like run the learner step's host ms is compared with).
# The replicas start once each shard holds min_replay_size sequences; the
# kill fires at replica 1's 10th step and at the service's 10th push or
# pull (5 exchanges), both early in the replicas' steps.
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

# Phase 23: the model zoo's scoring path, one config of each family at
# full width and depth (src/repro_torch/configs/*.py), random weights from
# SEED drawn on the card: (config, param dtype, flash launches a step: one
# a layer; Whisper's 6 encoder, 6 causal and 6 cross-attention calls).
# internvl2-26b's 19.9 B params take 79.4 GB in float32, more than the
# card holds beside its activations, so it runs in bfloat16 (39.7 GB).
ZOO = [("qwen3-1.7b", "float32", 28),
       ("granite-moe-3b-a800m", "float32", 32),
       ("whisper-base", "float32", 18),
       ("internvl2-26b", "bfloat16", 48)]
ZOO_BATCHES = 3
ZOO_BATCH = 4
ZOO_SEQ = 2048            # positions a request (the VLM's: vision + text)
WHISPER_TEXT = 448        # Whisper's decoder context, over 1500 frames
ZOO_TIMED_STEPS = 5       # the 3 counted batches, then the same in turn
# Kernel route vs plain route, the phase-10 rule: |d last_logits| <= this x
# the largest plain |logit|; greedy actions equal where the plain top-2
# margin exceeds twice that.  float32 as phase 10.  bfloat16 (the VLM):
# both routes round every attention output to bf16 (2^-8 relative steps),
# where their f32 sums differ in the last bits, and 48 layers of bf16
# GEMMs and residual adds carry those roundings on to logits that bf16
# itself holds only to 2^-8 (a step of 2 at the largest, ~350): measured
# 1.73e-2 on the first batch (6.0 of 346, 3 of those steps; NVIDIA H100
# 80GB HBM3, 700 W), so the bound is 5e-2, ~13 steps, which a wrong mask
# or key order (differences of the logits' own size) still far exceeds.
ZOO_LOGIT_REL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# an MoE token that some layer routes to another expert on the kernel route
# than on the plain one (a near-tie that rounding decides) is left out of
# that rule; at most this share of the positions may be (granite: 54 of
# 8192, 0.66%; NVIDIA H100 80GB HBM3, 700 W), since a wrong kernel
# reroutes most of them
MOE_REROUTED_MAX = 0.01
# Phase 24: token-by-token serving of every family at full width and
# depth, random weights from SEED on the card's generator: (config, param
# dtype, cache dtype, how it is driven).  ``BatchedServer`` draws float32
# params, as the JAX package's does; internvl2-26b's do not fit in float32
# (79.4 GB), so it runs in bfloat16 through ``make_serve_step`` directly,
# BatchedServer's loop.  qwen3-1.7b runs twice: with a float32 cache, and
# with ``init_cache``'s default bfloat16 cache under its float32 params.
SERVE_ZOO = [("qwen3-1.7b", "float32", "float32", "server"),
             ("qwen3-1.7b", "float32", "bfloat16", "server"),
             ("granite-moe-3b-a800m", "float32", "float32", "server"),
             ("mamba2-780m", "float32", "float32", "server"),
             ("zamba2-1.2b", "float32", "float32", "server"),
             ("whisper-base", "float32", "float32", "server"),
             ("internvl2-26b", "bfloat16", "bfloat16", "direct")]
SERVE_SLOTS = 8
# prompt tokens: one batched prefill for dense and MoE; the families that
# take a prompt a serve step a token (SSM, hybrid, audio, the VLM's loop)
# get a shorter one, and every family decodes SERVE_DECODE tokens: depth
# cut from 256 and 128 (and the parity check below from 32 and 16) for the
# script's time limit
SERVE_PROMPT = 256
SERVE_STEPPED_PROMPT = 32
SERVE_DECODE = 32
# steps at the cache's last position timed synced after each, then unsynced
SERVE_SYNC_STEPS = 8
# the kernel route against the plain route, teacher-forced on the timed
# run's tokens: the whole prompt where it is one batched prefill, else its
# first PARITY_PROMPT tokens a step each, then PARITY_STEPS decode steps
# (a step of the 48-layer VLM takes ~60-90 ms of host time on each route)
PARITY_PROMPT = 16
PARITY_STEPS = 8
# the decode kernel at the serving shapes (phase 5): (label, config, q
# dtype, cache dtype), b SERVE_SLOTS, a full cache of DECODE_SERVING_KEYS
# keys (256 prompt tokens and 128 decoded)
DECODE_SERVING_KEYS = 384
DECODE_SERVING = [("qwen3_1_7b", "qwen3-1.7b", "float32", "float32"),
                  ("qwen3_1_7b_bf16_cache", "qwen3-1.7b", "float32",
                   "bfloat16"),
                  ("internvl2_26b", "internvl2-26b", "bfloat16", "bfloat16")]
# fig17's tier 1 (benchmarks/fig17_transformer_serving.py:43-45,87-102,171):
# batched prefill at least 4x the prefill tokens/s of one serve step a
# token, BatchedServer on reduced qwen3-1.7b, 8 slots x 32 tokens, 20 timed
# prefills of each after one untimed
FIG17_PREFILL = dict(slots=8, length=32, iters=20, ratio=4.0)
# Phase 25: training.  (a) launch/train.py's ``main`` on Zamba2-1.2B at
# full width and depth, as a user runs it (float32, remat "none", one
# microbatch, Adam with a cosine schedule and clip 1.0), 4 x 1024 tokens:
# each sequence spans four 256-token SSD chunks.
TRAIN_ZAMBA_ARGV = ["--arch", ZAMBA, "--full-size", "--steps", "20",
                    "--batch", "4", "--seq", "1024"]
TRAIN_ZAMBA_STEPS = 20
TRAIN_ZAMBA_SHAPE = (4, 1024)
# (b) qwen3-1.7b at its published width (d_model 2048, 16/8 heads of 128,
# d_ff 6144, vocab 151,936) and 4 of its 28 layers: Adam's update holds ~11
# param-sized float32 copies, and the full depth's 2.03 B params (8.1 GB a
# copy) would need ~89 GB.  make_train_step(remat="full", microbatches=2)
# with train.py's optimizer, 3 steps of 4 x 2048 tokens; its first step's
# loss and grads (Adam's first moments, 0.1 x the clipped grads) equal
# remat="none"'s within TRAIN_REMAT_TOL of each leaf's largest magnitude
TRAIN_DENSE = "qwen3-1.7b"
TRAIN_DENSE_LAYERS = 4
TRAIN_DENSE_SHAPE = (4, 2048)
TRAIN_DENSE_STEPS = 3
TRAIN_DENSE_MICROBATCHES = 2
TRAIN_REMAT_TOL = 1e-6
# (c) one step of a reduced config of each family (and the DQN objective
# for dense and MoE) on the card's kernels against the CPU's plain
# versions from the same state: loss, params, Adam's moments and the
# target within TRAIN_CARD_TOL of each leaf's largest magnitude
TRAIN_FAMILIES = [("qwen3-1.7b", "bc"), ("qwen3-1.7b", "dqn"),
                  ("granite-moe-3b-a800m", "bc"),
                  ("granite-moe-3b-a800m", "dqn"), ("mamba2-780m", "bc"),
                  ("zamba2-1.2b", "bc"), ("internvl2-26b", "bc"),
                  ("whisper-base", "bc")]
TRAIN_REDUCED_SHAPE = (2, 64)
TRAIN_CARD_TOL = 1e-4
# Phase 26: the launch layer.  (a) a reduced qwen3-1.7b through train.main
# under the host mesh's rules against the same run without them; (b) the
# dry run in subprocesses with the card hidden (the reference test's combo,
# and one train_4k combo chosen to trace within LAUNCH_TRAIN_TRACE_S); (c)
# phase 25's own step dry-run on a (1, 1) fake mesh beside its measurement
LAUNCH_TRAIN_ARGV = ["--arch", "qwen3-1.7b", "--steps", "5", "--batch", "4",
                     "--seq", "64"]
LAUNCH_DRYRUNS = [("whisper-base", "decode_32k"), ("whisper-base", "train_4k")]
LAUNCH_TRAIN_TRACE_S = 60.0
LAUNCH_DRYRUN_TIMEOUT_S = 300
# flash attention at the zoo's attention shapes (phases 2 and 5): (label,
# b, h, kv, sq, sk, d, causal, the dtypes checked; the first is the path's,
# timed in phase 5).  Whisper's 1500 keys end inside a 64-key tile; f32
# holds each GQA grouping (2:1, 3:1, 6:1) at 1e-4.
FLASH_ZOO = [("whisper_encoder", 4, 8, 8, 1500, 1500, 64, False,
              ("float32", "bfloat16")),
             ("whisper_cross", 4, 8, 8, 448, 1500, 64, False,
              ("float32", "bfloat16")),
             ("qwen3_1_7b", 4, 16, 8, 2048, 2048, 128, True,
              ("float32", "bfloat16")),
             ("granite_moe", 4, 24, 8, 2048, 2048, 64, True,
              ("float32", "bfloat16")),
             ("internvl2_26b", 4, 48, 8, 2048, 2048, 128, True,
              ("bfloat16", "float32"))]

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
# phase 2, the designs' edges: flash at sq, sk around the f32 route's
# 16-row warp tiles and 64-row / 64-key block tiles and the bf16 route's
# 64-row warpgroups, 128-row / 128-key tiles and one past its ring (2
# stages at d 128, 3 below: 257 and 385 keys), in both dtypes at d 64, at
# the bf16 route's other head dims (FLASH_BF16_EDGES) and around the f32
# d-128 route's 32-key tiles and ring of 2 (FLASH_TF32_WGMMA_EDGES);
# windows that end inside a key tile; the SSD scan with one chunk, 16
# chunks, the ragged chunk 100 and d_state 128 over two state tiles:
# (label, b, s, h, p, n, chunk)
FLASH_EDGES = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 257, 385]
# phase 2, the persistent bf16 route (one block an SM walks work items of
# 128 query rows of one head): fewer items than SMs, more (ragged sq, GQA
# 6:1, sq != sk), windows that end inside a key tile, the model's strided
# views: (label, b, h, kv, sq, sk, d)
FLASH_PERSISTENT = [("one_item", 1, 1, 1, 1, 1, 128),
                    ("few_items", 1, 2, 1, 129, 129, 64),
                    ("items_288", 2, 48, 8, 300, 300, 128),
                    ("items_576", 3, 24, 8, 1000, 1000, 64),
                    ("sq_lt_sk", 2, 16, 8, 200, 700, 128),
                    ("sq_gt_sk", 2, 12, 2, 700, 200, 32)]
# phase 2, decode's cluster design: (b, kv, s, d) one key either side of
# the most splits one cluster holds (s 511 and 512: 8 splits; 513: 9, the
# combine launch) and of a tile boundary of the serving plan (s 383, 384
# and 385 at b 8, kv 8, d 128), every group size at d 128 and every head
# dim at the serving group (6), in all three dtype pairs; the whole group x
# head dim grid is in tests/test_torch_cuda.py
DECODE_CLUSTER_EDGES = [(7, 1, 511, 64), (7, 1, 512, 64), (7, 1, 513, 64),
                        (8, 8, 383, 128), (8, 8, 384, 128), (8, 8, 385, 128)]
DECODE_GROUPS = [1, 2, 3, 4, 5, 6, 7, 8, 12]
FLASH_BF16_EDGES = [1, 65, 129, 257, 385]
FLASH_TF32_WGMMA_EDGES = [1, 31, 32, 33, 63, 64, 65, 129]
FLASH_WINDOWS = [65, 100, 130]
# the flash kernel's routes (flash_attention.route) and the kernel entry
# each launches, as ptxas and cuobjdump name it
FLASH_ROUTE_KERNELS = {
    "wgmma_tma_bf16": "flash_attention_kernel_bf16_wgmmaILi{d}E",
    "tf32x3_split_once": "flash_attention_kernel_tf32_wgmma",
    "tf32x3": "flash_attention_kernelILi{d}E"}
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


def decode_bound(b, h, kv, s, d, lengths, itemsize, kv_itemsize=None):
    """Least time (ms) for these inputs: q and out once (``itemsize``
    bytes an element), the K and V rows each row attends to once (the
    valid prefix; all s keys when none is valid; ``kv_itemsize``, by
    default ``itemsize``), lengths once; two multiply-adds per key, head
    and channel."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    keys = sum(min(int(n), s) if n >= 1 else s for n in lengths)
    nbytes = (itemsize * 2 * b * h * d + kv_itemsize * 2 * keys * kv * d
              + 4 * b)
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
                f"s={s:<5d} d={d:<3d} "
                f"splits={plan_splits(b, kv, s, d, dtype)[0]:<3d}"
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


def check_decode_mixed(kernel, ref, torch, plan_splits):
    """A bfloat16 cache under float32 queries (``transformer.init_cache``'s
    default under float32 params): b in {1, 8}, s in {1, 384, 1500}, 1, 2,
    3 and 6 query heads a KV head, d in {64, 128}, lengths at s, 1 and
    random, and Whisper's cross-attention shape (b 8, h 8, 1500 keys, d
    64), against the plain version on the upcast cache (float32 tolerance).
    No cache-sized buffer may be allocated: the bytes a call requests from
    the allocator must be its output and the split plan's partials, which
    at s >= 384 stay below one layer's K and V."""
    from repro_torch.kernels.decode_attention import CLUSTER_MAX
    rng = np.random.RandomState(SEED + 24)
    cases = [(b, 2 * group, 2, s, d)
             for b in (1, 8) for s in (1, 384, 1500)
             for group in (1, 2, 3, 6) for d in (64, 128)]
    cases.append((8, 8, 8, 1500, 64))                  # Whisper's cross
    worst, worst_rise = 0.0, 0
    for b, h, kv, s, d in cases:
        lengths = rng.randint(1, s + 1, b)
        lengths[0], lengths[-1] = s, 1
        if (b, h, kv) == (8, 8, 8):
            lengths[:] = s
        q, k, v, lens = decode_inputs(b, h, kv, s, d, lengths, torch.float32,
                                      rng)
        k, v = k.bfloat16(), v.bfloat16()
        splits = plan_splits(b, kv, s, d, q.dtype, k.dtype)[0]
        needed = 4 * (q.numel() + (splits * b * h * (d + 2)
                                   if splits > CLUSTER_MAX else 0))
        cache_bytes = 2 * k.numel() * k.element_size()
        out, rise = requested_rise(torch, lambda: kernel(q, k, v, lens))
        expected = ref.decode_attention_ref(q, k.float(), v.float(), lens)
        err = (out - expected).abs().max().item()
        check(out.dtype == torch.float32 and out.shape == q.shape
              and bool(torch.isfinite(out).all()),
              f"decode_attention bf16 cache b={b} h={h} s={s} d={d}: bad "
              f"output")
        check(err <= TOL["float32"], f"decode_attention bf16 cache b={b} "
              f"h={h} kv={kv} s={s} d={d}: max_abs_err {err} > "
              f"{TOL['float32']}")
        check(rise <= needed and (s < 384 or needed < cache_bytes),
              f"decode_attention bf16 cache b={b} h={h} s={s} d={d}: the "
              f"call requested {rise} bytes, more than its output and "
              f"partials ({needed}); one layer's K and V are {cache_bytes}")
        worst, worst_rise = max(worst, err), max(worst_rise, rise)
        log(f"  decode_attention bf16 cache, f32 q b={b:<2d} h={h:<2d} "
            f"kv={kv} s={s:<5d} d={d:<3d} splits={splits:<3d} "
            f"max_abs_err={err:.3e} requested {rise} B (output and "
            f"partials {needed} B; K and V {cache_bytes} B)")
    return {"max_abs_err": worst, "cases": len(cases),
            "max_requested_bytes": worst_rise}


def check_decode_edges(kernel, ref, torch, plan_splits):
    """The cluster design's edges in all three dtype pairs (``PAIRS``):
    caches one key either side of the most splits a cluster holds and of
    the serving plan (DECODE_CLUSTER_EDGES), lengths at the splits' edges;
    every group size (DECODE_GROUPS, 12 in two head blocks) at d 128 and
    every head dim at a group of 6; each call repeated bit-equal, and a
    call at another plan between them.  Returns the worst error per q
    dtype."""
    from repro_torch.kernels.decode_attention import HEAD_DIMS, PAIRS
    rng = np.random.RandomState(SEED + 28)
    cases = [(b, 4 * kv, kv, s, d) for b, kv, s, d in DECODE_CLUSTER_EDGES]
    cases += [(8, 2 * group, 2, 300, 128) for group in DECODE_GROUPS]
    cases += [(8, 12, 2, 300, d) for d in HEAD_DIMS if d != 128]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    other = decode_inputs(4, 8, 2, 1000, 32, edge_lengths(4, 1000, 256, rng),
                          torch.float32, rng)
    for q_dtype, kv_dtype in PAIRS:
        name = str(q_dtype).split(".")[-1]
        for b, h, kv, s, d in cases:
            splits, keys = plan_splits(b, kv, s, d, q_dtype, kv_dtype)
            q, k, v, lens = decode_inputs(b, h, kv, s, d,
                                          edge_lengths(b, s, keys, rng),
                                          torch.float32, rng)
            q, k, v = q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)
            first = kernel(q, k, v, lens)
            kernel(*other)
            again = kernel(q, k, v, lens)
            torch.cuda.synchronize()
            expected = ref.decode_attention_ref(q, k, v, lens)
            err = (first.float() - expected.float()).abs().max().item()
            label = (f"decode_attention edge b={b} h={h} kv={kv} s={s} d={d}"
                     f" splits={splits} q {name} cache "
                     f"{str(kv_dtype).split('.')[-1]}")
            check(first.dtype == q.dtype and bool(torch.isfinite(first).all())
                  and err <= TOL[name], f"{label}: max_abs_err {err}")
            check(torch.equal(first, again),
                  f"{label}: a repeat call is not bit-equal")
            worst[name] = max(worst[name], err)
        log(f"  decode_attention q {name}, cache "
            f"{str(kv_dtype).split('.')[-1]}: {len(cases)} cluster and "
            f"group edges, worst max_abs_err={worst[name]:.3e}; repeats "
            f"bit-equal")
    return worst


def time_decode_attention(kernel, ref, torch, plan_splits, b, s,
                          lengths_value):
    """``time_decode_shape`` at the served policy's head layout."""
    return time_decode_shape(kernel, ref, torch, plan_splits, b,
                             POLICY["num_heads"], POLICY["num_kv_heads"], s,
                             POLICY["head_dim"], lengths_value)


def time_decode_shape(kernel, ref, torch, plan_splits, b, h, kv, s, d,
                      lengths_value, dtype="float32", kv_dtype=None):
    """Kernel, plain version and scaled_dot_product_attention (the library
    yardstick, never called by the port) on random inputs of one shape, q
    in ``dtype`` and K/V in ``kv_dtype`` (default ``dtype``), and the CUDA
    kernels one call launches, counted by torch.profiler: one, the block
    kernel of q's dtype, or two when the split plan outgrows a cluster
    (``decode_attention.kernel_names``).  The library call takes one dtype:
    under a bfloat16 cache and float32 queries it gets the cache upcast to
    float32 (prepared outside the timed region)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel_names
    kv_dtype = kv_dtype or dtype
    rng = np.random.RandomState(SEED + 1)
    lengths = np.full((b,), lengths_value, np.int32)
    q, k, v, lens = decode_inputs(b, h, kv, s, d, lengths, torch.float32, rng)
    q = q.to(getattr(torch, dtype))
    k, v = k.to(getattr(torch, kv_dtype)), v.to(getattr(torch, kv_dtype))
    err = (kernel(q, k, v, lens).float() - ref.decode_attention_ref(
        q, k, v, lens).float()).abs().max().item()
    # the library call's own layout, prepared outside the timed region
    q4 = q[:, :, None, :]
    k4, v4 = (t.to(q.dtype).transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    bound, bound_by = decode_bound(b, h, kv, s, d, lengths,
                                   q.element_size(), k.element_size())
    calls = {
        "": lambda: kernel(q, k, v, lens),
        "plain_": lambda: ref.decode_attention_ref(q, k, v, lens),
        "library_": lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True),
    }
    splits = plan_splits(b, kv, s, d, q.dtype, k.dtype)[0]
    timed = {"shape": {"b": b, "h": h, "kv": kv, "s": s, "d": d,
                       "lengths": int(lengths_value), "dtype": dtype,
                       "kv_dtype": kv_dtype, "splits": splits},
             "max_abs_err_timed": err, "bound_ms": bound,
             "bound_by": bound_by}
    stages = kernel_names(q.dtype, k.dtype, b, kv, s, d)
    timed["cuda_launches_per_call"], timed["device_ms_by_kernel"] = (
        launched_kernels(torch, calls[""], stages, "decode_attention"))
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
    timed["cuda_launches_per_call"], timed["device_ms_by_kernel"] = (
        launched_kernels(torch, calls[""], ("vtrace_kernel",), "vtrace"))
    # the plain version loops over T in Python: 20 calls a sample, not 200
    for prefix, fn in calls.items():
        launches = 20 if prefix else 200
        timed[f"{prefix}ms"] = time_ms(fn, launches=launches, graph=True)
        timed[f"eager_{prefix}ms"] = time_ms(fn, launches=launches,
                                             graph=False)
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


def dtype_bounds(nbytes, flops, itemsize):
    """(bound_ms, bound_by, bound_tc_ms): float32 (itemsize 4) by
    ``bounds``; bfloat16 at the native bf16 tensor-core rate, which the
    bf16 routes run at, so there bound_tc_ms is bound_ms."""
    if itemsize == 4:
        return bounds(nbytes, flops)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(by_bytes, by_ops)
    return (bound, "bytes" if by_bytes >= by_ops else "operations", bound)


def flash_bound(b, h, kv, sq, sk, d, causal, window, itemsize):
    """Least time (ms): q, K, V and out once; two multiply-adds (q.k and
    p.v) per kept (query, key) pair and channel, per head.  In float32
    (itemsize 4) ``bounds``; in bfloat16 the work over the native bf16
    tensor-core rate, which the kernel's bf16 route runs at, so there
    bound_tc_ms is bound_ms."""
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * kv * sk)
    flops = 4 * d * b * h * flash_pairs(sq, sk, causal, window)
    return dtype_bounds(nbytes, flops, itemsize)


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
    edges = check_flash_edges(kernel, ref, torch, rng)
    worst = {name: max(worst[name], edges[name]) for name in worst}
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
    check(out.shape == expected.shape and out.dtype == q.dtype
          and bool(torch.isfinite(out).all()),
          f"flash_attention {label}: bad output")
    err = (out.float() - expected.float()).abs().max().item()
    tol = TOL[str(q.dtype).split(".")[-1]]
    check(err <= tol, f"flash_attention {label}: max_abs_err {err} > {tol}")
    return err, out


def check_flash_edges(kernel, ref, torch, rng):
    """The tile designs' edges, in both dtypes: sq, sk around every route's
    tiles and rings (FLASH_EDGES at d 64, FLASH_BF16_EDGES at the bf16
    route's other head dims, FLASH_TF32_WGMMA_EDGES at the f32 route's d
    128); windows that end inside a key tile (causal tiles launch heaviest
    first); the model's strided views against contiguous copies (equal);
    one key per query with distinct V rows, which a wrong key order between
    P and V would show.  Returns the worst error per dtype."""
    worst = {"float32": 0.0, "bfloat16": 0.0}

    def run(q, k, v, causal, window, label):
        err, out = flash_error(kernel, ref, torch, q, k, v, causal, window,
                               label)
        name = str(q.dtype).split(".")[-1]
        worst[name] = max(worst[name], err)
        return err, out

    grids = [(name, 64, FLASH_EDGES) for name in ("float32", "bfloat16")]
    grids += [("bfloat16", d, FLASH_BF16_EDGES) for d in (16, 32, 128)]
    grids += [("float32", 128, FLASH_TF32_WGMMA_EDGES)]
    for name, d, edges in grids:
        before = worst[name]
        worst[name] = 0.0
        for sq in edges:
            for sk in edges:
                for causal in (True, False):
                    q, k, v = flash_inputs(1, 4, 2, sq, sk, d,
                                           getattr(torch, name), rng)
                    run(q, k, v, causal, None,
                        f"edge sq={sq} sk={sk} d={d} {name}")
        log(f"  flash_attention edges sq, sk in {edges}, d={d}, {name}, "
            f"causal and not: max_abs_err={worst[name]:.3e}")
        worst[name] = max(worst[name], before)
    for window in FLASH_WINDOWS:
        for name, d in (("float32", 64), ("float32", 128),
                        ("bfloat16", 64), ("bfloat16", 128)):
            q, k, v = flash_inputs(2, 4, 4, 300, 300, d,
                                   getattr(torch, name), rng)
            err, _ = run(q, k, v, True, window,
                         f"window {window} d={d} {name}")
            log(f"  flash_attention window={window} across key tiles s=300 "
                f"d={d} {name} max_abs_err={err:.3e}")
    for name in ("float32", "bfloat16"):
        model = [torch.as_tensor(rng.randn(2, 200, heads, 64).astype(
            np.float32)).to("cuda", getattr(torch, name))
            for heads in (8, 2, 2)]
        views = [t.transpose(1, 2) for t in model]
        err, out = run(*views, True, 80, f"model-layout views {name}")
        same = torch.equal(out, kernel(*(t.contiguous() for t in views),
                                       True, 80))
        check(same and out.transpose(1, 2).is_contiguous(),
              f"flash_attention {name}: strided views differ from "
              f"contiguous copies, or the output is not in the model's "
              f"order")
        log(f"  flash_attention model-layout views {name}: equal to "
            f"contiguous copies, max_abs_err={err:.3e}")
    for name in ("float32", "bfloat16"):
        for d in (32, 64, 128):
            target = rng.randint(0, d, 200)
            arrays = (np.eye(d)[target], np.eye(d) * 40.0 * d ** 0.5,
                      np.arange(d)[:, None] + 0.01 * rng.randn(d, d))
            q, k, v = (torch.as_tensor(a, dtype=torch.float32).to(
                "cuda", getattr(torch, name))[None, None] for a in arrays)
            err, out = run(q, k, v, False, None,
                           f"one key per query d={d} {name}")
            picked = (out[0, 0].float()
                      - v[0, 0, target].float()).abs().max().item()
            check(picked <= 1e-3, f"flash_attention: one key per query, "
                  f"d={d} {name}: output {picked} from that key's V row")
            log(f"  flash_attention one key per query d={d} {name}: "
                f"max_abs_err={err:.3e}, {picked:.3e} from the chosen keys' "
                f"V rows")
    return worst


def check_flash_persistent(kernel, ref, torch, rng):
    """The persistent bf16 route (FLASH_PERSISTENT): fewer work items than
    SMs and more, ragged sq, sq != sk, causal with windows that end inside
    a key tile and not, on the model's strided views, with the rows'
    log-sum-exp against the plain version's; each call repeated
    bit-equal.  Returns the worst error."""
    worst = 0.0
    for label, b, h, kv, sq, sk, d in FLASH_PERSISTENT:
        model = [torch.as_tensor(rng.randn(b, s, heads, d).astype(
            np.float32)).to("cuda", torch.bfloat16)
            for s, heads in ((sq, h), (sk, kv), (sk, kv))]
        q, k, v = (t.transpose(1, 2) for t in model)
        for causal, window in ((True, None), (True, 65), (True, 100),
                               (False, None)):
            out, lse = kernel(q, k, v, causal, window, with_lse=True)
            again = kernel(q, k, v, causal, window)
            torch.cuda.synchronize()
            expected = ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
            lse_ref = ref.flash_attention_lse_ref(q, k, causal=causal,
                                                  window=window)
            err = (out.float() - expected.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            what = (f"flash_attention persistent {label} b={b} h={h} kv={kv}"
                    f" sq={sq} sk={sk} d={d} causal={causal:d} "
                    f"window={window}")
            check(bool(torch.isfinite(out).all()) and err <= TOL["bfloat16"]
                  and lse_err <= TOL["bfloat16"],
                  f"{what}: max_abs_err {err}, lse {lse_err}")
            check(torch.equal(out, again), f"{what}: a repeat call is not "
                  f"bit-equal")
            worst = max(worst, err)
        log(f"  flash_attention persistent bf16 {label} ({-(-sq // 128) * h * b}"
            f" work items) b={b} h={h} kv={kv} sq={sq} sk={sk} d={d}, four "
            f"masks, strided views: max_abs_err={worst:.3e}; repeats "
            f"bit-equal")
    return worst


def ptxas_usage(build_log):
    """Per kernel entry of ptxas's -v report in ``build_log``: registers,
    spill stores and loads (bytes) and static shared memory (bytes)."""
    usage, entry = {}, None
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
            usage[entry] = {}
            continue
        if entry is None:
            continue
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found:
            usage[entry]["spill_store_bytes"] = int(found.group(1))
            usage[entry]["spill_load_bytes"] = int(found.group(2))
        found = re.search(r"Used (\d+) registers", line)
        if found:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[entry]["registers"] = int(found.group(1))
            usage[entry]["static_smem_bytes"] = int(smem.group(1)) \
                if smem else 0
    return usage


# the SSD scan's entries on the main paths, as the short names of
# ssd_entries: f32 at head dim 64 and d_state 64 (Zamba2's scoring and
# training) and at head dim 16 and d_state 16 (the reduced families'
# training, phase 25 (c)).  ptxas must report no spills for them, and each
# product must be HGMMA in their SASS
SSD_MAIN_ENTRIES = {
    "ssd_scan": ("ssd_chunk_kernelIffLi64ELb0EE",
                 "ssd_output_kernelIfLi64EE",
                 "ssd_chunk_kernelIffLi16ELb0EE",
                 "ssd_output_kernelIfLi16EE"),
    "ssd_scan_bwd": ("ssd_chunk_kernelIffLi64ELb1EE", "ssd_bwd_dx_kernelIfLi64EE",
                     "ssd_bwd_dg_kernelIfLi64EE",
                     "ssd_bwd_sum_kernelIfLi64ELi64EE",
                     "ssd_chunk_kernelIffLi16ELb1EE", "ssd_bwd_dx_kernelIfLi16EE",
                     "ssd_bwd_dg_kernelIfLi16EE",
                     "ssd_bwd_sum_kernelIfLi16ELi64EE")}


def ssd_entries(build_log, library):
    """An SSD library's entries under short names (the kernel and its
    template arguments): ptxas's usage, and HGMMA lines in the SASS (None
    when cuobjdump is missing)."""
    short = r"(?:ssd_bwd_|ssd_)[a-z]+_kernel(?:I\w+?EE)?"
    usage = {re.search(short, entry).group(0): u
             for entry, u in ptxas_usage(build_log).items()
             if re.search(short, entry)}
    counts = sass_counts(library, "HGMMA")
    hgmma = None if counts is None else {
        re.search(short, entry).group(0): lines
        for entry, lines in counts.items() if re.search(short, entry)}
    return usage, hgmma


def check_ssd_entries(usage, hgmma, main, what):
    """The main paths' entries spill nothing and run on wgmma."""
    for entry in main:
        got = usage.get(entry, {})
        check(got.get("spill_store_bytes", 0) == 0
              and got.get("spill_load_bytes", 0) == 0 and "registers" in got,
              f"{what}: entry {entry} has ptxas usage {got}, not one "
              f"without spills")
        if hgmma is not None:
            check(bool(hgmma.get(entry)), f"{what}: entry {entry} has "
                  f"{hgmma.get(entry)} HGMMA lines in its SASS")


def sass_counts(library, opcode):
    """{kernel entry: lines of its SASS that hold ``opcode``}, from the
    toolkit's cuobjdump; None where the toolkit has none."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, entry = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            entry = found.group(1)
            counts[entry] = 0
        elif entry is not None and opcode in line:
            counts[entry] += 1
    return counts


def flash_route_entry(table, route, d):
    """The one entry of ``table`` (keyed by mangled kernel name) that the
    route launches at head dim d, or None."""
    pattern = FLASH_ROUTE_KERNELS[route].format(d=d)
    found = [value for name, value in (table or {}).items()
             if pattern in name]
    return found[0] if len(found) == 1 else None


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


def check_flash_zoo(kernel, ref, torch, rng):
    """FLASH_ZOO's shapes in their dtypes, without a window, against the
    plain version at TOL.  Returns the worst error per dtype."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, b, h, kv, sq, sk, d, causal, dtypes in FLASH_ZOO:
        for name in dtypes:
            q, k, v = flash_inputs(b, h, kv, sq, sk, d,
                                   getattr(torch, name), rng)
            out = kernel(q, k, v, causal, None)
            torch.cuda.synchronize()
            expected = ref.flash_attention_ref(q, k, v, causal=causal)
            check(out.shape == expected.shape and out.dtype == q.dtype
                  and bool(torch.isfinite(out).all()),
                  f"flash_attention {label} {name}: bad output")
            err = (out.float() - expected.float()).abs().max().item()
            worst[name] = max(worst[name], err)
            log(f"  flash_attention {label:15s} b={b} h={h} kv={kv} "
                f"sq={sq} sk={sk} d={d} causal={causal:d} {name:8s} "
                f"max_abs_err={err:.3e}")
            check(err <= TOL[name], f"flash_attention {label} {name}: "
                  f"max_abs_err {err} > {TOL[name]}")
    return worst


def time_flash_zoo(kernel, ref, torch, usage=None, hgmma=None):
    """FLASH_ZOO's shapes in the path's dtype, on the model's strided
    views (and, as ``contiguous_ms``, on contiguous (b, heads, s, d)
    copies; as ``cold_l2_ms``, each call after 64 MB of other writes, so
    its inputs come from device memory as in a model's step): the kernel,
    its plain version, and
    scaled_dot_product_attention (the library yardstick, never called by
    the port) on contiguous (b, heads, s, d) tensors, twice: with K/V
    repeated to the query heads (the repeat made before timing;
    ``library_repeat_ms``) and on K/V as they are with ``enable_gqa=True``
    (``library_gqa_ms``).  ``library_ms`` is the faster of the two, so
    ``vs_library`` is the larger factor.  A kernel slower than the library
    call is reported, not failed: it orders the next kernel work.  Each
    row names
    the kernel's route and, from ``usage`` (``ptxas_usage``) and ``hgmma``
    (``sass_counts``), the entry's registers, spills, shared memory and
    HGMMA instructions ("not measured" without them)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import route
    rng = np.random.RandomState(SEED + 23)
    rows = []
    for label, b, h, kv, sq, sk, d, causal, dtypes in FLASH_ZOO:
        dtype = getattr(torch, dtypes[0])
        q, k, v = flash_inputs(b, h, kv, sq, sk, d, dtype, rng)
        views = [t.transpose(1, 2).contiguous().transpose(1, 2)
                 for t in (q, k, v)]
        k_rep, v_rep = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        expected = ref.flash_attention_ref(q, k, v, causal=causal)
        err = (kernel(*views, causal, None).float()
               - expected.float()).abs().max().item()
        lib_err = max((F.scaled_dot_product_attention(
            q, kk, vv, is_causal=causal, enable_gqa=gqa).float()
            - expected.float()).abs().max().item()
            for kk, vv, gqa in ((k_rep, v_rep, False), (k, v, True)))
        check(err <= TOL[dtypes[0]] and lib_err <= TOL[dtypes[0]],
              f"flash_attention {label}: max_abs_err {err}, the library "
              f"calls' {lib_err}")
        bound, bound_by, bound_tc = flash_bound(
            b, h, kv, sq, sk, d, causal, None, q.element_size())
        timed = {"path": label,
                 "shape": {"b": b, "h": h, "kv": kv, "sq": sq, "sk": sk,
                           "d": d, "causal": causal, "window": None,
                           "dtype": dtypes[0],
                           "layout": "model (b, s, heads, d) views"},
                 "max_abs_err_timed": err, "bound_ms": bound,
                 "bound_by": bound_by, "bound_tc_ms": bound_tc,
                 "route": route(dtype, d),
                 "ptxas": flash_route_entry(usage, route(dtype, d), d)
                 or "not measured",
                 "dynamic_smem_bytes": kernel.smem_bytes(dtype, d),
                 "hgmma_sass_lines": (
                     "not measured" if hgmma is None else
                     flash_route_entry(hgmma, route(dtype, d), d))}
        calls = {
            "": (lambda: kernel(*views, causal, None), True),
            "contiguous_": (lambda: kernel(q, k, v, causal, None), False),
            "plain_": (lambda: ref.flash_attention_ref(q, k, v,
                                                       causal=causal),
                       False),
            "library_repeat_": (lambda: F.scaled_dot_product_attention(
                q, k_rep, v_rep, is_causal=causal), True),
            "library_gqa_": (lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), True),
        }
        for prefix, (fn, eager) in calls.items():
            timed[f"{prefix}ms"] = time_ms(fn, warmup=3, launches=20)
            if eager:
                timed[f"eager_{prefix}ms"] = time_ms(fn, warmup=3,
                                                     launches=20,
                                                     graph=False)
        # the kernel after 64 MB of other writes, as a model's step calls
        # it (L2 holds 50 MB): the flush's own time taken out
        flush = torch.empty(16 * 2 ** 20, device="cuda")
        timed["cold_l2_ms"] = time_ms(
            lambda: (flush.zero_(), kernel(*views, causal, None)), warmup=3,
            launches=20) - time_ms(flush.zero_, warmup=3, launches=20)
        del flush
        faster = min(("library_repeat_", "library_gqa_"),
                     key=lambda prefix: timed[f"{prefix}ms"])
        timed["library_ms"] = timed[f"{faster}ms"]
        timed["eager_library_ms"] = timed[f"eager_{faster}ms"]
        timed["library_call"] = faster.rstrip("_")
        timed["vs_library"] = timed["ms"] / timed["library_ms"]
        log(f"  flash_attention at {label} {json.dumps(timed)}; "
            f"{timed['ms'] / bound:.2f}x its bound, "
            f"{timed['vs_library']:.2f}x scaled_dot_product_attention"
            + (" (SLOWER than the library call)"
               if timed["vs_library"] > 1 else ""))
        rows.append(timed)
        del q, k, v, views, k_rep, v_rep, expected
    return rows


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


def graph_kernels(torch, fn):
    """The names of the device kernels that one call of ``fn`` launches, in
    order: the kernel nodes (not copies or fills) of a CUDA graph that
    captures the call, read from the graph's DOT dump in capture order."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "call.dot"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the dump warns that it runs
            graph.debug_dump(str(path))
        text = path.read_text()
    del graph
    nodes = re.findall(r'label="\{\s*KERNEL\s*\|\s*\{ID \| (\d+) '
                       r'\(topoId: \d+\) \| (.+?)\\<\\<\\<', text)
    return [name for _, name in sorted(nodes, key=lambda n: int(n[0]))]


def profiled_kernels(torch, fn):
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def evented_launches(torch, fn, wrapper, launches, calls=5):
    """Each launch's device ms of a call of ``fn``, from CUDA events that
    ``wrapper`` has its library record before each of its ``launches`` and
    after the last (``mark_launches``): the median over ``calls`` calls."""
    samples = []
    for _ in range(calls + 1):  # the first call warms up
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(launches + 1)]
        wrapper.mark_launches(events)
        try:
            fn()
        finally:
            wrapper.mark_launches(None)
        events[-1].synchronize()
        samples.append([events[i].elapsed_time(events[i + 1])
                        for i in range(launches)])
    return [statistics.median(s[i] for s in samples[1:])
            for i in range(launches)]


def launched_kernels(torch, fn, stages, what, tries=3, wrapper=None):
    """The CUDA kernels one call of ``fn`` launches (``graph_kernels``),
    held to the design's ``stages`` in order (each a part of its kernel's
    name): (their count, {stage: device ms}).  The times come from
    ``profiled_kernels``; in a long run the profiler at times records no
    device activity for several sessions in a row (cause not found), so it
    is tried ``tries`` times; then, for a ``wrapper`` that can mark its
    launches, from CUDA events between them (``evented_launches``), else
    each time is None (not measured)."""
    names = graph_kernels(torch, fn)
    check(len(names) == len(stages)
          and all(stage in name for name, stage in zip(names, stages)),
          f"{what}: one call launched {names}, not {list(stages)} in order")
    for _ in range(tries):
        traced = profiled_kernels(torch, fn)
        if traced is not None:
            break
    if traced is None or len(traced) != len(names):
        if wrapper is not None:
            times = evented_launches(torch, fn, wrapper, len(names))
            log(f"  {what}: the profiler recorded {traced!r} for a call of "
                f"{len(names)} kernels; device times from CUDA events "
                f"between the launches")
            return len(names), dict(zip(stages, times))
        log(f"  {what}: the profiler recorded {traced!r} for a call of "
            f"{len(names)} kernels; their device times not measured")
        return len(names), {stage: None for stage in stages}
    return len(names), {stage: ms for stage, (_, ms) in zip(stages, traced)}


def time_ssd(kernel, ref, torch, cfg, shape=None, keep=False):
    """At the shape of one Mamba2 layer of the scoring path (or ``shape``,
    (b, s), with the model's widths): the kernel and its plain version; no
    single PyTorch call computes the SSD scan, so there is no library
    yardstick.  With ``keep`` the kernel keeps its scratch for the backward,
    as training's forward does.  One call must launch the design's three
    CUDA kernels once each, in order (the chunk launch, state passing, the
    output), and nothing else."""
    s_cfg = cfg.ssm
    b, s = shape or (ZAMBA_BATCH, ZAMBA_SEQ)
    h, p, n, chunk = (s_cfg.num_heads(cfg.d_model), s_cfg.head_dim,
                      s_cfg.d_state, s_cfg.chunk_size)
    inputs = ssd_inputs(b, s, h, p, n, np.random.RandomState(SEED + 8),
                        model_like=True)
    err_y, err_state, abs_err, _ = ssd_errors(kernel, ref, inputs, chunk)
    bound, bound_by, bound_tc = ssd_bound(b, s, h, p, n, chunk)
    timed = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n,
                       "chunk": chunk, "dtype": "float32", "keep": keep},
             "max_abs_err_timed": abs_err,
             "max_scaled_err_timed": max(err_y, err_state),
             "bound_ms": bound, "bound_by": bound_by,
             "bound_tc_ms": bound_tc, "library_ms": None}
    calls = {"": lambda: kernel(*inputs, chunk, keep=keep),
             "plain_": lambda: ref.ssd_scan_ref(*inputs, chunk)}
    timed["cuda_launches_per_call"], timed["device_ms_by_kernel"] = (
        launched_kernels(torch, calls[""],
                         [f"ssd_{stage}_kernel" for stage in
                          ("chunk", "pass", "output")],
                         "ssd_scan"))
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
    check(launches["flash_attention"]
          == stats["prefill_batches"] * arch.num_layers > 0,
          f"main path: flash_attention launched "
          f"{launches['flash_attention']} times, expected "
          f"{stats['prefill_batches']} prefill batches x {arch.num_layers}")
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


class ClockSamples:
    """The card's SM clock (MHz) and power draw (W), sampled by
    ``nvidia-smi -lms`` every ``period_ms`` while the block runs; the
    sampler's first line is read before the block starts.  ``summary()``:
    min, median and max of each over the samples, or None when nvidia-smi
    gave none."""

    def __init__(self, period_ms=20):
        self.period_ms = period_ms
        self.rows = []

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", f"-lms={self.period_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        first = self.proc.stdout.readline()
        self.reader = threading.Thread(target=self._read, args=(first,),
                                       daemon=True)
        self.reader.start()
        return self

    def _read(self, first):
        for line in [first, *self.proc.stdout]:
            parts = [x.strip() for x in line.split(",")]
            try:
                self.rows.append((float(parts[0]), float(parts[1])))
            except (IndexError, ValueError):
                continue

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False

    def summary(self):
        if not self.rows:
            return None
        clocks = sorted(r[0] for r in self.rows)
        power = sorted(r[1] for r in self.rows)
        return {"samples": len(self.rows),
                "sm_clock_mhz": [clocks[0], statistics.median(clocks),
                                 clocks[-1]],
                "power_w": [power[0], statistics.median(power), power[-1]]}


def profile_step(torch, step, params, batch, clock=False):
    """Device time by kernel over one scoring step, from torch.profiler,
    and the device's idle share of the step's wall time; with ``clock``,
    also the SM clock and power draw sampled during the step (min, median,
    max; ``ClockSamples``)."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    sampler = ClockSamples() if clock else contextlib.nullcontext()
    with sampler, profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    clocks = sampler.summary() if clock else None
    if clock:
        log(f"  SM clock and power during the profiled step (min, median, "
            f"max): {json.dumps(clocks) if clocks else 'not measured'}")
    # device-side entries (kernels, copies); an operator's own entry
    # repeats the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    if device_ms == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "clock": clocks}
    log(f"  profile of one step: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    for e in top:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "top": [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                    for e in top], "clock": clocks}


def score_model(torch, kernels, cfg, params, batches, timed_steps,
                clock=False):
    """make_prefill_step over a model: one unmeasured step first (cuBLAS
    plans, the allocator's pool), then the counted run of the batches
    (launch counts zeroed just before, read just after), then more steps
    over the same batches in turn, ``timed_steps`` in all, for the
    step-time distribution; the outputs' shapes, range and finiteness;
    peak device memory and a profile of one more step."""
    from repro_torch.launch.steps import make_prefill_step

    step = make_prefill_step(cfg)
    step(params, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches(kernels)
    times, outs = [], []
    for i in range(timed_steps):
        t0 = time.monotonic()
        out = step(params, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
        if i < len(batches):
            outs.append(out)
        if i == len(batches) - 1:
            launches = kernel_launches(kernels)
    peak = torch.cuda.max_memory_allocated()

    batch, seq = np.shape(batches[0]["tokens"])
    seconds = sum(times) / 1e3
    p50 = float(np.percentile(times, 50))
    p95 = float(np.percentile(times, 95))
    log(f"  {len(batches)} counted batches of {batch} requests x {seq} "
        f"tokens, launches={launches}; {timed_steps} timed steps in "
        f"{seconds:.3f} s: {timed_steps * batch / seconds:.3f} requests/s, "
        f"{timed_steps * batch * seq / seconds:.1f} tokens/s; step ms min="
        f"{min(times):.3f} p50={p50:.3f} p95={p95:.3f} max={max(times):.3f}"
        f"; peak device memory {peak / 2 ** 30:.3f} GiB")
    for out in outs:
        actions, logits = out["actions"], out["last_logits"]
        check(actions.shape == (batch, seq) and actions.dtype == torch.int32,
              f"{cfg.name}: actions {tuple(actions.shape)} {actions.dtype}")
        check(int(actions.min()) >= 0
              and int(actions.max()) < cfg.vocab_size,
              f"{cfg.name}: an action outside the vocabulary")
        check(logits.shape == (batch, cfg.padded_vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name}: bad last_logits")
    profile = profile_step(torch, step, params, batches[0], clock)
    return {"launches": launches, "step": step, "outs": outs,
            "step_ms": times, "step_ms_p50": p50, "step_ms_p95": p95,
            "requests_per_s": timed_steps * batch / seconds,
            "tokens_per_s": timed_steps * batch * seq / seconds,
            "peak_bytes": peak, "profile": profile}


def zamba2_path(torch, kernels, cfg):
    """Zamba2-1.2B's scoring path at full width and depth (score_model),
    each step launching flash once a shared-attention site and the SSD
    scan once a Mamba2 layer."""
    from repro_torch import tree
    from repro_torch.models import transformer

    t0 = time.monotonic()
    params = transformer.init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    sites = cfg.num_layers // cfg.hybrid_attn_every
    log(f"  {cfg.name}: {n_params} parameters (float32) initialized from "
        f"seed {SEED} in {init_s:.2f} s; {cfg.num_layers} Mamba2 layers, "
        f"{sites} shared-attention sites")
    batches = [{"tokens": tokens} for tokens in zamba2_batches(cfg)]
    path = score_model(torch, kernels, cfg, params, batches,
                       ZAMBA_TIMED_STEPS)
    launches = path["launches"]
    check(launches["flash_attention"] == sites * ZAMBA_BATCHES,
          f"scoring path: flash_attention launched "
          f"{launches['flash_attention']} times, expected {sites} x "
          f"{ZAMBA_BATCHES}")
    check(launches["ssd_scan"] == cfg.num_layers * ZAMBA_BATCHES,
          f"scoring path: ssd_scan launched {launches['ssd_scan']} times, "
          f"expected {cfg.num_layers} x {ZAMBA_BATCHES}")
    check(launches["decode_attention"] == launches["vtrace"] == 0,
          f"scoring path launched another slice's kernel: {launches}")
    return dict(path, params=params, batches=batches, init_s=init_s,
                n_params=n_params)


def plain_scoring(torch, step, params, batch):
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
        out = step(params, batch)
    return out, captured["feats"]


def compare_scoring(torch, cfg, params, out, plain, plain_feats, rel_tol,
                    what, rerouted=None):
    """Last logits within tol = ``rel_tol`` x the largest plain |logit| (of
    the real vocabulary); greedy actions equal wherever the plain route's
    top-2 margin exceeds 2 tol.  Returns the max |d|, tol and counts.

    ``rerouted``: (b, s) bools, the MoE tokens that some layer's router
    sent to another expert on the kernel route than on the plain one (a
    near-tie that rounding decides).  There the two routes compute
    different functions, so those positions (and a row whose last token
    is one) are left out of both checks and counted; more than
    MOE_REROUTED_MAX of the positions, or every row, fails."""
    from repro_torch.models import layers, transformer

    tol = rel_tol * plain["last_logits"][:, :cfg.vocab_size].abs().max(
        ).item()
    row_err = (out["last_logits"].float().cpu()
               - plain["last_logits"].float().cpu()).abs().amax(dim=-1)
    kept_rows = torch.ones_like(row_err, dtype=torch.bool)
    if rerouted is not None:
        rerouted = rerouted.cpu()
        count = int(rerouted.sum())
        check(count <= MOE_REROUTED_MAX * rerouted.numel(),
              f"{what}: {count} of {rerouted.numel()} positions rerouted, "
              f"more than {MOE_REROUTED_MAX:.0%}")
        kept_rows = ~rerouted[:, -1]
        check(bool(kept_rows.any()),
              f"{what}: every row's last token was rerouted")
    err = row_err[kept_rows].max().item()
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
    result = {"positions": same.numel(), "equal": int(same.sum())}
    if rerouted is not None:
        result.update(
            rerouted_positions=int(rerouted.sum()),
            rerouted_rows_left_out=int((~kept_rows).sum()),
            rerouted_row_max_abs_err=row_err[~kept_rows].max().item()
            if bool((~kept_rows).any()) else None,
            rerouted_decided_differing=int((~same & decided
                                            & rerouted).sum()))
        decided = decided & ~rerouted
    check(bool(same[decided].all()), f"{what}: greedy actions differ at "
          f"{int((~same & decided).sum())} positions with a plain top-2 "
          f"margin above {2 * tol}")
    return dict(result, max_abs_err=err, tol=tol,
                decided=int(decided.sum()))


def zamba2_parity(torch, cfg, path):
    """The first batch on the plain route at full size, and a reduced
    Zamba2 with a tail on the card's kernels against the CPU's plain
    versions with the same weights."""
    import dataclasses

    from repro_torch import configs

    plain, feats = plain_scoring(torch, path["step"], path["params"],
                                 path["batches"][0])
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
    reduced = reduced_parity(torch, small, "reduced Zamba2 (3 Mamba2 layers "
                             "in a group of 2 and a tail)")
    return full, reduced


def reduced_parity(torch, small, label):
    """A small config in float32 on the card's kernels against the same
    weights (from SEED) on the CPU's plain versions, by the phase-10 rule
    at REDUCED_TOL, over 2 requests of 64 tokens (and the VLM's vision or
    Whisper's frames)."""
    from repro_torch import tree
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    params = transformer.init(torch.Generator().manual_seed(SEED), small,
                              device="cpu")
    params_card = tree.map(lambda t: t.to("cuda"), params)
    batch_card = zoo_batches(torch, small, torch.float32, 2, 64, 1)[0]
    batch_cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
                 for k, v in batch_card.items()}
    step = make_prefill_step(small)
    out = step(params_card, batch_card)
    cpu, cpu_feats = plain_scoring(torch, step, params, batch_cpu)
    result = compare_scoring(torch, small, params, out, cpu, cpu_feats,
                             REDUCED_TOL, f"{label} parity")
    log(f"  {label}, d_model {small.d_model}, card kernels vs CPU plain "
        f"route: max |d last_logits| = {result['max_abs_err']:.3e} (tol "
        f"{result['tol']:.3e} = {REDUCED_TOL} x max |logit|); actions equal "
        f"at {result['equal']} of {result['positions']}, "
        f"{result['decided']} with a top-2 margin above 2 tol")
    return result


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


def grad_scaled_err(a, e):
    """max |a - e| over max |e| (the largest |grad|), in f32."""
    e = e.float()
    return ((a.float() - e).abs().max() / (e.abs().max() + 1e-30)).item()


def check_flash_bwd(torch, ref, flash, flash_bwd, rng):
    """Phase 13: the flash backward kernel at FLASH_CASES x FLASH_MASKS in
    both dtypes (past_keys with its window included: rows that see no
    key), at the zoo's FLASH_ZOO shapes in their dtypes and at the policy
    learner's s 16, against its plain version (on the forward's own output
    and log-sum-exp) and against autograd of the plain forward (on the
    same values in f32), each within GRAD_TOL (f32) or GRAD_BF16_TOL
    (bf16) of the largest |grad|; the forward's log-sum-exp against its
    plain version by the same rule (of max(|lse|, 1)); a second backward
    call on the same inputs gives the same bits.  Returns the worst error
    per dtype."""
    cases = [(label, b, h, kv, sq, sk, d, causal, window, name)
             for label, b, h, kv, sq, sk, d in FLASH_CASES
             for causal, window in FLASH_MASKS
             for name in ("float32", "bfloat16")]
    cases += [(label, b, h, kv, sq, sk, d, causal, None, name)
              for label, b, h, kv, sq, sk, d, causal, dtypes in FLASH_ZOO
              for name in dtypes]
    b, h, kv, s, d = POLICY_FLASH_SHAPE
    cases += [("policy", b, h, kv, s, s, d, True, POLICY["window"], name)
              for name in ("float32", "bfloat16")]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, b, h, kv, sq, sk, d, causal, window, name in cases:
        dtype = getattr(torch, name)
        tol = GRAD_TOL if name == "float32" else GRAD_BF16_TOL
        q, k, v = flash_inputs(b, h, kv, sq, sk, d, dtype, rng)
        g = torch.as_tensor(rng.randn(b, h, sq, d).astype(np.float32)
                            ).to("cuda", dtype)
        out, lse = flash(q, k, v, causal, window, with_lse=True)
        grads = flash_bwd(q, k, v, out, lse, g, causal, window)
        again = flash_bwd(q, k, v, out, lse, g, causal, window)
        torch.cuda.synchronize()
        repeats = all(torch.equal(a, r) for a, r in zip(grads, again))
        del again
        lse_ref = ref.flash_attention_lse_ref(q, k, causal=causal,
                                              window=window)
        lse_err = ((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1.0)
                   ).max().item()
        plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, g,
                                            causal=causal, window=window)
        err = max(grad_scaled_err(a, e) for a, e in zip(grads, plain))
        del plain
        inputs = [t.detach().float().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(
            ref.flash_attention_ref(*inputs, causal=causal, window=window),
            inputs, g.float())
        err_auto = max(grad_scaled_err(a, e) for a, e in zip(grads, auto))
        del inputs, auto
        log(f"  flash_attention_bwd {label:15s} b={b} h={h} kv={kv} "
            f"sq={sq:<4d} sk={sk:<4d} d={d:<3d} causal={causal:d} "
            f"window={window} {name:8s} scaled err: plain {err:.3e}, "
            f"autograd {err_auto:.3e}, lse {lse_err:.3e}; repeat equal "
            f"{repeats}")
        check(all(g_.dtype == dtype and g_.shape == t.shape
                  and bool(torch.isfinite(g_).all())
                  for g_, t in zip(grads, (q, k, v))),
              f"flash_attention_bwd {label} {name}: bad grads")
        check(repeats, f"flash_attention_bwd {label} {name}: a second call "
              f"gave other bits")
        check(max(err, err_auto, lse_err) <= tol, f"flash_attention_bwd "
              f"{label} causal={causal} window={window} {name}: scaled "
              f"errors {err} (plain), {err_auto} (autograd), {lse_err} "
              f"(lse) > {tol}")
        worst[name] = max(worst[name], err, err_auto)
    return worst


def check_ssd_bwd(torch, ref, ssd, ssd_bwd, rng):
    """Phase 13: the SSD backward kernel at SSD_CASES and SSD_CHUNKINGS,
    with and without h0, in f32 and bf16 (x, B and C), against its plain
    version and against autograd of the plain forward (on the same values
    in f32), each gradient within GRAD_TOL (f32) or GRAD_BF16_TOL (bf16)
    of its largest magnitude; a second backward call on the same inputs
    gives the same bits.  Returns the worst error per dtype."""
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, b, s, h, p, n, chunk in SSD_CASES + SSD_CHUNKINGS:
        for with_h0 in (False, True):
            for name in ("float32", "bfloat16"):
                dtype = getattr(torch, name)
                tol = GRAD_TOL if name == "float32" else GRAD_BF16_TOL
                x, dt, A, B, C = ssd_inputs(b, s, h, p, n, rng)
                x, B, C = (t.to(dtype) for t in (x, B, C))
                h0, gy, gf = (torch.as_tensor(rng.randn(*shape),
                                              dtype=torch.float32,
                                              device="cuda")
                              for shape in ((b, h, n, p), (b, s, h, p),
                                            (b, h, n, p)))
                h0 = h0 if with_h0 else None
                _, _, scratch = ssd(x, dt, A, B, C, chunk, h0, keep=True)
                grads = ssd_bwd(x, dt, A, B, C, h0, scratch, gy, gf, chunk)
                again = ssd_bwd(x, dt, A, B, C, h0, scratch, gy, gf, chunk)
                torch.cuda.synchronize()
                repeats = all(torch.equal(a, r) for a, r in
                              zip(grads, again) if a is not None)
                del again, scratch
                plain = ref.ssd_scan_bwd_ref(x, dt, A, B, C, h0, gy, gf,
                                             chunk)
                inputs = [t.detach().float().requires_grad_() for t in
                          (x, dt, A, B, C) + ((h0,) if with_h0 else ())]
                y, final = ref.ssd_scan_ref(*inputs[:5], chunk,
                                            h0=inputs[5] if with_h0 else None)
                auto = torch.autograd.grad((y, final), inputs, (gy, gf))
                errs = {nm: max(grad_scaled_err(a, e), grad_scaled_err(a, u))
                        for nm, a, e, u in zip(names, grads, plain, auto)}
                del plain, inputs, auto
                log(f"  ssd_scan_bwd {label:12s} b={b} s={s:<4d} h={h} "
                    f"p={p:<3d} n={n:<3d} chunk={chunk:<3d} h0={with_h0:d} "
                    f"{name:8s} scaled err (plain, autograd) "
                    + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f"; repeat equal {repeats}")
                check((grads[5] is None) == (not with_h0)
                      and all(g_.dtype == t.dtype and g_.shape == t.shape
                              and bool(torch.isfinite(g_).all())
                              for g_, t in zip(grads, (x, dt, A, B, C, h0))
                              if g_ is not None),
                      f"ssd_scan_bwd {label} {name}: bad grads")
                check(repeats, f"ssd_scan_bwd {label} {name}: a second "
                      f"call gave other bits")
                check(max(errs.values()) <= tol, f"ssd_scan_bwd {label} "
                      f"h0={with_h0} {name}: scaled errors {errs} > {tol}")
                worst[name] = max(worst[name], *errs.values())
    return worst


def flash_bwd_bound(b, h, kv, sq, sk, d, causal, window, itemsize):
    """Least time (ms) of the flash backward: q, out, dO, k, v and the
    log-sum-exp read once, dq, dk and dv written once; the five products
    of FlashAttention-2's backward (S, dP, dV, dQ, dK: two flops a kept
    (query, key) pair and channel each, per head)."""
    nbytes = (itemsize * d * (4 * b * h * sq + 4 * b * kv * sk)
              + 4 * b * h * sq)
    flops = 10 * d * b * h * flash_pairs(sq, sk, causal, window)
    return dtype_bounds(nbytes, flops, itemsize)


def ssd_bwd_bound(b, s, h, p, n, chunk):
    """Least time (ms) of the SSD backward in f32: x, dy, dt, B, C, A, the
    final state's gradient and the forward's scratch (the f64 sums, the
    scores, the entering states) read once, dx, ddt, dB, dC and dA written
    once.  Multiply-adds as the function needs them, per batch row and
    chunk: per head, the kept pairs times 2p (dW = dy x^T, W^T dy) and
    4 Q n p (C dy^T into dS, S dy, B dS', dS' x); once for all heads, as
    B and C are one group, the kept pairs times 2n ((sum_h dG_h) B and its
    transpose times C), as ``ssd_bound`` counts G."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    nbytes = (4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n + 2 * h
                   + b * nc * chunk * chunk + b * nc * h * n * p
                   + b * h * n * p)
              + 8 * b * s * h)
    flops = 2 * b * nc * (h * (2 * pairs * p + 4 * chunk * n * p)
                          + 2 * pairs * n)
    return bounds(nbytes, flops)


def time_flash_bwd(torch, ref, flash, flash_bwd, label, b, h, kv, s, d,
                   name, window, causal=True):
    """At a training shape (sq = sk = s; causal, or with ``causal`` False
    every key, as Whisper's encoder): the backward kernel (a
    CUDA graph's replay: device ms; and eager), the forward kernel with
    its log-sum-exp, the plain backward version, the plain recompute (the
    backward route before the kernel: autograd of the plain forward, run
    again) and scaled_dot_product_attention's backward alone (the library
    yardstick, never called by the port; K/V repeated to the query heads,
    a mask only where a window needs one), each beside the bound.  The
    kernel's grads must be within GRAD_TOL (f32) or GRAD_BF16_TOL (bf16)
    of the plain backward's largest |grad|, and a repeat bit-equal."""
    import torch.nn.functional as F
    dtype = getattr(torch, name)
    rng = np.random.RandomState(SEED + 32)
    q, k, v = flash_inputs(b, h, kv, s, s, d, dtype, rng)
    g = torch.as_tensor(rng.randn(b, h, s, d).astype(np.float32)
                        ).to("cuda", dtype)
    out, lse = flash(q, k, v, causal, window, with_lse=True)
    grads = flash_bwd(q, k, v, out, lse, g, causal, window)
    again = flash_bwd(q, k, v, out, lse, g, causal, window)
    repeats = all(torch.equal(a, r) for a, r in zip(grads, again))
    del again
    plain = ref.flash_attention_bwd_ref(q, k, v, out, lse, g,
                                        causal=causal, window=window)
    err = max((a.float() - e.float()).abs().max().item()
              for a, e in zip(grads, plain))
    scaled = max(grad_scaled_err(a, e) for a, e in zip(grads, plain))
    tol = GRAD_TOL if name == "float32" else GRAD_BF16_TOL
    check(all(g_.dtype == dtype and g_.shape == t.shape
              and bool(torch.isfinite(g_).all())
              for g_, t in zip(grads, (q, k, v))),
          f"flash_attention_bwd at {label} {name}: bad grads")
    check(repeats, f"flash_attention_bwd at {label} {name}: a second call "
          f"gave other bits")
    check(scaled <= tol, f"flash_attention_bwd at {label} {name}: scaled "
          f"error {scaled} against the plain backward > {tol}")
    del grads, plain
    bound, bound_by, bound_tc = flash_bwd_bound(b, h, kv, s, s, d, causal,
                                                window, q.element_size())
    timed = {"shape": {"label": label, "b": b, "h": h, "kv": kv, "sq": s,
                       "sk": s, "d": d, "causal": causal, "window": window,
                       "dtype": name},
             "max_abs_err_timed": err, "max_scaled_err_timed": scaled,
             "bound_ms": bound, "bound_by": bound_by,
             "bound_tc_ms": bound_tc}

    def bwd():
        return flash_bwd(q, k, v, out, lse, g, causal, window)

    def recompute():
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            plain_out = ref.flash_attention_ref(*inputs, causal=causal,
                                                window=window)
            return torch.autograd.grad(plain_out, inputs, g)
    timed["cuda_launches_per_call"], timed["device_ms_by_kernel"] = (
        launched_kernels(torch, bwd, ("flash_bwd_rows", "flash_bwd_dkdv",
                                      "flash_bwd_dq"),
                         f"flash_attention_bwd {label} {name}",
                         wrapper=flash_bwd))
    timed["ms"] = time_ms(bwd, warmup=3, launches=20, graph=True)
    timed["eager_ms"] = time_ms(bwd, warmup=3, launches=20, graph=False)
    timed["fwd_ms"] = time_ms(lambda: flash(q, k, v, causal, window,
                                            with_lse=True),
                              warmup=3, launches=20, graph=True)
    timed["plain_ms"] = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, g, causal=causal, window=window), warmup=1,
        launches=3, repeats=3, graph=False)
    timed["recompute_ms"] = time_ms(recompute, warmup=1, launches=3,
                                    repeats=3, graph=False)
    group = h // kv
    mask = None
    if window is not None:
        qi = torch.arange(s, device="cuda")[:, None]
        ki = torch.arange(s, device="cuda")[None, :]
        mask = (qi >= ki) & (qi - ki < window)
    for lib_name, lib_dtype in (("library", dtype), ("library_bf16",
                                                     torch.bfloat16)):
        lq, lk, lv = (t.detach().to(lib_dtype) for t in (q, k, v))
        lk, lv = (torch.repeat_interleave(t, group, dim=1)
                  for t in (lk, lv))
        lq, lk, lv = (t.requires_grad_() for t in (lq, lk, lv))
        lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                              is_causal=causal
                                              and mask is None)
        lg = g.to(lib_dtype)
        timed[f"{lib_name}_ms"] = time_ms(
            lambda: torch.autograd.grad(lout, (lq, lk, lv), lg,
                                        retain_graph=True),
            warmup=3, launches=20, graph=False)
        del lq, lk, lv, lout
    log(f"  flash_attention_bwd at {label} (b {b}, h {h}, kv {kv}, s {s}, d "
        f"{d}, {'causal' if causal else 'every key'}, window {window}, "
        f"{name}): backward kernel "
        f"{timed['ms']:.4f} ms (eager {timed['eager_ms']:.4f}), forward "
        f"kernel {timed['fwd_ms']:.4f}, plain backward "
        f"{timed['plain_ms']:.3f}, plain recompute "
        f"{timed['recompute_ms']:.3f}, SDPA backward {name} "
        f"{timed['library_ms']:.4f} and bf16 {timed['library_bf16_ms']:.4f} "
        f"(K/V repeated); bound {bound:.4f} ms ({bound_by}), three TF32 "
        f"passes {bound_tc:.4f}; {timed['cuda_launches_per_call']} CUDA "
        f"launches a call {json.dumps(timed['device_ms_by_kernel'])}; max "
        f"abs err {err:.3e} (scaled {scaled:.3e})")
    return timed


def time_ssd_bwd(torch, ref, ssd, ssd_bwd, cfg):
    """At the training path's shape (phase 25 (a): one Mamba2 layer of
    Zamba2-1.2B at 4 x 1024 tokens, the model's dt and A): the backward
    kernel (device and eager ms), the forward kernel keeping its scratch,
    the plain backward version and the plain recompute; no single PyTorch
    call computes the SSD scan's backward.  The kernel's grads must be
    within GRAD_TOL of the plain backward's largest magnitude, and a repeat
    bit-equal.  One call must launch the design's six CUDA kernels once
    each, in order (local states on the chunk launch, state passing
    backwards, dx, dG, dt, the sums)."""
    ssm = cfg.ssm
    b, s = TRAIN_ZAMBA_SHAPE
    h, p, n, chunk = (ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.d_state,
                      ssm.chunk_size)
    rng = np.random.RandomState(SEED + 33)
    x, dt, A, B, C = ssd_inputs(b, s, h, p, n, rng, model_like=True)
    gy, gf = (torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                              device="cuda")
              for shape in ((b, s, h, p), (b, h, n, p)))
    _, _, scratch = ssd(x, dt, A, B, C, chunk, None, keep=True)
    grads = ssd_bwd(x, dt, A, B, C, None, scratch, gy, gf, chunk)
    again = ssd_bwd(x, dt, A, B, C, None, scratch, gy, gf, chunk)
    repeats = all(torch.equal(a, r) for a, r in zip(grads, again)
                  if a is not None)
    del again
    plain = ref.ssd_scan_bwd_ref(x, dt, A, B, C, None, gy, gf, chunk)
    err = max((a - e).abs().max().item() for a, e in zip(grads, plain)
              if a is not None)
    scaled = {nm: grad_scaled_err(a, e) for nm, a, e in
              zip(("dx", "ddt", "dA", "dB", "dC"), grads, plain)}
    check(grads[5] is None
          and all(g_.dtype == t.dtype and g_.shape == t.shape
                  and bool(torch.isfinite(g_).all())
                  for g_, t in zip(grads, (x, dt, A, B, C))),
          "ssd_scan_bwd at the training shape: bad grads")
    check(repeats, "ssd_scan_bwd at the training shape: a second call gave "
          "other bits")
    check(max(scaled.values()) <= GRAD_TOL, f"ssd_scan_bwd at the training "
          f"shape: scaled errors {scaled} against the plain backward > "
          f"{GRAD_TOL}")
    del grads, plain
    bound, bound_by, bound_tc = ssd_bwd_bound(b, s, h, p, n, chunk)
    timed = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n,
                       "chunk": chunk, "dtype": "float32"},
             "max_abs_err_timed": err, "scaled_err_timed": scaled,
             "max_scaled_err_timed": max(scaled.values()),
             "bound_ms": bound, "bound_by": bound_by,
             "bound_tc_ms": bound_tc, "library_ms": None}

    def bwd():
        return ssd_bwd(x, dt, A, B, C, None, scratch, gy, gf, chunk)

    def recompute():
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
            y, final = ref.ssd_scan_ref(*inputs, chunk)
            return torch.autograd.grad((y, final), inputs, (gy, gf))
    timed["cuda_launches_per_call"], timed["device_ms_by_kernel"] = (
        launched_kernels(torch, bwd, ("ssd_chunk_kernel", "ssd_bwd_pass",
                                      "ssd_bwd_dx", "ssd_bwd_dg",
                                      "ssd_bwd_dt", "ssd_bwd_sum"),
                         "ssd_scan_bwd", wrapper=ssd_bwd))
    timed["ms"] = time_ms(bwd, warmup=3, launches=20, graph=True)
    timed["eager_ms"] = time_ms(bwd, warmup=3, launches=20, graph=False)
    timed["fwd_ms"] = time_ms(lambda: ssd(x, dt, A, B, C, chunk, None,
                                          keep=True),
                              warmup=3, launches=20, graph=True)
    timed["plain_ms"] = time_ms(lambda: ref.ssd_scan_bwd_ref(
        x, dt, A, B, C, None, gy, gf, chunk), warmup=1, launches=3,
        repeats=3, graph=False)
    timed["recompute_ms"] = time_ms(recompute, warmup=1, launches=3,
                                    repeats=3, graph=False)
    log(f"  ssd_scan_bwd at the training shape (b {b}, s {s}, h {h}, p {p}, "
        f"n {n}, chunk {chunk}, f32): backward kernel {timed['ms']:.4f} ms "
        f"(eager {timed['eager_ms']:.4f}), forward kernel "
        f"{timed['fwd_ms']:.4f}, plain backward {timed['plain_ms']:.3f}, "
        f"plain recompute {timed['recompute_ms']:.3f}; bound {bound:.4f} ms "
        f"({bound_by}), three TF32 passes {bound_tc:.4f}; "
        f"{timed['cuda_launches_per_call']} CUDA launches a call "
        f"{json.dumps(timed['device_ms_by_kernel'])}; max abs err "
        f"{err:.3e}, scaled {json.dumps(scaled)}")
    return timed


def kernel_grads(torch, kernels, zamba):
    """Phase 13: the grads of a q_sequence loss over the fig17 serving
    policy's params, and of a reduced Zamba2's logits loss, through the
    kernels' autograd Functions (forward and backward kernels) against
    the same calls on the plain route; the backward kernels against their
    plain versions and autograd of the plain forwards at the sweep's,
    the zoo's and the policy's shapes, bit-equal on a repeat; then their
    times at the training path's shapes and at qwen3-1.7b's d 128."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as flash_module
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd_module
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

    zero_launches(kernels)
    grads = param_grads(torch, params, policy_loss)
    torch.cuda.synchronize()
    launches = kernel_launches(kernels)
    flash_route, ssd_route = plain_route()
    with flash_route:
        plain = param_grads(torch, params, policy_loss)
    err = grad_errors(torch, grads, plain, "q_sequence grads")
    log(f"  q_sequence (fig17 policy, {GRAD_POLICY_BATCH} windows of "
        f"{POLICY['window']}): {len(grads)} leaves, launches {launches}; "
        f"max |d grad| / max |plain grad| = {err:.3e} (tol {GRAD_TOL})")
    layers_ = arch.num_layers
    check(launches["flash_attention"] == launches["flash_attention_bwd"]
          == layers_ and launches["ssd_scan"] == launches["ssd_scan_bwd"]
          == 0,
          f"q_sequence grads: launches {launches}, expected flash attention "
          f"and its backward once per layer ({layers_})")
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
        feats, _ = transformer.forward_features(p, small, {"tokens": tokens},
                                                remat="none")
        logits = layers.unembed(transformer.unembed_table(p, small), feats)
        return (logits * weights).sum()

    zero_launches(kernels)
    grads = param_grads(torch, params, zamba_loss)
    torch.cuda.synchronize()
    launches = kernel_launches(kernels)
    with flash_route, ssd_route:
        plain = param_grads(torch, params, zamba_loss)
    err = grad_errors(torch, grads, plain, "reduced Zamba2 grads")
    sites = small.num_layers // small.hybrid_attn_every
    log(f"  reduced Zamba2 ({small.num_layers} Mamba2 layers, {sites} "
        f"shared-attention sites, d_model {small.d_model}, "
        f"{GRAD_ZAMBA_TOKENS[0]} x {GRAD_ZAMBA_TOKENS[1]} tokens, f32): "
        f"{len(grads)} leaves, launches {launches}; max |d grad| / max "
        f"|plain grad| = {err:.3e} (tol {GRAD_TOL})")
    check(launches["flash_attention"] == launches["flash_attention_bwd"]
          == sites and launches["ssd_scan"] == launches["ssd_scan_bwd"]
          == small.num_layers,
          f"reduced Zamba2 grads: launches {launches}, expected flash "
          f"attention and its backward {sites} each and the SSD scan and "
          f"its backward {small.num_layers} each")
    out["zamba2_reduced"] = {"leaves": len(grads), "launches": launches,
                             "max_rel_err": err}
    del params, grads, plain

    flash, flash_bwd = (flash_module.flash_attention,
                        flash_module.flash_attention_bwd)
    ssd, ssd_bwd = ssd_module.ssd_scan, ssd_module.ssd_scan_bwd
    rng = np.random.RandomState(SEED + 31)
    out["flash_attention_bwd_worst"] = check_flash_bwd(torch, ref, flash,
                                                       flash_bwd, rng)
    out["ssd_scan_bwd_worst"] = check_ssd_bwd(torch, ref, ssd, ssd_bwd, rng)
    torch.cuda.empty_cache()

    b, s = TRAIN_ZAMBA_SHAPE
    dense = configs.get_arch(TRAIN_DENSE)
    db, ds = TRAIN_DENSE_SHAPE
    out["flash_attention_bwd_timed"] = [
        time_flash_bwd(torch, ref, flash, flash_bwd, "zamba2_train", b,
                       zamba.num_heads, zamba.num_kv_heads, s,
                       zamba.head_dim, "float32", zamba.sliding_window)] + [
        time_flash_bwd(torch, ref, flash, flash_bwd, "qwen3_1_7b", db,
                       dense.num_heads, dense.num_kv_heads, ds,
                       dense.head_dim, name, dense.sliding_window)
        for name in ("float32", "bfloat16")] + [
        time_flash_bwd(torch, ref, flash, flash_bwd, label, b_, h, kv, sq,
                       d, "float32", None, causal=False)
        for label, b_, h, kv, sq, sk, d, causal, _ in FLASH_ZOO
        if label == "whisper_encoder"]
    torch.cuda.empty_cache()
    out["ssd_scan_bwd_timed"] = time_ssd_bwd(torch, ref, ssd, ssd_bwd, zamba)
    torch.cuda.empty_cache()
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
    the decode kernel and prefills its window through flash attention
    (once a layer a prefill pass, counted by the engines' prefill
    histogram); every learner step runs flash attention once a layer for
    the online pass (through FlashAttentionFunction) and once for the
    target pass.  The final eval must beat the mean of the first 30 train
    returns."""
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
    merged = result.extras["telemetry"]["merged"]
    step_ms = merged.get("learner/step_ms", {})
    prefills = merged.get("inference/engine/prefill_ms", {}).get("count", 0)
    early = float(np.mean(result.train_returns[:30]))
    final = result.final_eval_return
    layers = POLICY_PRESET["num_layers"]
    log(f"  {len(result.train_returns)} episodes, {env_steps} env steps, "
        f"{result.learner_steps} learner steps in {seconds:.3f} s "
        f"({env_steps / seconds:.1f} env steps/s); learner step host time "
        f"(ms): p50={step_ms.get('p50', 0):.3f} "
        f"p95={step_ms.get('p95', 0):.3f}; {prefills} acting prefill "
        f"passes; launches={launches}")
    log(f"  final eval {final} vs the mean of the first 30 train returns "
        f"{early:.3f}")
    check(launches["decode_attention"] > 0,
          "policy path: acting never launched the decode kernel")
    check(launches["flash_attention"]
          == layers * (2 * result.learner_steps + prefills)
          and result.learner_steps > 0 and prefills > 0,
          f"policy path: {launches['flash_attention']} flash launches for "
          f"{result.learner_steps} learner steps and {prefills} acting "
          f"prefill passes of {layers} layer(s), expected two a layer a "
          f"step and one a layer a prefill")
    check(launches["flash_attention_bwd"] == layers * result.learner_steps,
          f"policy path: {launches['flash_attention_bwd']} flash backward "
          f"launches for {result.learner_steps} learner steps of {layers} "
          f"layer(s), expected one a layer a step (the online pass)")
    check(launches["vtrace"] == launches["ssd_scan"]
          == launches["ssd_scan_bwd"] == 0,
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
            "acting_prefills": prefills,
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
    weights for one Catch episode: flash launches of its first call (the
    window prefill), decode launches and host ms a decode call; then the
    acting prefill (``network.q_prefill``, POLICY_PREFILL_ROWS rows of the
    full window) on flash beside the same call on the masked softmax
    (``ops._on_card`` held false), by CUDA events (``time_ms`` over 20
    calls)."""
    import itertools
    from unittest import mock

    from repro_torch.core import VariableClient, make_environment_spec
    from repro_torch.envs import Catch
    from repro_torch.kernels import ops
    from repro_torch.policies import (TransformerPolicyBuilder,
                                      TransformerPolicyConfig, learning,
                                      network)

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
    before = flash.launches
    actor.select_action(ts.observation)          # the episode's prefill
    prefill_flash = flash.launches - before
    check(prefill_flash == cfg.num_layers, f"policy acting: the window "
          f"prefill launched flash {prefill_flash} times, expected "
          f"{cfg.num_layers}")
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
           "flash_launches_per_acting_prefill": prefill_flash,
           "decode_launches_per_acting_call": cfg.num_layers,
           "acting_call_ms_p50": float(np.percentile(act_ms, 50))}
    arch = network.make_arch(cfg, NUM_ACTIONS)
    params = learner.state.params
    rows, window = POLICY_PREFILL_ROWS, cfg.window
    cache = network.init_cache(arch, rows, device="cuda")
    obs = torch.as_tensor(np.random.RandomState(SEED).rand(
        rows, window, int(np.prod(OBS_SHAPE))).astype(np.float32),
        device="cuda")
    lengths = torch.full((rows,), window, dtype=torch.int64, device="cuda")

    def prefill():
        return network.q_prefill(params, arch, cache, obs, lengths)[0]
    on_flash = prefill()
    with mock.patch.object(ops, "_on_card", lambda t: False):
        masked = prefill()
        out["acting_prefill_masked_ms"] = time_ms(prefill, launches=20)
        out["acting_prefill_masked_eager_ms"] = time_ms(
            prefill, launches=20, graph=False)
    out["acting_prefill_ms"] = time_ms(prefill, launches=20)
    out["acting_prefill_eager_ms"] = time_ms(prefill, launches=20,
                                             graph=False)
    out["acting_prefill_max_abs_err"] = (on_flash - masked).abs().max().item()
    check(out["acting_prefill_max_abs_err"] <= TOL["float32"],
          f"policy acting prefill: flash and the masked softmax differ by "
          f"{out['acting_prefill_max_abs_err']}")
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
    kernel — one launch a layer a decode batch — and prefills windows on
    flash attention — one launch a layer a prefill batch — and the learner
    (this process) runs flash attention twice a layer a step; the actors
    hold no network.  In "local" mode each actor process acts on its own
    copy of the policy on the card, so this process launches the learner's
    flash attention only.
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
        # window prefills counted by the engines' telemetry after the stop:
        # the inference node's, here, in server mode; the actor processes'
        # in local mode, which launch nothing here
        entry["prefill_batches"] = result.extras["telemetry"]["merged"].get(
            "inference/engine/prefill_ms", {}).get("count", 0)
        prefills = entry["prefill_batches"] if mode == "server" else 0
        log(f"  fig17 placement, inference={mode!r}: {json.dumps(entry)}")
        check(entry["actor_steps"] >= FIG17_STEPS, f"fig17 {mode}: "
              f"{entry['actor_steps']} actor steps in {FIG17_TIMEOUT_S} s")
        check(entry["learner_steps"] > 0, f"fig17 {mode}: the learner never "
              f"stepped")
        check(mode != "server" or prefills > 0, f"fig17 server: no window "
              f"prefill counted")
        check(launches["flash_attention"]
              == layers * (2 * entry["learner_steps"] + prefills),
              f"fig17 {mode}: {launches['flash_attention']} flash launches "
              f"for {entry['learner_steps']} learner steps and {prefills} "
              f"prefill batches of {layers} layers")
        check(launches["flash_attention_bwd"]
              == layers * entry["learner_steps"],
              f"fig17 {mode}: {launches['flash_attention_bwd']} flash "
              f"backward launches for {entry['learner_steps']} learner steps "
              f"of {layers} layers")
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
    step), and the inference node decodes (once a layer a decode batch)
    and prefills windows on flash attention (once a layer a prefill
    batch), in this process: both counts are held exactly to the steps and
    batches the run's telemetry counted after the stop (a replica restored
    from a snapshot redoes the steps it lost, so its launches exceed the
    steps it reports)."""
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
                max_actor_steps=FIG17_FAILOVER_STEPS,
                timeout_s=FIG17_TIMEOUT_S)
        merged = result.extras["telemetry"]["merged"]
        learners = result.extras["learners"]
        executed = merged["learner/step_ms"]["count"]
        decode_batches = merged["inference/engine/decode_ms"]["count"]
        prefill_batches = merged["inference/engine/prefill_ms"]["count"]
        entry.update({
            "resilience": result.extras.get("resilience"),
            "restores": restores.restores,
            "learner_steps_executed": executed,
            "decode_batches": decode_batches,
            "prefill_batches": prefill_batches,
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
        check(entry["actor_steps"] >= FIG17_FAILOVER_STEPS, f"fig17 {name}: "
              f"{entry['actor_steps']} actor steps")
        check(all(n > 0 for n in learners["per_replica_steps"])
              and learners["sync"] == "async" and learners["rounds"] >= 1,
              f"fig17 {name}: {learners}")
        check(launches["flash_attention"]
              == layers * (2 * executed + prefill_batches)
              and executed >= sum(learners["per_replica_steps"])
              and prefill_batches > 0,
              f"fig17 {name}: {launches['flash_attention']} flash launches "
              f"for {executed} learner steps executed "
              f"({learners['per_replica_steps']} kept) and {prefill_batches} "
              f"prefill batches of {layers} layers")
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
                  f"{service['rounds']} at the service's restore (replica "
                  f"steps {learners['per_replica_steps']} at the end, "
                  f"{service['replica_steps']} at the restore, an exchange "
                  f"every {learners['average_period']})")
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


def host_census():
    """What else runs in this process and beside it: the live Python
    threads by name, the process's OS threads, its child processes, and
    the objects the garbage collector tracks."""
    import gc
    names = sorted(t.name for t in threading.enumerate())
    task = Path("/proc/self/task")
    os_threads = len(list(task.iterdir())) if task.is_dir() else None
    children = None
    if task.is_dir():
        children = sum(len((entry / "children").read_text().split())
                       for entry in task.iterdir()
                       if (entry / "children").exists())
    return {"python_threads": names, "os_threads": os_threads,
            "child_processes": children, "gc_objects": len(gc.get_objects())}


def fig20_async_learner(torch):
    """Phase 22, part 3: fig20's measurement on the card (its smoke
    window): aggregate learner steps a second of two DQN replicas, one a
    straggler, under barrier and under async sync."""
    from repro_torch.agents.builders import make_distributed_agent
    from repro_torch.agents.dqn import DQNBuilder, DQNConfig
    from repro_torch.core import make_environment_spec

    log(f"  before fig20: {host_census()}")
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


# --------------------------------------------------- the model zoo scored
def zoo_batches(torch, cfg, dtype, batch, text, count, seed=SEED):
    """``count`` batches from numpy: tokens, and the VLM's vision or
    Whisper's frames as 0.1 x normal (as tests/test_models_smoke.py makes
    them), on the card in the param dtype (a request's embeddings arrive
    there)."""
    rng = np.random.RandomState(seed)
    extra = {"vlm": ("vision", cfg.vision_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    batches = []
    for _ in range(count):
        item = {"tokens": rng.randint(0, cfg.vocab_size, (batch, text))}
        if extra:
            name, length = extra
            item[name] = torch.as_tensor(
                0.1 * rng.randn(batch, length, cfg.d_model),
                dtype=torch.float32).to("cuda", dtype)
        batches.append(item)
    return batches


def router_choices(run):
    """``run()``, and the top-k expert indices that each MoE layer's
    ``moe_ffn`` took from ``moe.route`` while it ran."""
    from unittest import mock

    from repro_torch.models import moe

    choices = []
    route = moe.route

    def capture(params, cfg, xg):
        routed = route(params, cfg, xg)
        choices.append(routed[-1])
        return routed

    with mock.patch.object(moe, "route", capture):
        result = run()
    return result, choices


def differing_choices(torch, cfg, kernel_choices, plain_choices, shape):
    """Router choices (token, expert) made on one route and not on the
    other, summed over layers; the token-layers with any such choice; and
    the (b, s) tokens rerouted in some layer (groups are consecutive
    tokens of the flattened (b, s) batch)."""
    def chosen(indices):
        return torch.zeros(indices.shape[:-1] + (cfg.moe.num_experts,),
                           device=indices.device).scatter_(-1, indices, 1.0)
    check(len(kernel_choices) == len(plain_choices) == cfg.num_layers,
          f"{cfg.name}: {len(kernel_choices)} and {len(plain_choices)} MoE "
          f"layers recorded, expected {cfg.num_layers}")
    choices = token_layers = 0
    rerouted = torch.zeros(shape, dtype=torch.bool, device="cuda")
    for a, b in zip(kernel_choices, plain_choices):
        moved = (chosen(a) != chosen(b)).sum(-1)
        choices += int(moved.sum().item()) // 2
        token_layers += int((moved > 0).sum().item())
        rerouted |= (moved > 0).reshape(shape)
    return {"differing_choices": choices,
            "token_layers_with_a_differing_choice": token_layers,
            "choices": cfg.num_layers * kernel_choices[0].numel()}, rerouted


def zoo_config(torch, kernels, name, dtype_name, flash_per_step):
    """One config at full width and depth: init from SEED on the card's
    generator, score_model over ZOO_BATCHES batches with exact flash
    launch counts, then the first batch on the plain route by the
    phase-10 rule (and, for MoE, the router choices that differ between
    the two routes)."""
    from repro_torch import configs, tree
    from repro_torch.models import transformer

    cfg = configs.get_arch(name)
    dtype = getattr(torch, dtype_name)
    t0 = time.monotonic()
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    params = transformer.init(generator, cfg, device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(params))
    log(f"  {name} ({cfg.arch_type}): {n_params} parameters "
        f"({param_bytes / 1e9:.2f} GB, {dtype_name}) initialized from seed "
        f"{SEED} on the card in {init_s:.2f} s")
    text = (WHISPER_TEXT if cfg.arch_type == "audio"
            else ZOO_SEQ - cfg.vision_tokens)
    batches = zoo_batches(torch, cfg, dtype, ZOO_BATCH, text, ZOO_BATCHES)
    path = score_model(torch, kernels, cfg, params, batches,
                       ZOO_TIMED_STEPS, clock=True)
    launches = path["launches"]
    check(launches["flash_attention"] == flash_per_step * ZOO_BATCHES,
          f"{name}: flash_attention launched {launches['flash_attention']} "
          f"times, expected {flash_per_step} x {ZOO_BATCHES}")
    check(launches["ssd_scan"] == launches["decode_attention"]
          == launches["vtrace"] == 0,
          f"{name} launched another kernel: {launches}")

    step = path["step"]
    if cfg.arch_type == "moe":
        kernel_out, kernel_choices = router_choices(
            lambda: step(params, batches[0]))
        (plain, feats), plain_choices = router_choices(
            lambda: plain_scoring(torch, step, params, batches[0]))
        routing, rerouted = differing_choices(
            torch, cfg, kernel_choices, plain_choices,
            kernel_out["actions"].shape)
        log(f"  {name}: router top-{cfg.moe.top_k} choices that differ "
            f"between the kernel and the plain route: "
            f"{routing['differing_choices']} of {routing['choices']} "
            f"({routing['token_layers_with_a_differing_choice']} "
            f"token-layers, {int(rerouted.sum())} tokens)")
    else:
        kernel_out, rerouted = path["outs"][0], None
        plain, feats = plain_scoring(torch, step, params, batches[0])
        routing = None
    rel_tol = ZOO_LOGIT_REL_TOL[dtype_name]
    parity = compare_scoring(torch, cfg, params, kernel_out, plain, feats,
                             rel_tol, f"{name} parity", rerouted)
    log(f"  {name}, first batch, kernel vs plain route: max |d "
        f"last_logits| = {parity['max_abs_err']:.3e} (tol "
        f"{parity['tol']:.3e} = {rel_tol} x max |logit|, "
        f"{parity['max_abs_err'] / parity['tol'] * rel_tol:.3e} of it); "
        f"actions equal at {parity['equal']} of {parity['positions']}, "
        f"{parity['decided']} with a top-2 margin above 2 tol"
        + ("" if rerouted is None else
           f"; {parity['rerouted_positions']} rerouted positions left out "
           f"({parity['rerouted_decided_differing']} of them with another "
           f"action and a margin above 2 tol; "
           f"{parity['rerouted_rows_left_out']} rows' last logits, max |d| "
           f"{parity['rerouted_row_max_abs_err']})"))
    return {"config": name, "dtype": dtype_name, "arch_type": cfg.arch_type,
            "n_params": n_params, "param_gb": param_bytes / 1e9,
            "init_s": init_s, "launches": launches,
            "flash_per_step": flash_per_step,
            "requests_per_s": path["requests_per_s"],
            "tokens_per_s": path["tokens_per_s"],
            "step_ms_p50": path["step_ms_p50"],
            "step_ms_p95": path["step_ms_p95"], "step_ms": path["step_ms"],
            "peak_gib": path["peak_bytes"] / 2 ** 30,
            "profile": {k: v for k, v in path["profile"].items()
                        if k != "top"},
            "top_kernels": path["profile"].get("top"),
            "parity": parity, "routing": routing}


def zoo_scoring(torch, kernels):
    """Phase 23: ZOO in turn, each model freed before the next, then a
    reduced config of each family card vs CPU."""
    import gc

    from repro_torch import configs

    results = []
    for name, dtype_name, flash_per_step in ZOO:
        t0 = time.monotonic()
        results.append(zoo_config(torch, kernels, name, dtype_name,
                                  flash_per_step))
        gc.collect()
        torch.cuda.empty_cache()
        results[-1]["seconds"] = time.monotonic() - t0
        log(f"  {name}: {results[-1]['seconds']:.1f} s in all; device "
            f"memory still allocated after freeing it "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    reduced = {name: reduced_parity(
        torch, configs.reduced(configs.get_arch(name)), f"reduced {name}")
        for name, _, _ in ZOO}
    return {"configs": results, "reduced": reduced}


# ------------------------------------------------ the model zoo's serving
def decode_launches_per_step(cfg):
    """Decode-kernel launches of one serve step: one a layer of the dense
    family, one a shared-attention site, two a Whisper decoder layer (self
    and cross), none for an attention-free SSM."""
    return {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.hybrid_attn_every,
                                                      1),
            "audio": 2 * cfg.num_layers}.get(cfg.arch_type, cfg.num_layers)


def evented_calls(torch, fn, events):
    """``fn``, recording a CUDA event on the stream after each call into
    ``events`` without a sync: the calls run as the caller runs them, and
    the events, read once the run has synced, give each call's end on the
    card's timeline."""
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        return out
    return call


def generate_direct(torch, params, cache, prompts, decode_len, serve):
    """``BatchedServer.generate``'s loop (one serve step a prompt token,
    then greedy decode) over weights BatchedServer does not draw; returns
    the (slots, decode_len) greedy tokens as numpy."""
    prompt_len = prompts.shape[1]
    positions = torch.arange(prompt_len + decode_len, dtype=torch.int32,
                             device="cuda")
    prompts = torch.as_tensor(prompts, device="cuda")
    for t in range(prompt_len):
        tok, _, cache = serve(params, cache, prompts[:, t:t + 1],
                              positions[t])
    outs = [tok]
    for i in range(decode_len - 1):
        tok, _, cache = serve(params, cache, tok, positions[prompt_len + i])
        outs.append(tok)
    return torch.cat(outs, dim=1).cpu().numpy()


def requested_rise(torch, fn):
    """``fn()``, and the most bytes it held from the allocator at once
    beyond what was allocated before it (requested sizes, unrounded)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.memory_stats()["requested_bytes.all.peak"] - base


def serve_parity(torch, cfg, params, cache_dtype, prompts, tokens, rel_tol):
    """The kernel route against the plain route (``ops.decode_attention``
    and ``ops.flash_attention`` patched to their plain versions), each on
    a fresh cache of the serving length, teacher-forced on the timed run's
    tokens: the prompt (one batched prefill for dense and MoE, else its
    first PARITY_PROMPT tokens a step each), then PARITY_STEPS decode
    steps.  Phase 10's rule at each step's logits, and for MoE the tokens
    a router sends to another expert on one route (left out of the rule at
    that step, counted under MOE_REROUTED_MAX of the routed tokens)."""
    from unittest import mock

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import (make_batched_prefill_step,
                                          make_serve_step)
    from repro_torch.models import transformer

    serve = make_serve_step(cfg)
    batched = cfg.arch_type in ("dense", "moe")
    prefill = make_batched_prefill_step(cfg) if batched else None
    max_len = prompts.shape[1] + tokens.shape[1]
    if not batched:
        prompts = prompts[:, :PARITY_PROMPT]
    slots, prompt_len = prompts.shape
    decode_len = min(PARITY_STEPS + 1, tokens.shape[1])
    positions = torch.arange(max_len, dtype=torch.int32, device="cuda")
    prompts_t = torch.as_tensor(prompts, device="cuda")
    tokens_t = torch.as_tensor(tokens, device="cuda")
    caches = {route: transformer.init_cache(cfg, slots, max_len,
                                            getattr(torch, cache_dtype),
                                            "cuda")
              for route in ("kernel", "plain")}

    def step(route, i):
        cache = caches[route]
        if i > 0:
            return serve(params, cache, tokens_t[:, i - 1:i],
                         positions[prompt_len + i - 1])[1]
        if prefill is not None:
            return prefill(params, cache, prompts_t)[1]
        for t in range(prompt_len):
            logits = serve(params, cache, prompts_t[:, t:t + 1],
                           positions[t])[1]
        return logits

    def on_route(route, i):
        if route == "kernel":
            return step(route, i)
        with mock.patch.object(ops, "decode_attention",
                               ref.decode_attention_ref), \
                mock.patch.object(ops, "flash_attention",
                                  ref.flash_attention_ref):
            return step(route, i)

    worst = {"max_abs_err": 0.0, "rel_err": 0.0, "tol": 0.0}
    counts = {"prompt": prompt_len, "steps": decode_len - 1, "rows": 0,
              "equal": 0, "decided": 0,
              "rerouted_tokens": 0, "routed_tokens": 0, "rows_left_out": 0}
    for i in range(decode_len):
        if cfg.arch_type == "moe":
            kernel, kernel_choices = router_choices(lambda: on_route(
                "kernel", i))
            plain, plain_choices = router_choices(lambda: on_route(
                "plain", i))
            shape = (slots, prompt_len if i == 0 else 1)
            _, rerouted = differing_choices(torch, cfg, kernel_choices,
                                            plain_choices, shape)
            counts["rerouted_tokens"] += int(rerouted.sum())
            counts["routed_tokens"] += rerouted.numel()
            kept = ~rerouted[:, -1].cpu()
        else:
            kernel, plain = on_route("kernel", i), on_route("plain", i)
            kept = torch.ones(slots, dtype=torch.bool)
        kernel, plain = kernel.float().cpu(), plain.float().cpu()
        tol = rel_tol * plain[:, :cfg.vocab_size].abs().max().item()
        rows = (kernel - plain).abs().amax(dim=-1)
        check(bool(torch.isfinite(kernel).all()), f"{cfg.name}: non-finite "
              f"logits on the kernel route at step {i}")
        counts["rows_left_out"] += int((~kept).sum())
        err = rows[kept].max().item() if bool(kept.any()) else 0.0
        check(err <= tol, f"{cfg.name} serving parity, step {i}: logits "
              f"differ by {err} > {tol}")
        top2 = torch.topk(plain, 2, dim=-1).values
        decided = ((top2[:, 0] - top2[:, 1]) > 2 * tol) & kept
        same = kernel.argmax(-1) == plain.argmax(-1)
        check(bool(same[decided].all()), f"{cfg.name} serving parity, step "
              f"{i}: greedy tokens differ where the plain top-2 margin "
              f"exceeds {2 * tol}")
        counts["rows"] += slots
        counts["equal"] += int(same.sum())
        counts["decided"] += int(decided.sum())
        if err / max(tol, 1e-30) * rel_tol >= worst["rel_err"]:
            worst = {"max_abs_err": err, "tol": tol,
                     "rel_err": err / max(tol, 1e-30) * rel_tol, "step": i}
    if cfg.arch_type == "moe":
        check(counts["rerouted_tokens"]
              <= MOE_REROUTED_MAX * counts["routed_tokens"],
              f"{cfg.name}: {counts['rerouted_tokens']} of "
              f"{counts['routed_tokens']} routed tokens rerouted, more than "
              f"{MOE_REROUTED_MAX:.0%}")
    del caches
    return dict(worst, **counts)


def serve_config(torch, kernels, name, dtype_name, cache_dtype, how,
                 server=None):
    """One config served at full width and depth: SERVE_SLOTS requests of
    SERVE_PROMPT tokens (SERVE_STEPPED_PROMPT where the prompt goes a
    serve step a token), then SERVE_DECODE greedy tokens, through
    ``BatchedServer.generate`` (``how`` "server"; ``server`` reuses one
    already drawn) or its loop over ``make_serve_step`` ("direct"), which
    sync once, at the end; a CUDA event after each prefill call and serve
    step times them on the card's timeline without another sync (prefill
    and decode tokens/s, the intervals between decode steps); launch
    counts zeroed just before and read just after; peak memory; the bytes
    one more decode step requests; a profile of it; then the kernel route
    against the plain route."""
    from repro_torch import configs, tree
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer

    cfg = configs.get_arch(name)
    dtype = getattr(torch, dtype_name)
    batched = how == "server" and cfg.arch_type in ("dense", "moe")
    prompt_len = SERVE_PROMPT if batched else SERVE_STEPPED_PROMPT
    max_len = prompt_len + SERVE_DECODE
    t0 = time.monotonic()
    if how == "server":
        if server is None:
            server = BatchedServer(cfg, SERVE_SLOTS, max_len, seed=SEED,
                                   device="cuda")
        server.cache = transformer.init_cache(
            cfg, SERVE_SLOTS, max_len, getattr(torch, cache_dtype), "cuda")
        params = server.params
    else:
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg,
            device="cuda", dtype=dtype)
        cache = transformer.init_cache(cfg, SERVE_SLOTS, max_len,
                                       getattr(torch, cache_dtype), "cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (SERVE_SLOTS, prompt_len)).astype(np.int32)
    check(batched == (how == "server" and server._prefill is not None),
          f"{name}: BatchedServer's batched prefill is not the expected one")

    step_events, prefill_events = [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches(kernels)
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.monotonic()
    start.record()
    if how == "server":
        serve, prefill = server._serve, server._prefill
        server._serve = evented_calls(torch, serve, step_events)
        if prefill is not None:
            server._prefill = evented_calls(torch, prefill, prefill_events)
        try:
            tokens = server.generate(prompts, SERVE_DECODE)
        finally:
            server._serve, server._prefill = serve, prefill
        cache = server.cache
    else:
        serve = make_serve_step(cfg)
        tokens = generate_direct(torch, params, cache, prompts, SERVE_DECODE,
                                 evented_calls(torch, serve, step_events))
    wall_s = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = kernel_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    if not batched:             # the prompt went a serve step a token
        prefill_events, step_events = (step_events[:prompt_len],
                                       step_events[prompt_len:])

    decode_steps = SERVE_DECODE - 1
    check(len(step_events) == decode_steps and len(prefill_events) >= 1,
          f"{name}: {len(step_events)} decode steps and "
          f"{len(prefill_events)} prefill calls timed, expected "
          f"{decode_steps} and at least 1")
    prefill_end = prefill_events[-1]
    step_ms = [a.elapsed_time(b) for a, b in
               zip([prefill_end] + step_events[:-1], step_events)]
    check(tokens.shape == (SERVE_SLOTS, SERVE_DECODE)
          and tokens.dtype == np.int32 and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          f"{name}: bad tokens {tokens.shape} {tokens.dtype}")
    per_step = decode_launches_per_step(cfg)
    expected = {"decode_attention": per_step * (
                    decode_steps + (0 if batched else prompt_len)),
                "flash_attention": cfg.num_layers if batched else 0,
                "ssd_scan": 0, "vtrace": 0, "flash_attention_bwd": 0,
                "ssd_scan_bwd": 0}
    check(launches == expected, f"{name}: launches {launches}, expected "
          f"{expected} ({per_step} decode launches a step)")

    # one more decode step (the cache's last position): the bytes it
    # requests, then its profile
    serve_step = make_serve_step(cfg)
    tok = torch.as_tensor(tokens[:, -1:], device="cuda")
    last = torch.tensor(max_len - 1, dtype=torch.int32, device="cuda")
    (_, logits, _), step_bytes = requested_rise(
        torch, lambda: serve_step(params, cache, tok, last))
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    layer_kv_f32 = None
    if "kv" in cache or "attn_kv" in cache:
        kv = cache.get("kv", cache.get("attn_kv"))
        layer_kv_f32 = 2 * kv["k"][0].numel() * 4
        if cache_dtype == "bfloat16" and dtype_name == "float32":
            check(step_bytes < layer_kv_f32, f"{name}: a decode step over "
                  f"a bfloat16 cache requested {step_bytes} bytes, more "
                  f"than one layer's K and V in float32 ({layer_kv_f32}): "
                  f"a cache-sized copy")
    profile = profile_step(torch, lambda p, _: serve_step(p, cache, tok,
                                                          last),
                           params, None)
    # what a sync after every step costs: the same step, synced after each
    # call, then unsynced with an event after each
    synced, events = [], []
    for _ in range(SERVE_SYNC_STEPS):
        t_step = time.monotonic()
        serve_step(params, cache, tok, last)
        torch.cuda.synchronize()
        synced.append((time.monotonic() - t_step) * 1e3)
    first = torch.cuda.Event(enable_timing=True)
    first.record()
    for _ in range(SERVE_SYNC_STEPS):
        evented_calls(torch, serve_step, events)(params, cache, tok, last)
    torch.cuda.synchronize()
    unsynced = [a.elapsed_time(b)
                for a, b in zip([first] + events[:-1], events)]

    prefill_s = start.elapsed_time(prefill_end) / 1e3
    decode_s = prefill_end.elapsed_time(step_events[-1]) / 1e3
    entry = {
        "config": name, "arch_type": cfg.arch_type, "dtype": dtype_name,
        "cache_dtype": cache_dtype, "driven_by": how, "n_params": n_params,
        "init_s": init_s, "slots": SERVE_SLOTS, "prompt": prompt_len,
        "decode": SERVE_DECODE, "batched_prefill": batched,
        "launches": launches, "decode_launches_per_step": per_step,
        "prefill_tokens_per_s": SERVE_SLOTS * prompt_len / prefill_s,
        "decode_tokens_per_s": SERVE_SLOTS * decode_steps / decode_s,
        "prefill_ms": prefill_s * 1e3,
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p95": float(np.percentile(step_ms, 95)),
        "generate_wall_s": wall_s, "peak_gib": peak / 2 ** 30,
        "last_step_ms_p50_synced": float(np.percentile(synced, 50)),
        "last_step_ms_p50_unsynced": float(np.percentile(unsynced, 50)),
        "decode_step_requested_bytes": step_bytes,
        "layer_kv_f32_bytes": layer_kv_f32,
        "profile": {k: v for k, v in profile.items() if k != "top"},
        "top_kernels": profile.get("top")}
    log(f"  {name} ({cfg.arch_type}, {dtype_name} params, {cache_dtype} "
        f"cache, {how}): {n_params} params drawn in {init_s:.2f} s; "
        f"prefill {entry['prefill_tokens_per_s']:.1f} tokens/s "
        f"({'one batched call' if batched else 'a step a token'}), decode "
        f"{entry['decode_tokens_per_s']:.1f} tokens/s, step ms p50 "
        f"{entry['step_ms_p50']:.3f} p95 {entry['step_ms_p95']:.3f} (CUDA "
        f"events, one sync a generate); generate {wall_s:.3f} s; the last "
        f"position's step p50 {entry['last_step_ms_p50_synced']:.3f} ms "
        f"synced after each, {entry['last_step_ms_p50_unsynced']:.3f} "
        f"unsynced; peak "
        f"{entry['peak_gib']:.3f} GiB; a decode step requested {step_bytes} "
        f"B (one layer's K and V in f32: {layer_kv_f32}); launches "
        f"{launches}")

    rel_tol = ZOO_LOGIT_REL_TOL[dtype_name]
    if per_step == 0 and not batched:
        entry["parity"] = None
        log(f"  {name}: no kernel on its serving path, so no route to "
            f"compare (its reduced config runs card vs CPU below)")
    else:
        t0 = time.monotonic()
        entry["parity"] = serve_parity(torch, cfg, params, cache_dtype,
                                       prompts, tokens, rel_tol)
        entry["parity"]["seconds"] = time.monotonic() - t0
        log(f"  {name}, kernel vs plain route over "
            f"{entry['parity']['prompt']} prompt tokens and "
            f"{entry['parity']['steps']} decode steps: "
            f"{json.dumps(entry['parity'])} (rule {rel_tol} x max |logit|)")
    return entry, server


def serve_reduced(torch, name, cache_dtype="float32"):
    """A reduced config served on the card's kernels against the same
    weights on the CPU's plain versions, step by step on the CPU's greedy
    tokens: logits within REDUCED_TOL of the largest, greedy tokens equal
    where the top-2 margin exceeds twice that.

    Under a bfloat16 cache each device rounds its own float32 K/V (and SSM
    state) to bf16, so an element whose two float32 values straddle a
    rounding boundary lands one bf16 step apart, and the caches drift.  So
    there the CPU's cache is copied to the card before every step: both
    steps read the same bf16 cache, and the rule holds at REDUCED_TOL.  The
    cache elements each step then writes differently are counted, with
    their largest gap over their leaf's largest |value|, and beside them
    the gap of a card run on its own cache (not held to the rule) is
    reported."""
    from repro_torch import configs, tree
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer

    cfg = configs.reduced(configs.get_arch(name))
    slots, prompt_len, decode_len = 4, 12, 8
    cpu = BatchedServer(cfg, slots, prompt_len + decode_len, seed=SEED,
                        device="cpu")
    params = tree.map(lambda t: t.to("cuda"), cpu.params)
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (slots, prompt_len)).astype(np.int32)
    tokens = cpu.generate(prompts, decode_len)
    shared = cache_dtype == "bfloat16"
    caches = {label: transformer.init_cache(
        cfg, slots, prompt_len + decode_len, getattr(torch, cache_dtype),
        device) for label, device in (("cpu", "cpu"), ("card", "cuda"),
                                      ("own", "cuda"))}
    serve = make_serve_step(cfg)
    out = {"worst": 0.0, "own_cache_worst": None, "differing_elements": 0,
           "max_gap_of_leaf_max": 0.0}
    own = 0.0
    sequence = np.concatenate([prompts, tokens[:, :-1]], axis=1)
    for t in range(sequence.shape[1]):
        tok = torch.as_tensor(sequence[:, t:t + 1])
        if shared:
            tree.map(lambda a, b: b.copy_(a), caches["cpu"], caches["card"])
        _, expected, _ = serve(cpu.params, caches["cpu"], tok, t)
        _, logits, _ = serve(params, caches["card"], tok.to("cuda"), t)
        largest = expected.abs().max().item()
        tol = REDUCED_TOL * largest
        err = (logits.cpu() - expected).abs().max().item()
        top2 = torch.topk(expected, 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = logits.argmax(-1).cpu() == expected.argmax(-1)
        check(err <= tol and bool(same[decided].all()),
              f"reduced {name} serving ({cache_dtype} cache), card vs CPU, "
              f"position {t}: logits differ by {err} (tol {tol}) or greedy "
              f"tokens differ")
        out["worst"] = max(out["worst"], err / largest)
        if shared:
            for a, b in zip(tree.leaves(caches["cpu"]),
                            tree.leaves(caches["card"])):
                a, b = a.float(), b.cpu().float()
                out["differing_elements"] += int((a != b).sum())
                out["max_gap_of_leaf_max"] = max(
                    out["max_gap_of_leaf_max"], (a - b).abs().max().item()
                    / max(a.abs().max().item(), 1e-30))
            _, alone, _ = serve(params, caches["own"], tok.to("cuda"), t)
            own = max(own, (alone.cpu() - expected).abs().max().item()
                      / largest)
    if shared:
        out["own_cache_worst"] = own
    log(f"  reduced {name} ({cache_dtype} cache), card kernels vs CPU plain "
        f"route over {sequence.shape[1]} serve steps"
        f"{', the CPU cache copied to the card before each' if shared else ''}"
        f": max |d logits| = {out['worst']:.3e} of the largest (tol "
        f"{REDUCED_TOL})" + (
            f"; {out['differing_elements']} cache elements written "
            f"differently, the largest gap {out['max_gap_of_leaf_max']:.3e} "
            f"of its leaf's largest |value| (one bf16 step of it: "
            f"{2.0 ** -8:.3e}); on the card's own cache {own:.3e} (not held)"
            if shared else ""))
    return out


def fig17_prefill(torch, kernels):
    """fig17's tier 1 on the card: BatchedServer on reduced qwen3-1.7b,
    prefill tokens/s with one batched call against one serve step a
    token, each over FIG17_PREFILL's iterations after one untimed call;
    the batched call must be at least FIG17_PREFILL["ratio"]x faster."""
    from repro_torch import configs
    from repro_torch.launch.serve import BatchedServer

    cfg = configs.reduced(configs.get_arch("qwen3-1.7b"))
    slots, length, iters = (FIG17_PREFILL[k] for k in ("slots", "length",
                                                       "iters"))
    rates = {}
    for batched in (False, True):
        server = BatchedServer(cfg, slots, length, batched_prefill=batched,
                               device="cuda")
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (slots, length)).astype(np.int32)
        fresh = server.cache
        server.prefill(prompts).cpu()
        zero_launches(kernels)
        t0 = time.perf_counter()
        for _ in range(iters):
            server.cache = fresh
            server.prefill(prompts).cpu()
        rates["batched" if batched else "token_at_a_time"] = (
            iters * slots * length / (time.perf_counter() - t0))
        rates[f"launches_{'batched' if batched else 'token_at_a_time'}"] = (
            kernel_launches(kernels))
    ratio = rates["batched"] / rates["token_at_a_time"]
    rates["ratio"] = ratio
    log(f"  fig17 tier 1 (reduced qwen3-1.7b, {slots} x {length} tokens): "
        f"batched prefill {rates['batched']:.1f} tokens/s, token at a time "
        f"{rates['token_at_a_time']:.1f}: {ratio:.2f}x; launches "
        f"{rates['launches_token_at_a_time']} and "
        f"{rates['launches_batched']}")
    check(ratio >= FIG17_PREFILL["ratio"], f"fig17 tier 1: batched prefill "
          f"only {ratio:.2f}x token-at-a-time")
    return rates


def time_decode_serving(kernel, ref, torch, plan_splits):
    """Phase 5: the decode kernel at phase 24's serving shapes
    (DECODE_SERVING), beside its bound and SDPA."""
    from repro_torch import configs

    shapes = []
    length = DECODE_SERVING_KEYS
    for label, name, dtype_name, kv_dtype in DECODE_SERVING:
        cfg = configs.get_arch(name)
        entry = time_decode_shape(kernel, ref, torch, plan_splits,
                                  SERVE_SLOTS, cfg.num_heads,
                                  cfg.num_kv_heads, length, cfg.head_dim,
                                  length, dtype_name, kv_dtype)
        entry["label"] = label
        shapes.append(entry)
        log(f"  decode_attention at {label}'s serving shape "
            f"{json.dumps(entry)}; {entry['bound_ms'] / entry['ms']:.3f} of "
            f"its bound, {entry['ms'] / entry['library_ms']:.3f}x SDPA")
        check(entry["max_abs_err_timed"] <= TOL[dtype_name],
              f"decode_attention at {label}: max_abs_err "
              f"{entry['max_abs_err_timed']}")
    return shapes


def zoo_serving(torch, kernels):
    """Phase 24: SERVE_ZOO in turn, each model freed before the next;
    fig17's tier 1; then a reduced config of each family served on the
    card against the CPU."""
    import gc

    results, server = [], None
    for i, (name, dtype_name, cache_dtype, how) in enumerate(SERVE_ZOO):
        t0 = time.monotonic()
        entry, server = serve_config(torch, kernels, name, dtype_name,
                                     cache_dtype, how, server)
        if i + 1 == len(SERVE_ZOO) or SERVE_ZOO[i + 1][0] != name:
            server = None
        gc.collect()
        torch.cuda.empty_cache()
        entry["seconds"] = time.monotonic() - t0
        results.append(entry)
        log(f"  {name}: {entry['seconds']:.1f} s in all")

    fig17 = fig17_prefill(torch, kernels)
    reduced = {f"{name}_{cache_dtype}_cache": serve_reduced(torch, name,
                                                            cache_dtype)
               for cache_dtype in ("float32", "bfloat16") for name in
               ("qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-780m",
                "zamba2-1.2b", "internvl2-26b", "whisper-base")}
    return {"configs": results, "fig17": fig17, "reduced": reduced}


# ------------------------------------------------------------- training
def train_optimizer(steps, lr=3e-4):
    """launch/train.py's optimizer for a run of ``steps`` steps."""
    from repro_torch.optim import adam, cosine_schedule
    return adam(cosine_schedule(lr, steps, warmup_steps=10), clip=1.0)


def kernel_sites(cfg):
    """(attention sites, Mamba2 layers) of one forward pass: flash
    launches once a site (Whisper's encoder, its decoder's self- and
    cross-attention) and the SSD scan once a layer."""
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return cfg.num_layers, 0
    if cfg.arch_type == "ssm":
        return 0, cfg.num_layers
    if cfg.arch_type == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every, cfg.num_layers
    return cfg.encoder_layers + 2 * cfg.num_layers, 0


def train_launches(cfg, objective, remat, microbatches=1):
    """Kernel launches of one train step: the forward with grad once a
    site or layer, twice under remat (a checkpointed block runs again in
    the backward, its kernels included), DQN's target forward (no grad)
    once more, for each microbatch; the backward kernels once a site or
    layer a microbatch, whatever the remat."""
    attention, mamba = kernel_sites(cfg)
    passes = (1 if remat == "none" else 2) + (objective == "dqn")
    return {"flash_attention": attention * passes * microbatches,
            "ssd_scan": mamba * passes * microbatches,
            "flash_attention_bwd": attention * microbatches,
            "ssd_scan_bwd": mamba * microbatches,
            "decode_attention": 0, "vtrace": 0}


def device_time(events, DeviceType):
    """Device ms of the CUDA entries of ``key_averages()``, and them."""
    cuda = [e for e in events if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sum(e.self_device_time_total for e in cuda) / 1e3, cuda


def backward_device_ms(prof, name):
    """Device ms of the kernels launched inside the backward of autograd
    Function ``name`` (its backward kernel), over the outermost profiler
    events that carry its name, and their count."""
    outer = []
    for e in prof.events():
        if name not in e.name:
            continue
        parent = e.cpu_parent
        while parent is not None and name not in parent.name:
            parent = parent.cpu_parent
        if parent is None:
            outer.append(e)
    return sum(e.device_time_total for e in outer) / 1e3, len(outer)


def profile_train_step(torch, run):
    """``run()`` (one train step) under torch.profiler: the wall ms, the
    device's busy ms and idle share, and device ms by kind: the flash and
    SSD kernels' forwards, their autograd Functions' backwards (the
    backward kernels), and GEMMs (any kernel named ``*gemm*``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    device_ms, cuda = device_time(prof.key_averages(), DeviceType)
    if device_ms == 0:
        log("  profile: the profiler recorded no device time (not measured)")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}

    def kind(test):
        return sum(e.self_device_time_total for e in cuda
                   if test(e.key.lower())) / 1e3
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1 - device_ms / wall_ms,
           "gemm_ms": kind(lambda k: "gemm" in k),
           "flash_forward_ms": kind(lambda k: "flash_attention_kernel" in k),
           # the backward's local states run the chunk launch (, true>)
           "ssd_forward_ms": kind(lambda k: "ssd_" in k and "kernel" in k
                                  and "ssd_bwd" not in k
                                  and ", true>" not in k)}
    for key, fn in (("flash_backward", "FlashAttentionFunctionBackward"),
                    ("ssd_backward", "SSDScanFunctionBackward")):
        out[f"{key}_ms"], out[f"{key}_calls"] = backward_device_ms(prof, fn)
    for key in ("gemm", "flash_forward", "ssd_forward", "flash_backward",
                "ssd_backward"):
        out[f"{key}_share"] = out[f"{key}_ms"] / device_ms
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:12]
    out["top"] = [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                  for e in top]
    log(f"  profile of one train step: wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms, idle share {out['idle_share']:.3f}; GEMMs "
        f"{out['gemm_ms']:.1f} ms ({out['gemm_share']:.3f}), the backward "
        f"kernels: flash {out['flash_backward_ms']:.1f} ms "
        f"({out['flash_backward_share']:.3f}, {out['flash_backward_calls']} "
        f"calls), SSD {out['ssd_backward_ms']:.1f} ms "
        f"({out['ssd_backward_share']:.3f}, {out['ssd_backward_calls']} "
        f"calls); kernel forwards: flash {out['flash_forward_ms']:.1f} ms, "
        f"SSD {out['ssd_forward_ms']:.1f} ms")
    for key, count, ms in out["top"]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key}")
    return out


def measured_update(torch, opt, steps_module, record):
    """``opt`` with its update measured: the device memory allocated just
    before ``update`` and the peak from there to the end of the
    ``apply_updates`` that follows it (patched in ``steps_module``), into
    ``record``.  Resets the allocator's peak."""
    from repro_torch.optim import Optimizer
    apply = steps_module.apply_updates

    def update(grads, state, params=None):
        record["before"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return opt.update(grads, state, params)

    def apply_updates(params, updates):
        out = apply(params, updates)
        record["peak"] = torch.cuda.max_memory_allocated()
        return out
    return Optimizer(opt.init, update), apply_updates


def train_zamba2(torch, kernels):
    """Phase 25 (a): ``launch.train.main`` on Zamba2-1.2B at full width
    and depth, each step timed by CUDA events (``make_train_step``
    wrapped; the step itself is train.py's); exact launch counts; the CE
    must fall.  Then one more step under torch.profiler with its optimizer
    update's memory measured, and the Functions' backwards timed at the
    step's attention and SSD shapes."""
    from unittest import mock

    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train

    seen = {"events": [], "ce": []}
    make = train.make_train_step

    def timed_make(cfg, opt, **kwargs):
        seen.update(cfg=cfg, opt=opt, kwargs=kwargs)
        step = make(cfg, opt, **kwargs)

        def timed(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, metrics = step(state, batch)
            end.record()
            seen["events"].append((start, end))
            seen["ce"].append(metrics["ce"])
            seen.update(state=state, batch=batch)
            return state, metrics
        return timed

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    t0 = time.monotonic()
    with mock.patch.object(train, "make_train_step", timed_make):
        rc = train.main(TRAIN_ZAMBA_ARGV)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    launches = kernel_launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    cfg = seen["cfg"]
    per_step = train_launches(cfg, "bc", seen["kwargs"]["remat"])
    ce = [float(x) for x in seen["ce"]]
    step_ms = [a.elapsed_time(b) for a, b in seen["events"]]
    check(rc == 0, f"train.main({' '.join(TRAIN_ZAMBA_ARGV)}) returned {rc}: "
          f"the CE did not fall ({ce[0]} -> {ce[-1]})")
    check(all(math.isfinite(x) for x in ce), f"non-finite CE: {ce}")
    check(launches == {k: n * TRAIN_ZAMBA_STEPS for k, n in per_step.items()},
          f"train.main on {ZAMBA}: launches {launches}, expected "
          f"{per_step} a step x {TRAIN_ZAMBA_STEPS}")
    b, s = TRAIN_ZAMBA_SHAPE
    params = seen["state"].params
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(params))
    p50 = float(np.percentile(step_ms, 50))
    p95 = float(np.percentile(step_ms, 95))
    out = {"argv": TRAIN_ZAMBA_ARGV, "rc": rc, "ce_first": ce[0],
           "ce_last": ce[-1], "launches": launches,
           "launches_per_step": per_step, "wall_s": wall_s,
           "step_ms": step_ms, "step_ms_p50": p50, "step_ms_p95": p95,
           "steps_per_s": 1e3 * len(step_ms) / sum(step_ms),
           "tokens_per_s": 1e3 * len(step_ms) * b * s / sum(step_ms),
           "peak_gib": peak / 2 ** 30, "param_gb": param_bytes / 1e9}
    log(f"  {ZAMBA}: {TRAIN_ZAMBA_STEPS} steps of {b} x {s} tokens through "
        f"train.main in {wall_s:.1f} s (init included): CE {ce[0]:.4f} -> "
        f"{ce[-1]:.4f}; launches {launches}; step ms (CUDA events) p50 "
        f"{p50:.3f} p95 {p95:.3f} min {min(step_ms):.3f} max "
        f"{max(step_ms):.3f}; {out['steps_per_s']:.4f} steps/s, "
        f"{out['tokens_per_s']:.1f} tokens/s; peak {out['peak_gib']:.3f} "
        f"GiB; params {param_bytes / 1e9:.3f} GB")

    record = {}
    opt, apply_updates = measured_update(torch, seen["opt"], steps, record)
    step = make(cfg, opt, **seen["kwargs"])
    state, batch = seen.pop("state"), seen.pop("batch")
    with mock.patch.object(steps, "apply_updates", apply_updates):
        out["profile"] = profile_train_step(
            torch, lambda: step(state, batch))
    del state
    out["update"] = {
        "allocated_before_gib": record["before"] / 2 ** 30,
        "peak_gib": record["peak"] / 2 ** 30,
        "peak_param_copies": record["peak"] / param_bytes,
        "rise_param_copies": (record["peak"] - record["before"])
        / param_bytes}
    log(f"  the optimizer update (Adam, clip, apply_updates) alone: "
        f"{out['update']['allocated_before_gib']:.3f} GiB allocated before, "
        f"peak {out['update']['peak_gib']:.3f} GiB = "
        f"{out['update']['peak_param_copies']:.2f} param-sized copies "
        f"({out['update']['rise_param_copies']:.2f} above what was live)")

    # the Functions' forwards and backwards at this step's shapes
    torch.cuda.empty_cache()
    qkv = [t.requires_grad_() for t in flash_inputs(
        b, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.head_dim,
        torch.float32, np.random.RandomState(SEED + 25))]
    fwd, bwd = time_backward(torch, lambda *t: ops.flash_attention(
        *t, causal=True, window=cfg.sliding_window), qkv)
    out["flash_attention"] = {"shape": [b, cfg.num_heads, s, cfg.head_dim],
                              "fwd_ms": fwd, "bwd_ms": bwd}
    del qkv
    ssm = cfg.ssm
    inputs = [t.requires_grad_() for t in ssd_inputs(
        b, s, ssm.num_heads(cfg.d_model), ssm.head_dim, ssm.d_state,
        np.random.RandomState(SEED + 26), model_like=True)]
    fwd, bwd = time_backward(torch, lambda *t: ops.ssd_scan(
        *t, chunk=ssm.chunk_size), inputs)
    out["ssd_scan"] = {"shape": [b, s, ssm.num_heads(cfg.d_model),
                                 ssm.head_dim, ssm.d_state],
                       "fwd_ms": fwd, "bwd_ms": bwd}
    del inputs
    for name in ("flash_attention", "ssd_scan"):
        entry = out[name]
        entry["bwd_ms_per_step"] = entry["bwd_ms"] * per_step[name]
        log(f"  {name} at the training shape {entry['shape']}, eager ms: "
            f"forward kernel {entry['fwd_ms']:.3f}, backward kernel "
            f"{entry['bwd_ms']:.3f}; x{per_step[name]} a step = "
            f"{entry['bwd_ms_per_step']:.1f} ms, "
            f"{entry['bwd_ms_per_step'] / p50:.3f} of the step's p50")
    torch.cuda.empty_cache()
    return out


def first_moments(state):
    from repro_torch import tree
    return tree.leaves(state.opt_state.mu)


def train_dense_width(torch, kernels):
    """Phase 25 (b): qwen3-1.7b's published width at TRAIN_DENSE_LAYERS
    layers, make_train_step(remat="full", microbatches=2): the first step
    against remat="none" from the same state (loss, and every grad leaf
    through Adam's first moments), then TRAIN_DENSE_STEPS steps timed by
    CUDA events with exact flash launches and the peak memory of the
    steps after the first (which holds remat "none"'s moments beside its
    own to compare them)."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.launch import steps, train

    cfg = dataclasses.replace(configs.get_arch(TRAIN_DENSE),
                              num_layers=TRAIN_DENSE_LAYERS)
    opt = train_optimizer(TRAIN_DENSE_STEPS)
    b, s = TRAIN_DENSE_SHAPE
    state = steps.init_train_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, opt,
        device="cuda")
    n_params = sum(t.numel() for t in tree.leaves(state.params))
    batch = train.make_corpus_sampler(cfg.vocab_size, s, b)()
    out = {"config": f"{TRAIN_DENSE} at {TRAIN_DENSE_LAYERS} of its "
           f"{configs.get_arch(TRAIN_DENSE).num_layers} layers",
           "n_params": n_params, "shape": [b, s],
           "microbatches": TRAIN_DENSE_MICROBATCHES}

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain_step = steps.make_train_step(
        cfg, opt, remat="none", microbatches=TRAIN_DENSE_MICROBATCHES)
    after, metrics_none = plain_step(state, batch)
    mu_none = first_moments(after)
    del after
    out["peak_gib_remat_none"] = torch.cuda.max_memory_allocated() / 2 ** 30

    step = steps.make_train_step(cfg, opt, remat="full",
                                 microbatches=TRAIN_DENSE_MICROBATCHES)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    times = []
    for i in range(TRAIN_DENSE_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, metrics = step(state, batch)
        end.record()
        times.append((start, end))
        if i == 0:
            launches = kernel_launches(kernels)
            first = metrics
            worst = 0.0
            for a, c in zip(first_moments(state), mu_none):
                scale = max(c.abs().max().item(), 1e-30)
                worst = max(worst, (a - c).abs().max().item() / scale)
            # the peak over the steps after, without remat "none"'s moments
            del mu_none
            torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(c) for a, c in times]
    per_step = train_launches(cfg, "bc", "full", TRAIN_DENSE_MICROBATCHES)
    loss_err = {k: abs(float(first[k]) - float(metrics_none[k]))
                / max(abs(float(metrics_none[k])), 1e-30)
                for k in metrics_none}
    out.update(launches_first_step=launches, launches_per_step=per_step,
               step_ms=step_ms, step_ms_p50=float(np.percentile(step_ms, 50)),
               tokens_per_s=1e3 * b * s * len(step_ms) / sum(step_ms),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               remat_full_vs_none={"metrics_rel_err": loss_err,
                                   "grads_max_rel_err": worst},
               ce=[float(first["ce"]), float(metrics["ce"])])
    log(f"  {out['config']} ({n_params} parameters, float32), "
        f"{TRAIN_DENSE_STEPS} steps of {b} x {s} tokens in "
        f"{TRAIN_DENSE_MICROBATCHES} microbatches under remat 'full': "
        f"flash launches in the first step {launches['flash_attention']}; "
        f"step ms {', '.join(f'{t:.1f}' for t in step_ms)}; "
        f"{out['tokens_per_s']:.1f} tokens/s; peak {out['peak_gib']:.3f} "
        f"GiB (remat 'none': {out['peak_gib_remat_none']:.3f}); CE "
        f"{out['ce'][0]:.4f} -> {out['ce'][1]:.4f}; first step against "
        f"remat 'none': metrics {loss_err}, grads {worst:.3e} of each "
        f"leaf's largest (tol {TRAIN_REMAT_TOL})")
    check(launches == per_step, f"{out['config']}: launches {launches} in "
          f"the first step, expected {per_step}")
    check(worst <= TRAIN_REMAT_TOL
          and all(e <= TRAIN_REMAT_TOL for e in loss_err.values()),
          f"{out['config']}: remat 'full' against 'none': grads {worst}, "
          f"metrics {loss_err} (tol {TRAIN_REMAT_TOL})")
    check(all(math.isfinite(x) for x in out["ce"]), f"non-finite CE "
          f"{out['ce']}")
    del state
    torch.cuda.empty_cache()
    return out


def train_batch(cfg, objective, seed=SEED):
    """A numpy batch of TRAIN_REDUCED_SHAPE: tokens, labels, rewards,
    discounts, and the VLM's vision or Whisper's frames (0.1 x normal)."""
    b, s = TRAIN_REDUCED_SHAPE
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)),
             "labels": rng.randint(0, cfg.vocab_size, (b, s)),
             "rewards": rng.rand(b, s).astype(np.float32),
             "discounts": (0.9 * (rng.rand(b, s) > 0.1)).astype(np.float32)}
    extra = {"vlm": ("vision", cfg.vision_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.arch_type)
    if extra:
        batch[extra[0]] = (0.1 * rng.randn(b, extra[1], cfg.d_model)
                           ).astype(np.float32)
    return batch


def train_card_vs_cpu(torch, kernels, name, objective):
    """Phase 25 (c): one make_train_step(remat="full") step of a reduced
    ``name`` on the card's kernels against the CPU's plain versions from
    the same state (train.py's optimizer): the metrics, and params, Adam's
    moments (the first are 0.1 x the clipped grads) and the DQN target
    leaf for leaf, within TRAIN_CARD_TOL of each leaf's largest magnitude;
    exact launch counts; for MoE the tokens a router sends to another
    expert on one route, counted under MOE_REROUTED_MAX."""
    from repro_torch import configs, tree
    from repro_torch.launch import steps

    cfg = configs.reduced(configs.get_arch(name))
    opt = train_optimizer(20)
    cpu = steps.init_train_state(torch.Generator().manual_seed(SEED), cfg,
                                 opt, device="cpu", objective=objective)
    card = tree.map(lambda t: t.to("cuda"), cpu)
    batch = train_batch(cfg, objective)
    step = steps.make_train_step(cfg, opt, objective=objective, remat="full")

    zero_launches(kernels)
    if cfg.arch_type == "moe":
        (card, card_metrics), card_choices = router_choices(
            lambda: step(card, batch))
        launches = kernel_launches(kernels)
        (cpu, cpu_metrics), cpu_choices = router_choices(
            lambda: step(cpu, batch))
        check(len(card_choices) == len(cpu_choices),
              f"{name}: {len(card_choices)} and {len(cpu_choices)} router "
              "calls")
        rerouted = routed = 0
        layers = cfg.num_layers
        for i in range(0, len(card_choices), layers):
            _, moved = differing_choices(
                torch, cfg, card_choices[i:i + layers],
                [c.to("cuda") for c in cpu_choices[i:i + layers]],
                TRAIN_REDUCED_SHAPE)
            rerouted += int(moved.sum())
            routed += moved.numel()
        check(rerouted <= MOE_REROUTED_MAX * routed,
              f"{name} {objective}: {rerouted} of {routed} routed tokens "
              f"rerouted, more than {MOE_REROUTED_MAX:.0%}")
        routing = {"rerouted_tokens": rerouted, "routed_tokens": routed}
    else:
        card, card_metrics = step(card, batch)
        launches = kernel_launches(kernels)
        cpu, cpu_metrics = step(cpu, batch)
        routing = None
    expected = train_launches(cfg, objective, "full")
    check(launches == expected, f"reduced {name} {objective} train step: "
          f"launches {launches}, expected {expected}")

    worst = {}
    for key in cpu_metrics:
        a, c = float(card_metrics[key]), float(cpu_metrics[key])
        worst[f"metric_{key}"] = abs(a - c) / max(abs(c), 1e-30)
    for part, a_tree, c_tree in (
            ("params", card.params, cpu.params),
            ("mu", card.opt_state.mu, cpu.opt_state.mu),
            ("nu", card.opt_state.nu, cpu.opt_state.nu),
            ("target", card.target_params, cpu.target_params)):
        err = 0.0
        for a, c in zip(tree.leaves(a_tree), tree.leaves(c_tree)):
            scale = max(c.abs().max().item(), 1e-30)
            err = max(err, (a.cpu() - c).abs().max().item() / scale)
        if c_tree is not None:
            worst[part] = err
    log(f"  reduced {name} ({cfg.arch_type}), {objective}, remat 'full', "
        f"card kernels vs CPU plain versions after one step: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (tol {TRAIN_CARD_TOL}); launches {launches}"
        + ("" if routing is None else f"; rerouted {routing}"))
    check(all(v <= TRAIN_CARD_TOL for v in worst.values()),
          f"reduced {name} {objective} train step, card vs CPU: {worst} "
          f"(tol {TRAIN_CARD_TOL})")
    return {"config": name, "objective": objective, "launches": launches,
            "max_rel_err": worst, "routing": routing}


def training(torch, kernels):
    """Phase 25: (a) train.main on Zamba2-1.2B, (b) qwen3-1.7b's width
    under full remat and microbatches, (c) reduced families card vs CPU."""
    t0 = time.monotonic()
    out = {"zamba2": train_zamba2(torch, kernels)}
    out["zamba2"]["seconds"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["dense_width"] = train_dense_width(torch, kernels)
    out["dense_width"]["seconds"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["reduced"] = [train_card_vs_cpu(torch, kernels, name, objective)
                      for name, objective in TRAIN_FAMILIES]
    out["reduced_seconds"] = time.monotonic() - t0
    return out


# ------------------------------------------------------ the launch layer
def start_dryruns(tmp):
    """Phase 26 (b): the dry run of each LAUNCH_DRYRUNS combo on the single
    production mesh, each in a subprocess of its own with the card hidden
    (it traces fake tensors and launches nothing), started together."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = []
    for arch, shape in LAUNCH_DRYRUNS:
        out = Path(tmp) / f"{arch}_{shape}.jsonl"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        runs.append((arch, shape, out, proc, time.monotonic()))
    return runs


def finish_dryruns(runs):
    """Wait for phase 26 (b)'s subprocesses and hold each record to the
    JAX package's dry-run test (``tests/test_dryrun_small.py:23-29``):
    status ok, 256 ranks, fits the card's memory, a dominant term, FLOPs
    counted.  Whether each traced within LAUNCH_TRAIN_TRACE_S is printed,
    not gated: the trace's seconds follow the host's speed."""
    records = []
    for arch, shape, out, proc, t0 in runs:
        try:
            _, stderr = proc.communicate(timeout=LAUNCH_DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            check(False, f"dry run {arch} x {shape}: no record after "
                  f"{LAUNCH_DRYRUN_TIMEOUT_S} s")
        check(proc.returncode == 0, f"dry run {arch} x {shape} exited "
              f"{proc.returncode}: {stderr[-2000:]}")
        rec = json.loads(out.read_text().splitlines()[-1])
        check(rec["status"] == "ok", f"dry run {arch} x {shape}: "
              f"{rec.get('error')}")
        check(rec["chips"] == 256, f"dry run {arch} x {shape}: "
              f"{rec['chips']} ranks")
        check(rec["memory"]["fits_hbm"], f"dry run {arch} x {shape}: "
              f"{rec['memory']} does not fit")
        check(rec["roofline"]["dominant"] in ("compute", "memory",
                                              "collective"),
              f"dry run {arch} x {shape}: {rec['roofline']}")
        check(rec["hlo"]["flops"] > 0, f"dry run {arch} x {shape}: no FLOPs")
        rec["command_s"] = time.monotonic() - t0
        rec["within_trace_budget"] = rec["trace_s"] <= LAUNCH_TRAIN_TRACE_S
        r, m = rec["roofline"], rec["memory"]
        log(f"  dry run {arch} x {shape} x single (256 fake ranks, plain "
            f"route; predictions against datasheet figures): trace "
            f"{rec['trace_s']} s ({rec['command_s']:.1f} s with the "
            f"interpreter); approx_live_bytes {m['approx_live_bytes']} "
            f"(fits {m['fits_hbm']}); compute {r['compute_s']:.6f} s, "
            f"memory {r['memory_s']:.6f} s, collective "
            f"{r['collective_s']:.6f} s, dominant {r['dominant']}; FLOPs "
            f"{rec['hlo']['flops']:.4e} a rank; DTensor rules "
            f"{rec.get('dtensor_rules')}; within {LAUNCH_TRAIN_TRACE_S:.0f} s "
            f"of tracing: {rec['within_trace_budget']}")
        rec.pop("traceback", None)
        records.append(rec)
    return records


def launch_train_parity(torch, kernels):
    """Phase 26 (a): the host mesh on the card, and a reduced qwen3-1.7b
    through train.main under it (its rules on) against the same run
    without rules: every step's metrics and the final params bit-equal."""
    import argparse
    from unittest import mock

    import torch.distributed as dist

    from repro_torch import sharding, tree
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train

    check(not dist.is_initialized(), "a process group is up before phase 26")
    host = mesh_lib.make_host_mesh("cuda")
    check(host.device_type == "cuda" and tuple(host.shape) == (1, 1)
          and host.mesh_dim_names == ("data", "model"),
          f"host mesh {host}")
    check(dist.get_world_size() == 1, "host mesh's group is not one rank")
    dist.destroy_process_group()
    out = {"host_mesh": str(host), "device": str(torch.device("cuda", 0))}
    log(f"  make_host_mesh('cuda'): {host} on {out['device']}")

    runs = {}

    def recorder(key):
        make = train.make_train_step

        def recording_make(cfg, opt, **kwargs):
            step = make(cfg, opt, **kwargs)

            def recorded(state, batch):
                state, metrics = step(state, batch)
                run = runs.setdefault(key, {"metrics": [], "rules": []})
                run["metrics"].append({k: v.detach().cpu() for k, v in
                                       metrics.items()})
                run["rules"].append(sharding.current_rules())
                run["state"] = state
                return state, metrics
            return recorded
        return recording_make

    meshes = []
    host_mesh = mesh_lib.make_host_mesh

    def spy_mesh(device):
        meshes.append(host_mesh(device))
        return meshes[-1]

    cfg = reduced(get_arch("qwen3-1.7b"))
    per_run = {k: n * 5 for k, n in train_launches(cfg, "bc", "none").items()}
    zero_launches(kernels)
    with mock.patch.object(train, "make_train_step", recorder("rules")), \
            mock.patch.object(train, "make_host_mesh", spy_mesh):
        rc = train.main(LAUNCH_TRAIN_ARGV)
    torch.cuda.synchronize()
    launches = kernel_launches(kernels)
    check(launches == per_run, f"train.main under the host mesh: launches "
          f"{launches}, expected {per_run}")
    check(not dist.is_initialized(), "train.main left its group up")
    args = argparse.Namespace(
        arch="qwen3-1.7b", steps=5, batch=4, seq=64, lr=3e-4,
        objective="bc", checkpoint_dir=None, full_size=False, device="cuda")
    zero_launches(kernels)
    with mock.patch.object(train, "make_train_step", recorder("plain")):
        rc_plain = train._train(cfg, args)
    torch.cuda.synchronize()
    check(kernel_launches(kernels) == per_run, f"the run without rules: "
          f"launches {kernel_launches(kernels)}, expected {per_run}")
    a, b = runs["rules"], runs["plain"]
    check(len(meshes) == 1 and meshes[0].device_type == "cuda"
          and tuple(meshes[0].shape) == (1, 1), f"train.main's mesh {meshes}")
    check(all(r is not None and r.mesh is meshes[0] for r in a["rules"]),
          "train.main's steps did not run under the host mesh's rules")
    check(all(r is None for r in b["rules"]), "rules left on")
    check(rc == rc_plain and len(a["metrics"]) == len(b["metrics"]) == 5,
          f"train.main {rc}, without rules {rc_plain}")
    for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
        check(ma.keys() == mb.keys() and all(
            torch.equal(ma[k], mb[k]) for k in ma),
            f"step {i}: metrics {ma} under the host mesh, {mb} without")
    pa, pb = tree.leaves(a["state"].params), tree.leaves(b["state"].params)
    check(all(x.device.type == "cuda" for x in pa), "params left the card")
    check(len(pa) == len(pb) and all(torch.equal(x, y)
                                     for x, y in zip(pa, pb)),
          "params after 5 steps differ with and without the rules")
    out.update(rc=rc, ce=[float(m["ce"]) for m in a["metrics"]],
               leaves=len(pa), train_mesh=str(meshes[0]), launches=launches)
    log(f"  train.main {' '.join(LAUNCH_TRAIN_ARGV)} under {meshes[0]}: "
        f"CE {out['ce'][0]:.6f} -> {out['ce'][-1]:.6f}, launches {launches} "
        f"in each run; every step's metrics and all {len(pa)} param leaves "
        f"bit-equal to the run without rules")
    return out


def dryrun_train_step(torch, phase25):
    """Phase 26 (c): phase 25's step (Zamba2-1.2B, 4 x 1024 tokens,
    float32, remat "none", one microbatch, Adam with clip 1.0) dry-run on
    a (1, 1) fake mesh: the predicted peak of live bytes, and the peak of
    the optimizer update in param-sized copies, beside phase 25's measured
    ones; the card's memory beside HBM_PER_CHIP.  No gate: the plain route
    the dry run traces keeps score tensors the kernels do not."""
    from unittest import mock

    from repro_torch import configs
    from repro_torch.launch import dryrun, hlo_analysis, mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models.config import InputShape
    from repro_torch.optim import Optimizer

    box = {}
    counter, make = hlo_analysis.LocalCounter, dryrun.make_train_step
    apply = steps.apply_updates

    def kept_counter():
        box["counter"] = counter()
        return box["counter"]

    def measured_make(cfg, opt, **kwargs):
        def update(grads, state, params=None):
            # the update's own peak, from the bytes live as it starts
            c = box["counter"]
            box["before"], box["step_peak"] = c.live_bytes, c.peak_bytes
            c.peak_bytes = c.live_bytes
            return opt.update(grads, state, params)
        return make(cfg, Optimizer(opt.init, update), **kwargs)

    def apply_updates(params, updates):
        out = apply(params, updates)
        c = box["counter"]
        box["update_peak"] = c.peak_bytes
        c.peak_bytes = max(c.peak_bytes, box["step_peak"])
        return out

    b, s = TRAIN_ZAMBA_SHAPE
    cfg = configs.get_arch(ZAMBA)
    with mock.patch.object(hlo_analysis, "LocalCounter", kept_counter), \
            mock.patch.object(dryrun, "make_train_step", measured_make), \
            mock.patch.object(steps, "apply_updates", apply_updates):
        rec = dryrun.run_combo(
            ZAMBA, "phase25_step", ((1, 1), ("data", "model")), cfg=cfg,
            shape=InputShape("phase25_step", s, b, "train"), remat="none",
            microbatches=1, param_dtype=torch.float32)
    check(rec["status"] == "ok", f"dry run of phase 25's step: "
          f"{rec.get('error')}")
    param_bytes = 4 * cfg.num_params()
    peak = rec["memory"]["approx_live_bytes"]
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"trace_s": rec["trace_s"], "predicted_peak_bytes": peak,
           "predicted_peak_gib": peak / 2 ** 30,
           "predicted_update_peak_copies": box["update_peak"] / param_bytes,
           "predicted_update_rise_copies":
               (box["update_peak"] - box["before"]) / param_bytes,
           "measured_peak_gib": phase25["peak_gib"],
           "measured_update_peak_copies":
               phase25["update"]["peak_param_copies"],
           "param_bytes": param_bytes, "total_memory": total,
           "hbm_per_chip": mesh_lib.HBM_PER_CHIP,
           "roofline": rec["roofline"], "hlo": rec["hlo"]}
    log(f"  phase 25's step dry-run on a (1, 1) fake mesh (plain route) in "
        f"{rec['trace_s']} s: predicted peak {out['predicted_peak_gib']:.3f} "
        f"GiB, measured (phase 25, kernel route) {out['measured_peak_gib']:.3f}"
        f" GiB; the update's peak {out['predicted_update_peak_copies']:.2f} "
        f"param-sized copies predicted ({out['predicted_update_rise_copies']:.2f}"
        f" above what was live), {out['measured_update_peak_copies']:.2f} "
        f"measured; the card's total_memory {total} B beside HBM_PER_CHIP "
        f"{mesh_lib.HBM_PER_CHIP} B (datasheet)")
    return out


def launch_layer(torch, kernels, phase25, tmp):
    """Phase 26: (b)'s dry runs start first, in subprocesses, and run
    while (a) trains on the card and (c) traces in this process."""
    runs = start_dryruns(tmp)
    try:
        t0 = time.monotonic()
        out = {"train": launch_train_parity(torch, kernels)}
        out["train"]["seconds"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["memory_model"] = dryrun_train_step(torch, phase25)
        out["memory_model"]["seconds"] = time.monotonic() - t0
    except BaseException:
        for *_, proc, _ in runs:
            proc.kill()
            proc.communicate()
        raise
    t0 = time.monotonic()
    out["dryruns"] = finish_dryruns(runs)
    out["dryruns_wait_s"] = time.monotonic() - t0
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
    # the backward kernels, of the forwards the TPU kernels became
    kernels += [{"name": wrapper.name, "wrapper": wrapper,
                 "source": module.BWD_SOURCE, "replaces": module.REPLACES}
                for module, wrapper in (
                    (flash_module, flash_module.flash_attention_bwd),
                    (ssd_module, ssd_module.ssd_scan_bwd))]
    zamba = configs.get_arch(ZAMBA)

    phase("phase 1: build")
    t0 = time.monotonic()
    # Every nvcc starts here, together.  The backward kernels' libraries
    # (the flash backward's 18 entries and the SSD's 40, ~70 s together)
    # finish in a thread while phases 2-12, which launch none of them,
    # run; phase 13 waits for them.  The thread is not a daemon, so a run that fails earlier
    # still waits for its compilers before it exits.
    backward = {}

    def build_backward():
        try:
            backward["report"] = build.build([k["name"]
                                              for k in kernels[4:]])
        except BaseException as err:  # raised again before phase 13
            backward["error"] = err
    builder = threading.Thread(target=build_backward, name="nvcc-backward")
    builder.start()
    report = build.build([k["name"] for k in kernels[:4]])
    log(f"  built {len(report)} kernel libraries in "
        f"{time.monotonic() - t0:.2f} s (the 2 backward libraries build "
        f"beside phases 2-12)")
    for name, entry in report.items():
        usage = [line.strip() for line in entry["log"].splitlines()
                 if "registers" in line or "spill" in line]
        log(f"  {name}: nvcc {entry['seconds']:.2f} s; ptxas: "
            f"{'; '.join(sorted(set(usage)))}")
    flash_usage = ptxas_usage(report["flash_attention"]["log"])
    flash_hgmma = sass_counts(build.library_path("flash_attention"), "HGMMA")
    hgmma_text = ("not measured" if flash_hgmma is None
                  else json.dumps(flash_hgmma))
    log(f"  flash_attention entries (ptxas): {json.dumps(flash_usage)}; "
        f"HGMMA lines in SASS: {hgmma_text}")
    for d in flash_module.HEAD_DIMS:
        entry = flash_route_entry(flash_usage, "wgmma_tma_bf16", d)
        check(entry is not None and entry.get("spill_store_bytes") == 0
              and entry.get("spill_load_bytes") == 0,
              f"flash_attention's bf16 entry at d {d}: ptxas reports "
              f"{entry}, not an entry without spills")
        if flash_hgmma is not None:
            count = flash_route_entry(flash_hgmma, "wgmma_tma_bf16", d)
            check(bool(count), f"flash_attention's bf16 entry at d {d}: "
                  f"{count} HGMMA lines in its SASS")
    decode_usage = ptxas_usage(report["decode_attention"]["log"])
    log(f"  decode_attention entries (ptxas): {json.dumps(decode_usage)}")
    ssd_usage, ssd_hgmma = ssd_entries(report["ssd_scan"]["log"],
                                       build.library_path("ssd_scan"))
    log(f"  ssd_scan entries (ptxas; HGMMA lines in SASS): "
        f"{json.dumps(ssd_usage)}; {json.dumps(ssd_hgmma)}")
    check_ssd_entries(ssd_usage, ssd_hgmma, SSD_MAIN_ENTRIES["ssd_scan"],
                      "ssd_scan")

    phase("phase 2: kernels against their plain versions")
    decode = decode_module.decode_attention
    vtrace = vtrace_module.vtrace
    plan_splits = decode_module.plan_splits
    worst = check_decode_attention(decode, ref, torch, plan_splits,
                                   decode_module.HEAD_DIMS)
    mixed = check_decode_mixed(decode, ref, torch, plan_splits)
    t0 = time.monotonic()
    edges = check_decode_edges(decode, ref, torch, plan_splits)
    log(f"  check_decode_edges: {time.monotonic() - t0:.1f} s")
    worst = {name: max(worst[name], edges[name]) for name in worst}
    worst_vtrace = check_vtrace(vtrace, ref, torch)
    flash = flash_module.flash_attention
    ssd = ssd_module.ssd_scan
    worst_flash = check_flash(flash, ref, torch, zamba)
    worst_zoo = check_flash_zoo(flash, ref, torch,
                                np.random.RandomState(SEED + 21))
    t0 = time.monotonic()
    worst_zoo["bfloat16"] = max(worst_zoo["bfloat16"], check_flash_persistent(
        flash, ref, torch, np.random.RandomState(SEED + 29)))
    log(f"  check_flash_persistent: {time.monotonic() - t0:.1f} s")
    worst_flash = {name: max(worst_flash[name], worst_zoo[name])
                   for name in worst_flash}
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
    decode_serving = time_decode_serving(decode, ref, torch, plan_splits)
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
    flash_zoo = time_flash_zoo(flash, ref, torch, flash_usage, flash_hgmma)
    ssd_timed = time_ssd(ssd, ref, torch, zamba)
    log(f"  ssd_scan {json.dumps(ssd_timed)}")
    ssd_timed_train = time_ssd(ssd, ref, torch, zamba,
                               shape=TRAIN_ZAMBA_SHAPE, keep=True)
    log(f"  ssd_scan at the training shape, keeping its scratch "
        f"{json.dumps(ssd_timed_train)}")

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
    for key in ("params", "step", "outs", "batches"):
        del scoring[key]
    torch.cuda.empty_cache()

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

    phase("phase 13: gradients through flash attention and the SSD scan; "
          "the backward kernels")
    builder.join()
    if "error" in backward:
        raise backward["error"]
    report.update(backward["report"])
    bwd_usage, bwd_hgmma = {}, {}
    for name in ("flash_attention_bwd", "ssd_scan_bwd"):
        short = r"(?:flash_bwd_|ssd_bwd_|ssd_)[a-z]+_kernel(?:I\w+?EE)?"
        bwd_usage[name] = {
            re.search(short, entry).group(0): usage
            for entry, usage in ptxas_usage(report[name]["log"]).items()}
        counts = sass_counts(build.library_path(name), "HGMMA")
        bwd_hgmma[name] = None if counts is None else {
            re.search(short, entry).group(0): lines
            for entry, lines in counts.items() if re.search(short, entry)}
        log(f"  {name}: nvcc {report[name]['seconds']:.2f} s (beside phases "
            f"2-12); entries (ptxas; HGMMA lines in SASS): " + "; ".join(
                f"{entry} {usage.get('registers')} registers, "
                f"{usage.get('spill_store_bytes', 0)} B spilled, HGMMA "
                f"{'not measured' if bwd_hgmma[name] is None else bwd_hgmma[name].get(entry)}"
                for entry, usage in sorted(bwd_usage[name].items())))
    check_ssd_entries(bwd_usage["ssd_scan_bwd"], bwd_hgmma["ssd_scan_bwd"],
                      SSD_MAIN_ENTRIES["ssd_scan_bwd"], "ssd_scan_bwd")
    # every entry of the flash backward's main launch runs on wgmma
    main_entries = {entry: lines for entry, lines in
                    (bwd_hgmma["flash_attention_bwd"] or {}).items()
                    if "flash_bwd_dkdv" in entry}
    check(bwd_hgmma["flash_attention_bwd"] is None
          or (len(main_entries) == 8
              and all(lines > 0 for lines in main_entries.values())),
          f"flash_attention_bwd: entries without HGMMA: {main_entries}")
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
          f"async replicas, {FIG17_ACTORS} actor processes, "
          f"{FIG17_FAILOVER_STEPS} "
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

    phase(f"phase 23: the model zoo's scoring path — make_prefill_step at "
          f"full width and depth, {ZOO_BATCHES} batches of {ZOO_BATCH} "
          f"requests each, for "
          f"{', '.join(f'{name} ({dtype})' for name, dtype, _ in ZOO)}; "
          f"kernel vs plain route; reduced configs card vs CPU")
    zoo = zoo_scoring(torch, kernels)

    phase(f"phase 24: the model zoo's serving path — BatchedServer at full "
          f"width and depth, {SERVE_SLOTS} slots x {SERVE_PROMPT} prompt "
          f"tokens ({SERVE_STEPPED_PROMPT} a step a token) + {SERVE_DECODE} "
          f"decoded, for "
          f"{', '.join(f'{n} ({d} params, {c} cache)' for n, d, c, _ in SERVE_ZOO)}"
          f"; kernel vs plain route; the decode kernel at the serving "
          f"shapes; fig17's tier 1; reduced configs card vs CPU")
    t24 = time.monotonic()
    serving = zoo_serving(torch, kernels)
    serving["seconds"] = time.monotonic() - t24

    phase(f"phase 25: training — launch/train.py's main on {ZAMBA} at full "
          f"width and depth ({TRAIN_ZAMBA_STEPS} steps of "
          f"{TRAIN_ZAMBA_SHAPE[0]} x {TRAIN_ZAMBA_SHAPE[1]} tokens); "
          f"{TRAIN_DENSE}'s width at {TRAIN_DENSE_LAYERS} layers under full "
          f"remat and {TRAIN_DENSE_MICROBATCHES} microbatches; reduced "
          f"configs card vs CPU")
    t25 = time.monotonic()
    trained = training(torch, kernels)
    trained["seconds"] = time.monotonic() - t25
    phase("phase 26: the launch layer — make_host_mesh on the card and "
          "train.main under its rules bit-equal to the run without; the dry "
          "run of " + ", ".join(f"{a} x {sh}" for a, sh in LAUNCH_DRYRUNS)
          + " on 256 fake ranks in subprocesses; phase 25's step dry-run "
          "beside its measured memory")
    t26 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        launched = launch_layer(torch, kernels, trained["zamba2"], tmp)
    launched["seconds"] = time.monotonic() - t26
    log(f"  phase 26 took {launched['seconds']:.1f} s")
    train_launch_counts = {
        name: {"train_zamba2": trained["zamba2"]["launches"][name],
               "train_qwen3_width_first_step": trained["dense_width"][
                   "launches_first_step"][name],
               "train_reduced_card_vs_cpu": sum(
                   row["launches"][name] for row in trained["reduced"])}
        for name in ("flash_attention", "ssd_scan", "flash_attention_bwd",
                     "ssd_scan_bwd")}

    vtrace_main = vtrace_timed[VTRACE_TIMED[0]]
    kernel_lines = [{
        "name": "decode_attention", "route": "cuda",
        "source": kernels[0]["source"], "replaces": kernels[0]["replaces"],
        "launches": path["launches"]["decode_attention"],
        "max_abs_err": max(worst["float32"], timed["max_abs_err_timed"]),
        "max_abs_err_bf16": worst["bfloat16"],
        "max_abs_err_bf16_cache_f32_q": mixed["max_abs_err"],
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
                "launches"]["decode_attention"],
            **{f"zoo_serving_{row['config']}_{row['cache_dtype']}_cache":
               row["launches"]["decode_attention"]
               for row in serving["configs"]}},
        "serving_shapes": decode_serving,
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
        "max_abs_err": max([worst_flash["float32"],
                            flash_timed["max_abs_err_timed"]]
                           + [row["max_abs_err_timed"] for row in flash_zoo
                              if row["shape"]["dtype"] == "float32"]),
        "max_abs_err_bf16": max([worst_flash["bfloat16"]]
                                + [row["max_abs_err_timed"]
                                   for row in flash_zoo
                                   if row["shape"]["dtype"] == "bfloat16"]),
        "ms": flash_timed["ms"], "plain_ms": flash_timed["plain_ms"],
        "bound_ms": flash_timed["bound_ms"],
        "bound_by": flash_timed["bound_by"],
        "bound_tc_ms": flash_timed["bound_tc_ms"],
        "library_ms": flash_timed["library_ms"],
        "route": flash_module.route(torch.float32, zamba.head_dim),
        "routes": {row["path"]: row["route"] for row in flash_zoo},
        "build_seconds": report["flash_attention"]["seconds"],
        "ptxas": flash_usage,
        "hgmma_sass_lines": (flash_hgmma if flash_hgmma is not None
                             else "not measured"),
        "eager_ms": flash_timed["eager_ms"],
        "eager_plain_ms": flash_timed["eager_plain_ms"],
        "eager_library_ms": flash_timed["eager_library_ms"],
        "shape": flash_timed["shape"],
        "grad_path_launches": (
            grads["q_sequence"]["launches"]["flash_attention"]
            + grads["zamba2_reduced"]["launches"]["flash_attention"]),
        "launches_by_path": {
            "scoring": scoring["launches"]["flash_attention"],
            "serving": path["launches"]["flash_attention"],
            "transformer_policy_catch": policy["launches"][
                "flash_attention"],
            "fig17_server": fig17["server"]["launches"]["flash_attention"],
            "fig17_local": fig17["local"]["launches"]["flash_attention"],
            "fig17_async_failover": failover["fig17"]["with_failover"][
                "launches"]["flash_attention"],
            **{f"zoo_{row['config']}": row["launches"]["flash_attention"]
               for row in zoo["configs"]},
            **{f"zoo_serving_{row['config']}_{row['cache_dtype']}_cache":
               row["launches"]["flash_attention"]
               for row in serving["configs"]},
            **train_launch_counts["flash_attention"],
            "train_main_host_mesh": launched["train"]["launches"][
                "flash_attention"]},
        "backward_train_shape": trained["zamba2"]["flash_attention"],
        "zoo_shapes": flash_zoo,
        "policy_learner": dict(flash_policy, launches_per_learner_step=(
            policy["fig17_learner"]["flash_launches_per_learner_step"])),
        "policy_acting_prefill": {
            key: policy["fig17_learner"][key] for key in (
                "flash_launches_per_acting_prefill", "acting_prefill_ms",
                "acting_prefill_eager_ms", "acting_prefill_masked_ms",
                "acting_prefill_masked_eager_ms",
                "acting_prefill_max_abs_err")},
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
        "device_ms_by_kernel": ssd_timed["device_ms_by_kernel"],
        "training_shape_keeping_scratch": ssd_timed_train,
        "ptxas": ssd_usage, "hgmma_sass_lines": ssd_hgmma,
        "library_ms": None, "eager_ms": ssd_timed["eager_ms"],
        "eager_plain_ms": ssd_timed["eager_plain_ms"],
        "shape": ssd_timed["shape"],
        "grad_path_launches": grads["zamba2_reduced"]["launches"][
            "ssd_scan"],
        "launches_by_path": {
            "scoring": scoring["launches"]["ssd_scan"],
            **train_launch_counts["ssd_scan"],
            "train_main_host_mesh": launched["train"]["launches"][
                "ssd_scan"]},
        "backward_train_shape": trained["zamba2"]["ssd_scan"],
    }]
    flash_bwd_main = grads["flash_attention_bwd_timed"][0]
    ssd_bwd_main = grads["ssd_scan_bwd_timed"]
    for kernel, timed_shapes, worst_bwd, extra in (
            (kernels[4], grads["flash_attention_bwd_timed"],
             grads["flash_attention_bwd_worst"],
             {"library_bf16_ms": flash_bwd_main["library_bf16_ms"],
              "qwen3_1_7b_d128": grads["flash_attention_bwd_timed"][1:3],
              "whisper_encoder": grads["flash_attention_bwd_timed"][3],
              "differentiates": "src/repro/kernels/ref.py:10"}),
            (kernels[5], [ssd_bwd_main], grads["ssd_scan_bwd_worst"],
             {"differentiates": "src/repro/models/ssm.py:82"})):
        name = kernel["name"]
        main_shape = timed_shapes[0]
        # the sweep's worst error per dtype, with the timed shapes' folded in
        worst_bwd = {dtype: max([worst_bwd[dtype]] + [
            t["max_scaled_err_timed"] for t in timed_shapes
            if t["shape"]["dtype"] == dtype]) for dtype in worst_bwd}
        kernel_lines.append({
            "name": name, "route": "cuda", "source": kernel["source"],
            "replaces": kernel["replaces"],
            "launches": trained["zamba2"]["launches"][name],
            "max_abs_err": main_shape["max_abs_err_timed"],
            "max_scaled_err": worst_bwd["float32"],
            "max_scaled_err_bf16": worst_bwd["bfloat16"],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "bound_tc_ms": main_shape["bound_tc_ms"],
            "library_ms": main_shape["library_ms"],
            "eager_ms": main_shape["eager_ms"],
            "fwd_ms": main_shape["fwd_ms"],
            "recompute_ms": main_shape["recompute_ms"],
            "cuda_launches_per_call": main_shape["cuda_launches_per_call"],
            "device_ms_by_kernel": main_shape["device_ms_by_kernel"],
            "build_seconds": report[name]["seconds"],
            "ptxas": bwd_usage[name],
            "hgmma_sass_lines": bwd_hgmma[name],
            "shape": main_shape["shape"],
            "grad_path_launches": grads["zamba2_reduced"]["launches"][name]
            + grads["q_sequence"]["launches"][name],
            "launches_by_path": {
                **train_launch_counts[name],
                "train_main_host_mesh": launched["train"]["launches"][name],
                "transformer_policy_catch": policy["launches"][name]},
            **extra})
    log(f"  phase 21 {json.dumps(dist_dqn)}")
    log(f"  phase 22 {json.dumps(failover)}")
    log(f"  phase 23 {json.dumps(zoo)}")
    log(f"  phase 24 {json.dumps(serving)}")
    log(f"  phase 25 {json.dumps(trained)}")
    log(f"  phase 26 {json.dumps(launched)}")
    log(f"all phases passed in {time.monotonic() - start:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernel_lines, **floor}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
