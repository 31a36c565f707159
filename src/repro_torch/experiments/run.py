"""Experiment entrypoints: one config, three execution modes.

``run_experiment`` takes an ``ExperimentConfig``, calls its builder
factory exactly once, and drives the builder through the single-process
agent (§2.2), with evaluation, run-wide checkpoints and exact resume on
their cadences.  The builder decides the device its learner and actors run
on (``device=`` of the port's builders).

``run_distributed_experiment`` drives the SAME builder through the
Launchpad-lite program graph (§2.4): actors in threads or spawned
processes, the learner, replay and inference services in this process on
the builder's device.  ``run_offline_experiment`` drives an offline
builder (a fixed dataset, no actors, §2.6).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.agents.builders import make_agent, make_distributed_agent
from repro_torch.core import (Counter, EnvironmentLoop, VariableClient,
                              make_environment_spec)
from repro_torch.experiments.config import ExperimentConfig, ExperimentResult
from repro_torch.telemetry import MetricsHub
from repro_torch.telemetry import registry as _telemetry

_EVAL_SEED_OFFSET = 1_000_003


def _evaluate(config: ExperimentConfig, builder, variable_source,
              episodes: Optional[int] = None, counter=None) -> float:
    """One eval pass: a greedy actor with no adder (§4.2's evaluator)."""
    episodes = config.eval_episodes if episodes is None else episodes
    if episodes <= 0:
        return float("nan")
    env = config.environment_factory(config.seed + _EVAL_SEED_OFFSET)
    client = VariableClient(variable_source)
    actor = builder.make_actor(builder.make_policy(evaluation=True),
                               client, adder=None,
                               seed=config.seed + _EVAL_SEED_OFFSET)
    loop = EnvironmentLoop(env, actor, counter=counter, label="evaluator")
    return float(np.mean([loop.run_episode()["episode_return"]
                          for _ in range(episodes)]))


def _make_checkpointer(config: ExperimentConfig):
    if not config.checkpoint_dir:
        return None
    from repro_torch.checkpoint import Checkpointer
    return Checkpointer(config.checkpoint_dir)


def _make_run_checkpointer(config: ExperimentConfig):
    """Run-wide checkpointer (learner + replay + counters + run state) for
    the online entrypoints; offline runs keep the plain learner-only
    ``Checkpointer`` (no replay or actors exist there)."""
    if not config.checkpoint_dir:
        return None
    from repro_torch.resilience import RunCheckpointer
    return RunCheckpointer(config.checkpoint_dir)


def run_experiment(config: ExperimentConfig,
                   num_episodes: Optional[int] = None) -> ExperimentResult:
    """Single-process run: the env loop drives an Agent built from the
    config's builder; eval and checkpointing happen on their cadences.

    With ``num_envs_per_actor > 1`` the train loop is a
    ``VectorizedEnvironmentLoop`` over a ``VectorEnv`` — N auto-resetting
    envs, one batched policy call per tick — run in chunks of whole
    episodes so the eval/checkpoint cadences keep their per-episode meaning.
    The learner's step counter is read on the host (a device read on a
    card) only at episode boundaries, for the checkpoint cadence, and once
    at the end.
    """
    env = config.environment_factory(config.seed)
    spec = make_environment_spec(env)
    builder = config.builder_factory(spec)
    num_envs = (config.num_envs_per_actor
                if config.num_envs_per_actor is not None
                else builder.options.num_envs_per_actor)
    agent = make_agent(builder, seed=config.seed,
                       num_replay_shards=config.num_replay_shards,
                       num_envs=num_envs,
                       num_learner_replicas=config.num_learner_replicas,
                       learner_average_period=config.learner_average_period,
                       learner_sync=config.learner_sync,
                       replay_routing=config.replay_routing,
                       telemetry=config.telemetry)
    # Single-process telemetry: no pusher thread needed — the whole run
    # lives in this process, so one final push at the end captures it all.
    telemetry_hub = (MetricsHub(jsonl_path=config.telemetry_jsonl)
                     if _telemetry.enabled() else None)
    counter = Counter()
    logger = (config.logger_factory("train")
              if config.logger_factory else None)
    if num_envs > 1:
        from repro_torch.core import VectorizedEnvironmentLoop
        from repro_torch.envs.vector import VectorEnv
        vector_env = VectorEnv(config.environment_factory, num_envs,
                               seed=config.seed)
        loop = VectorizedEnvironmentLoop(vector_env, agent, counter=counter,
                                         logger=logger, label="actor")
    else:
        loop = EnvironmentLoop(env, agent, counter=counter, logger=logger,
                               label="actor")
    checkpointer = _make_run_checkpointer(config)
    last_ckpt_step: Optional[int] = None

    episodes = config.num_episodes if num_episodes is None else num_episodes
    returns, steps, wall, evals = [], [], [], []
    total_steps = 0
    episodes_done = 0
    next_eval = config.eval_every or 0
    t0 = time.time()

    def _run_state():
        # Everything outside learner/replay/counter that exact resume
        # needs, captured at an episode boundary (adder buffers flushed,
        # recurrent actor state about to reinitialize at observe_first).
        state = {"agent": agent.state_dict(),
                 "bookkeeping": {
                     "returns": list(returns), "steps": list(steps),
                     "wall": list(wall), "evals": list(evals),
                     "total_steps": total_steps,
                     "episodes_done": episodes_done,
                     "next_eval": next_eval,
                     "elapsed": time.time() - t0}}
        if hasattr(loop, "state_dict"):
            state["loop"] = loop.state_dict()
        if num_envs == 1 and hasattr(env, "get_state"):
            state["env"] = env.get_state()
        return state

    def _save_run(at_step):
        checkpointer.save(at_step, agent.learner.state,
                          replay=agent.table.state_dict(),
                          counts=counter.get_counts(),
                          run_state=_run_state(),
                          meta={"mode": "single_process"})

    if config.resume and checkpointer is not None:
        snapshot = checkpointer.restore(agent.learner.state)
        if snapshot is not None:
            agent.learner.state = snapshot.learner_state
            if snapshot.replay is not None:
                agent.table.load_state_dict(snapshot.replay)
            if snapshot.counts is not None:
                counter.set_counts(snapshot.counts)
            rs = snapshot.run_state or {}
            if "agent" in rs:
                agent.load_state_dict(rs["agent"])
            if "loop" in rs and hasattr(loop, "load_state_dict"):
                loop.load_state_dict(rs["loop"])
            if rs.get("env") is not None and hasattr(env, "set_state"):
                env.set_state(rs["env"])
            book = rs.get("bookkeeping", {})
            returns[:] = book.get("returns", [])
            steps[:] = book.get("steps", [])
            wall[:] = book.get("wall", [])
            evals[:] = book.get("evals", [])
            total_steps = int(book.get("total_steps", 0))
            episodes_done = int(book.get("episodes_done", 0))
            next_eval = book.get("next_eval", next_eval)
            t0 = time.time() - float(book.get("elapsed", 0.0))
            last_ckpt_step = snapshot.step

    while episodes_done < episodes:
        if num_envs > 1:
            # chunk = one eval period (or everything left): the vectorized
            # loop returns one result per COMPLETED episode.  The step cap
            # bounds the chunk too — don't overrun max_actor_steps by a
            # whole chunk of episodes.
            chunk = min(config.eval_every or episodes - episodes_done,
                        episodes - episodes_done)
            remaining_steps = (None if config.max_actor_steps is None
                               else max(config.max_actor_steps - total_steps,
                                        1))
            chunk_results = loop.run(num_episodes=chunk,
                                     num_steps=remaining_steps)
        else:
            chunk_results = [loop.run_episode()]
        for result in chunk_results:
            total_steps += result["episode_length"]
            returns.append(result["episode_return"])
            steps.append(total_steps)
            wall.append(time.time() - t0)
        episodes_done += len(chunk_results)
        if config.eval_every and config.eval_episodes > 0 \
                and episodes_done >= next_eval:
            next_eval += config.eval_every
            evals.append((total_steps,
                          _evaluate(config, builder, agent.learner,
                                    counter=counter)))
        if checkpointer and config.checkpoint_every:
            learner_steps = int(agent.learner.state.steps)
            if learner_steps - (last_ckpt_step or 0) >= config.checkpoint_every:
                _save_run(learner_steps)
                last_ckpt_step = learner_steps
        if (config.max_actor_steps is not None
                and total_steps >= config.max_actor_steps):
            break

    # final eval — unless disabled, or a periodic eval already ran at
    # exactly this point
    if config.eval_episodes > 0 and (not evals or evals[-1][0] != total_steps):
        evals.append((total_steps,
                      _evaluate(config, builder, agent.learner,
                                counter=counter)))
    learner_steps = int(agent.learner.state.steps)
    if checkpointer and learner_steps != last_ckpt_step:
        # Deduped against the cadence checkpoint: when the last periodic
        # save already captured exactly this learner step, the final save
        # would be byte-for-byte redundant — skip it.
        _save_run(learner_steps)
    extras = {}
    learner_stats = getattr(agent.learner, "stats", None)
    if callable(learner_stats):   # MultiLearner: per-replica steps + rounds
        extras["learners"] = learner_stats()
    if telemetry_hub is not None:
        telemetry_hub.push(_telemetry.node_name(), _telemetry.snapshot())
        telemetry_hub.stop()
        extras["telemetry"] = telemetry_hub.snapshot()
    return ExperimentResult(
        train_returns=returns, actor_steps=steps, walltime=wall,
        eval_returns=evals, counts=counter.get_counts(),
        learner_steps=learner_steps, learner=agent.learner, builder=builder,
        extras=extras)


def run_distributed_experiment(config: ExperimentConfig, num_actors: int,
                               max_actor_steps: Optional[int] = None,
                               timeout_s: float = 300.0,
                               with_evaluator: bool = False,
                               poll_s: float = 0.2) -> ExperimentResult:
    """Distributed run: the SAME builder, unchanged, on the Launchpad-lite
    graph (Fig 4) — N actor nodes + learner + rate-limited replay.  The
    execution backend comes from ``config.launcher`` (``"local"`` threads or
    ``"multiprocess"`` OS processes with courier RPC edges); multiprocess
    runs need module-level factories in the config, since spawned children
    rebuild the builder and environments from their pickles.  The learner
    and the services run on the builder's device; the learner's step
    counter is read on the host every ``poll_s`` only when checkpointing on
    a cadence.  ``config.rpc_retry`` tunes courier retries in every
    worker."""
    if num_actors < 1:
        raise ValueError(f"num_actors must be >= 1, got {num_actors}")
    spec = make_environment_spec(config.environment_factory(config.seed))
    builder = config.builder_factory(spec)
    target = (config.max_actor_steps if max_actor_steps is None
              else max_actor_steps)
    checkpointer = _make_run_checkpointer(config)

    restore = None
    if config.resume and checkpointer is not None:
        def restore(learner, table, counter):
            # Called by the assembly layer once the services exist but
            # before any worker launches: the restored learner/replay/
            # counter state is the first state anything observes.  Workers
            # then re-interleave asynchronously — same state, not the same
            # schedule.
            snapshot = checkpointer.restore(learner.state)
            if snapshot is None:
                return
            learner.state = snapshot.learner_state
            if snapshot.replay is not None:
                table.load_state_dict(snapshot.replay)
            if snapshot.counts is not None:
                counter.set_counts(snapshot.counts)

    dist = make_distributed_agent(builder, config.environment_factory,
                                  num_actors=num_actors, seed=config.seed,
                                  with_evaluator=with_evaluator,
                                  num_replay_shards=config.num_replay_shards,
                                  prefetch_size=config.prefetch_size,
                                  launcher=config.launcher,
                                  builder_factory=config.builder_factory,
                                  spec=spec,
                                  num_envs_per_actor=config.num_envs_per_actor,
                                  inference=config.inference,
                                  inference_max_batch_size=(
                                      config.inference_max_batch_size),
                                  inference_max_wait_ms=(
                                      config.inference_max_wait_ms),
                                  num_learner_replicas=(
                                      config.num_learner_replicas),
                                  learner_average_period=(
                                      config.learner_average_period),
                                  telemetry=config.telemetry,
                                  telemetry_push_period_s=(
                                      config.telemetry_push_period_s),
                                  telemetry_jsonl=config.telemetry_jsonl,
                                  restart_policy=config.restart_policy,
                                  chaos=config.chaos,
                                  rpc_retry=config.rpc_retry,
                                  barrier_timeout_s=config.barrier_timeout_s,
                                  min_quorum=config.min_quorum,
                                  learner_sync=config.learner_sync,
                                  replay_routing=config.replay_routing,
                                  restore=restore)
    last_ckpt_step: Optional[int] = None

    def _save_run(at_step, counts):
        # Services (learner, replay, counter) are parent-resident under
        # both backends, so the parent can snapshot them directly; workers
        # hold no durable state (their experience is already in replay).
        checkpointer.save(at_step, dist.learner.state,
                          replay=dist.table.state_dict(),
                          counts=counts,
                          meta={"mode": "distributed",
                                "launcher": config.launcher})

    t0 = time.time()
    try:
        while time.time() - t0 < timeout_s:
            counts = dist.counter.get_counts()
            if target is not None and counts.get("actor_steps", 0) >= target:
                break
            if checkpointer and config.checkpoint_every:
                learner_steps = int(dist.learner.state.steps)
                if learner_steps - (last_ckpt_step or 0) \
                        >= config.checkpoint_every:
                    _save_run(learner_steps, counts)
                    last_ckpt_step = learner_steps
            time.sleep(poll_s)
        counts = dist.counter.get_counts()
        rl = dist.table.rate_limiter
        extras = {
            "num_actors": num_actors,
            "launcher": config.launcher,
            "inserts": rl.inserts,
            "samples": rl.samples,
            "min_size_to_sample": rl.min_size_to_sample,
            "spi_effective": rl.samples / max(
                rl.inserts - rl.min_size_to_sample, 1),
            "walltime": time.time() - t0,
        }
        if hasattr(dist.table, "stats"):   # ShardedReplay: per-shard view
            extras["replay"] = dist.table.stats()
        if dist.inference_server is not None:
            extras["inference"] = dist.inference_server.stats()
        learner_stats = dist.learner_stats()
        if learner_stats is not None:   # multi-learner: replica steps/rounds
            extras["learners"] = learner_stats
        restart_stats = getattr(dist.launcher, "restart_stats", None)
        if callable(restart_stats):   # elastic supervisor bookkeeping
            extras["resilience"] = restart_stats()
        if with_evaluator:
            extras["evaluator_returns"] = dist.evaluator_returns()
    finally:
        dist.stop()
    # After stop(): worker processes pushed their final snapshots during
    # teardown and the parent pusher flushed post-join, so the merged view
    # covers every node's end-of-run state.
    telemetry_snapshot = dist.telemetry_snapshot()
    if telemetry_snapshot is not None:
        extras["telemetry"] = telemetry_snapshot

    total_steps = int(counts.get("actor_steps", 0))
    evals = ([(total_steps, _evaluate(config, builder, dist.learner))]
             if config.eval_episodes > 0 else [])
    learner_steps = int(dist.learner.state.steps)
    if checkpointer and learner_steps != last_ckpt_step:
        _save_run(learner_steps, counts)
    return ExperimentResult(
        train_returns=[], actor_steps=[total_steps], walltime=[extras["walltime"]],
        eval_returns=evals, counts=counts, learner_steps=learner_steps,
        learner=dist.learner, builder=builder, extras=extras)


def run_offline_experiment(config: ExperimentConfig,
                           num_learner_steps: int = 1000) -> ExperimentResult:
    """Offline run (§2.6): no actors — step the learner over the builder's
    fixed dataset, then evaluate the resulting policy.  The learner's step
    counter is read on the host once, at the end."""
    spec = make_environment_spec(config.environment_factory(config.seed))
    builder = config.builder_factory(spec)
    if not builder.options.offline:
        raise ValueError(
            f"{type(builder).__name__} is not an offline builder "
            f"(options.offline is False)")
    table = builder.make_replay()
    iterator = builder.make_dataset(table)
    learner = builder.make_learner(
        iterator, priority_update_cb=table.update_priorities)
    logger = (config.logger_factory("learner")
              if config.logger_factory else None)
    checkpointer = _make_checkpointer(config)
    evals = []
    t0 = time.time()
    for step in range(num_learner_steps):
        metrics = learner.step()
        if logger:
            logger(metrics)
        if config.eval_every and config.eval_episodes > 0 \
                and (step + 1) % config.eval_every == 0:
            evals.append((step + 1, _evaluate(config, builder, learner)))
    if config.eval_episodes > 0 and (not evals
                                     or evals[-1][0] != num_learner_steps):
        evals.append((num_learner_steps, _evaluate(config, builder, learner)))
    learner_steps = int(learner.state.steps)
    if checkpointer:
        checkpointer.save(learner.state, learner_steps)
    return ExperimentResult(
        train_returns=[], actor_steps=[], walltime=[time.time() - t0],
        eval_returns=evals, counts={}, learner_steps=learner_steps,
        learner=learner, builder=builder,
        extras={"dataset_size": table.size()})
