"""Agent assembly: an ``AgentBuilder`` yields the single-process agent
(§2.2).

Builders implement the typed ``repro_torch.builders.AgentBuilder``
contract; the execution schedule comes from their frozen
``BuilderOptions``.  Only the single-process path with one replay table and
one learner is ported so far: sharded replay, learner replicas, async
learner sync, shard-affine routing and the distributed program come with
ROADMAP slice 7.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.builders import AgentBuilder
from repro_torch.core import Agent, VariableClient
from repro_torch.telemetry import registry as _telemetry


def _resolve(explicit, default):
    return default if explicit is None else explicit


def _register_replay_probe(table):
    """Export replay occupancy as snapshot-time gauges (no-op while
    telemetry is disabled): ``replay/size``."""
    _telemetry.probe("replay", lambda: {"size": table.size()})


def _not_ported(what: str):
    return NotImplementedError(
        f"make_agent: {what} is not ported yet (ROADMAP slice 7, "
        f"distributed execution and learner replicas)")


def make_agent(builder: AgentBuilder, seed: int = 0,
               num_replay_shards: Optional[int] = None,
               num_envs: Optional[int] = None,
               num_learner_replicas: Optional[int] = None,
               learner_average_period: Optional[int] = None,
               learner_sync: Optional[str] = None,
               replay_routing: Optional[str] = None,
               telemetry: Optional[bool] = None) -> Agent:
    """Synchronous single-process agent: actor and learner in lockstep.

    With ``num_envs > 1`` the actor is the builder's BATCHED actor fanning
    out to one adder per env — drive it with a ``VectorEnv`` +
    ``VectorizedEnvironmentLoop``.  More than one replay shard or learner
    replica, ``learner_sync="async"`` and ``replay_routing="affinity"``
    raise ``NotImplementedError``.  One explicit replica is the plain
    learner (the reference proves the two bit-identical), and
    ``learner_average_period`` (SGD steps between averaging rounds) is then
    ignored, as in the reference.
    """
    options = builder.options
    # (Re)configure the process registry BEFORE any component construction:
    # learners/tables register their metrics and probes in __init__.
    _telemetry.configure(enabled=_resolve(telemetry, options.telemetry),
                         node="local")
    if _resolve(num_replay_shards, options.num_replay_shards) > 1:
        raise _not_ported("sharded replay (num_replay_shards > 1)")
    if _resolve(num_learner_replicas, options.num_learner_replicas) > 1:
        raise _not_ported("learner replicas (num_learner_replicas > 1)")
    sync = _resolve(learner_sync, options.learner_sync)
    if sync not in ("barrier", "quorum", "async"):
        raise ValueError(f"learner_sync must be 'barrier', 'quorum' or "
                         f"'async', got {sync!r}")
    if sync == "async":
        raise _not_ported("learner_sync='async'")
    routing = _resolve(replay_routing, options.replay_routing)
    if routing not in ("round_robin", "hash", "affinity"):
        raise ValueError(f"replay_routing must be 'round_robin', 'hash' or "
                         f"'affinity', got {routing!r}")
    if routing == "affinity":
        raise _not_ported("replay_routing='affinity'")
    num_envs = _resolve(num_envs, options.num_envs_per_actor)

    table = builder.make_replay()
    _register_replay_probe(table)
    iterator = builder.make_dataset(table)
    learner = builder.make_learner(
        iterator, priority_update_cb=table.update_priorities)
    client = VariableClient(learner,
                            update_period=options.variable_update_period)
    policy = builder.make_policy(evaluation=False)
    if num_envs > 1:
        adders = [builder.make_adder(table) for _ in range(num_envs)]
        actor = builder.make_batched_actor(policy, client, adders, seed)
    else:
        actor = builder.make_actor(policy, client, builder.make_adder(table),
                                   seed)
    consuming = table.selector.consumes

    def can_step():
        # a step must not block on the dataset: no actor runs while the
        # learner steps, so a consuming queue short of a batch would hang.
        if table.rate_limiter.would_block_sample():
            return False
        return table.size() >= options.batch_size if consuming else True

    agent = Agent(actor, learner,
                  min_observations=options.min_observations,
                  observations_per_step=options.observations_per_step,
                  can_step=can_step)
    # The table is otherwise internal to assembly; run-wide checkpointing
    # reaches replay contents through the agent.
    agent.table = table
    return agent
