"""Agent assembly: the same ``AgentBuilder`` yields the single-process agent
(§2.2) and the distributed program (§2.4) — Acme's central design claim.

Builders implement the typed ``repro_torch.builders.AgentBuilder``
contract; the execution schedule comes from their frozen
``BuilderOptions`` (no duck-typed attribute probing).
``make_distributed_agent`` emits a backend-agnostic ``Program``: replay
shards, the counter, the learner (or its replicas and their parameter
server) and the inference server are *service* nodes (courier-servable,
resident in the launching process, on the builder's device), actors and
the evaluator are *worker* nodes — so the graph runs unchanged on the
``local`` (threads) or ``multiprocess`` (one OS process per worker, RPC
edges) launcher backend.  What crosses an RPC edge is numpy: variables,
replay items, priorities, inference requests and actions, and telemetry
snapshots.  These assembly functions are the low-level layer;
``repro_torch.experiments`` wraps them in the config-driven run API.

``learner_sync="async"`` and ``replay_routing="affinity"`` raise
``NotImplementedError`` until ROADMAP slice 7b ports them, with service
failover and chaos injection.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.builders import AgentBuilder
from repro_torch.core import (Agent, Counter, EnvironmentLoop,
                              INFERENCE_INTERFACE, InferenceServer,
                              VariableClient, VectorizedEnvironmentLoop)
from repro_torch.core.inference import policy_is_feed_forward
from repro_torch.distributed.launchers import JoinTimeout, get_launcher
from repro_torch.distributed.program import Program, Replica
from repro_torch.envs.vector import VectorEnv
from repro_torch.learners import (PARAM_SERVER_INTERFACE,
                                  LearnerReplicaWorker, MultiLearner,
                                  ParameterServer)
from repro_torch.replay import (PrefetchingDataset, ShardedReplay,
                                make_replay_shards)
from repro_torch.replay.service import REPLAY_INTERFACE
from repro_torch.telemetry import (HUB_INTERFACE, MetricsHub, MetricsPusher,
                                   WorkerTelemetry)
from repro_torch.telemetry import registry as _telemetry


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP slice 7b: service failover, "
        f"chaos, async learner sync and shard-affine routing)")


def _resolve(explicit, default):
    return default if explicit is None else explicit


def _register_replay_probe(table):
    """Export replay occupancy as snapshot-time gauges (no-op while
    telemetry is disabled): ``replay/size``, ``replay/inserts``, … plus
    ``replay/shard_i/<stat>`` per shard when the table is a
    ``ShardedReplay`` (its ``stats()`` carries a ``per_shard`` list)."""
    stats_fn = getattr(table, "stats", None)
    if callable(stats_fn):
        def probe_fn():
            out = {}
            for k, v in stats_fn().items():
                if k == "per_shard":
                    for i, shard_stats in enumerate(v):
                        for sk, sv in shard_stats.items():
                            if sk != "name":
                                out[f"shard_{i}/{sk}"] = sv
                else:
                    out[k] = v
            return out
    else:
        def probe_fn():
            return {"size": table.size()}
    _telemetry.probe("replay", probe_fn)


def _effective_shards(options, num_replay_shards):
    """Offline builders preload their fixed dataset in make_replay —
    sharding would duplicate it per shard (and there is no insert
    throughput to scale), so they always keep a single table."""
    if options.offline:
        return 1
    return _resolve(num_replay_shards, options.num_replay_shards)


def _effective_replicas(options, num_learner_replicas):
    """(num_replicas, engaged): multi-learner machinery is engaged when the
    caller asked for it explicitly — even num_learner_replicas=1, which the
    parity net proves equivalent to the plain path — or the builder's
    options default to more than one replica.  Offline builders keep the
    plain learner (their fixed dataset has no shards to give replicas
    affinity over); explicitly asking them for replicas is a config-time
    error, not a silent downgrade."""
    if options.offline:
        if num_learner_replicas is not None and num_learner_replicas > 1:
            raise ValueError(
                f"offline builders cannot run num_learner_replicas="
                f"{num_learner_replicas}: the fixed dataset has no replay "
                f"shards to give replicas affinity over")
        return 1, False
    replicas = _resolve(num_learner_replicas, options.num_learner_replicas)
    engaged = (num_learner_replicas is not None
               or options.num_learner_replicas > 1)
    return replicas, engaged


def _effective_sync(options, learner_sync):
    """Resolved learner sync mode; ``"async"`` rejects offline builders for
    the same reason explicit replicas do (no shards, no replica streams),
    and is not ported yet."""
    sync = _resolve(learner_sync, options.learner_sync)
    if sync not in ("barrier", "quorum", "async"):
        raise ValueError(f"learner_sync must be 'barrier', 'quorum' or "
                         f"'async', got {sync!r}")
    if sync == "async" and options.offline:
        raise ValueError(
            "offline builders cannot run learner_sync='async': the fixed "
            "dataset has no replay shards to give replicas affinity over")
    if sync == "async":
        raise _not_ported("learner_sync='async'")
    return sync


def _effective_routing(options, replay_routing):
    routing = _resolve(replay_routing, options.replay_routing)
    if routing not in ("round_robin", "hash", "affinity"):
        raise ValueError(f"replay_routing must be 'round_robin', 'hash' or "
                         f"'affinity', got {routing!r}")
    if routing == "affinity":
        raise _not_ported("replay_routing='affinity'")
    return routing


def _replica_sharding(options, num_replay_shards, num_replicas):
    """Shard count for a multi-learner run: replica i consumes shard i
    exclusively (shard affinity), so the counts must match — an unset/1
    shard count follows the replica count."""
    shards = _effective_shards(options, num_replay_shards)
    if num_replicas <= 1:
        return shards
    if shards == 1:
        return num_replicas
    if shards != num_replicas:
        raise ValueError(
            f"num_learner_replicas={num_replicas} needs one replay shard "
            f"per replica (shard affinity), got num_replay_shards={shards}; "
            f"leave num_replay_shards unset or make the counts equal")
    return shards


def _make_replica_learners(builder, table, num_replicas, prefetch=0):
    """One learner per replay shard, each consuming only its own shard's
    dataset (local shard keys, so priority updates route shard-directly)
    — optionally through a per-replica ``PrefetchingDataset``.  Returns
    (learners, datasets, shards); datasets[i] is None unless prefetching.
    """
    if num_replicas > 1:
        if not isinstance(table, ShardedReplay) \
                or table.num_shards != num_replicas:
            raise ValueError(
                f"{num_replicas} learner replicas need a ShardedReplay "
                f"with exactly {num_replicas} shards, got {table!r}")
        shards = list(table.shards)
    else:
        shards = [table]
    learners, datasets = [], []
    for shard in shards:
        iterator = builder.make_dataset(shard)
        dataset = None
        if prefetch > 0:
            dataset = PrefetchingDataset.over_iterator(
                iterator, prefetch_size=prefetch)
            iterator = dataset
        learners.append(builder.make_learner(
            iterator, priority_update_cb=shard.update_priorities))
        datasets.append(dataset)
    return learners, datasets, shards


def make_agent(builder: AgentBuilder, seed: int = 0,
               num_replay_shards: Optional[int] = None,
               num_envs: Optional[int] = None,
               num_learner_replicas: Optional[int] = None,
               learner_average_period: Optional[int] = None,
               learner_sync: Optional[str] = None,
               replay_routing: Optional[str] = None,
               telemetry: Optional[bool] = None) -> Agent:
    """Synchronous single-process agent: actor and learner in lockstep.

    Sharded replay is honoured here too; prefetching is not — the lockstep
    schedule relies on sampling (and its rate-limiter accounting) happening
    synchronously inside the learner step.  With ``num_envs > 1`` the actor
    is the builder's BATCHED actor fanning out to one adder per env — drive
    it with a ``VectorEnv`` + ``VectorizedEnvironmentLoop``.

    ``num_learner_replicas`` routes learning through a ``MultiLearner``:
    one replica per replay shard, stepped sequentially round-robin by the
    agent's schedule, with parameter averaging every
    ``learner_average_period`` per-replica steps.  A sequential schedule
    has no stragglers, so ``"quorum"`` degenerates to ``"barrier"`` here.
    ``learner_sync="async"`` and ``replay_routing="affinity"`` raise
    ``NotImplementedError`` (ROADMAP slice 7b).
    """
    options = builder.options
    # (Re)configure the process registry BEFORE any component construction:
    # learners/engines/tables register their metrics and probes in __init__.
    _telemetry.configure(enabled=_resolve(telemetry, options.telemetry),
                         node="local")
    _effective_sync(options, learner_sync)
    routing = _effective_routing(options, replay_routing)
    replicas, multi = _effective_replicas(options, num_learner_replicas)
    period = _resolve(learner_average_period,
                      options.learner_average_period)
    num_shards = (_replica_sharding(options, num_replay_shards, replicas)
                  if multi else _effective_shards(options, num_replay_shards))
    num_envs = _resolve(num_envs, options.num_envs_per_actor)
    table = make_replay_shards(builder.make_replay, num_shards,
                               routing=routing)
    _register_replay_probe(table)
    shard_tables = None
    if multi:
        replica_learners, _, shard_tables = _make_replica_learners(
            builder, table, replicas)
        learner = MultiLearner(replica_learners, average_period=period)
    else:
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

    if multi and replicas > 1:
        def can_step():
            # a sequential multi-learner step samples ONE shard — the
            # round-robin cursor's — so gate on that shard: the aggregate
            # view can satisfy batch_size while the cursor's shard cannot
            # serve a batch, which would hang the lockstep loop inside a
            # blocking sample (no actor runs while the learner steps).
            shard = shard_tables[learner.next_replica]
            if shard.rate_limiter.would_block_sample():
                return False
            return shard.size() >= options.batch_size if consuming else True
    else:
        def can_step():
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


class _DeferredBuilder:
    """Picklable stand-in for an AgentBuilder: ships ``(factory, spec)``
    across a process boundary and rebuilds the builder child-side (builder
    instances may hold unpicklable state; their factories must not)."""

    def __init__(self, factory, spec):
        self.factory = factory
        self.spec = spec

    def build(self) -> AgentBuilder:
        return self.factory(self.spec)


def _builder_of(builder):
    return builder.build() if isinstance(builder, _DeferredBuilder) \
        else builder


class _LearnerWorker(LearnerReplicaWorker):
    """Single-learner node: a service/worker hybrid — steps SGD until
    stopped (the rate limiter blocks us when we get ahead of the actors,
    §2.5) and serves ``get_variables`` to the actor pool (over courier when
    actors live in other processes).  The degenerate one-replica,
    no-rendezvous case of ``LearnerReplicaWorker`` — one run loop, one set
    of stop/exception semantics."""

    def __init__(self, learner, max_steps: Optional[int] = None):
        super().__init__(learner, param_server=None, max_steps=max_steps)


class _ResilientActor:
    """Graceful degradation during a service's restart window.

    The OUTERMOST actor wrapper in workers running under a
    ``RestartPolicy``: an add that hits an unreachable replay service is
    skipped (the transition is lost, counted in
    ``resilience/skipped_adds``) and a weight sync that cannot reach the
    learner keeps acting on the ``VariableClient``'s cached params
    (``resilience/skipped_updates``) — instead of the ``ConnectionError``
    killing the worker and burning a restart budget that belongs to real
    failures.  Catches ``ConnectionError`` so both transport-level
    unavailability (``ServiceUnavailable`` after the reconnect deadline)
    and the application-level down-marker a killed service raises are
    absorbed uniformly.  ``select_action`` is NOT wrapped: with no action
    there is no step to degrade to.
    """

    def __init__(self, actor):
        self._actor = actor
        self._m_adds = None
        self._m_updates = None

    def _skip(self, attr, name):
        metric = getattr(self, attr)
        if metric is None:
            if not _telemetry.enabled():
                return
            metric = _telemetry.counter(name)
            setattr(self, attr, metric)
        metric.inc()

    def observe_first(self, *args, **kwargs):
        try:
            return self._actor.observe_first(*args, **kwargs)
        except ConnectionError:
            self._skip("_m_adds", "resilience/skipped_adds")

    def observe(self, *args, **kwargs):
        try:
            return self._actor.observe(*args, **kwargs)
        except ConnectionError:
            self._skip("_m_adds", "resilience/skipped_adds")

    def update(self, *args, **kwargs):
        try:
            return self._actor.update(*args, **kwargs)
        except ConnectionError:
            self._skip("_m_updates", "resilience/skipped_updates")

    def __getattr__(self, name):
        return getattr(self._actor, name)


class _ActorWorker:
    """Actor node: its own environment instance(s) + loop (Fig 4).  Every
    collaborator arrives as a handle (in-memory or courier RemoteHandle) —
    this class cannot tell which backend it runs under.

    ``num_envs > 1`` turns the node into a vectorized acting worker: a
    ``VectorEnv`` of N auto-resetting envs driven by the builder's batched
    actor (one policy call per N transitions), each env writing through its
    own adder.  ``inference`` (a handle to an inference server) switches
    policy evaluation to SEED-style RPC — the worker then holds no weights,
    never polls the learner and never touches a device.  Otherwise the
    worker's policy runs on the builder's device.
    """

    def __init__(self, env_factory, builder, variable_source, counter,
                 table, seed: int, max_episodes: Optional[int] = None,
                 num_envs: int = 1, inference=None, telemetry=None,
                 rpc_retry=None, resilient: bool = False):
        # FIRST: in a spawn child this configures the process registry, so
        # everything constructed below (actors, engines, courier clients)
        # records into it.  Under the local launcher the parent already
        # configured this process and install() is a no-op.
        self._telemetry_pusher = (telemetry.install()
                                  if telemetry is not None else None)
        if rpc_retry is not None:
            # Process-global: every courier client in this worker retries
            # under the run's RetryConfig.
            from repro_torch.distributed import courier
            courier.set_retry_config(rpc_retry)
        builder = _builder_of(builder)
        options = builder.options
        num_envs = max(int(num_envs), 1)

        if inference is not None:
            if num_envs > 1:
                adders = [builder.make_adder(table) for _ in range(num_envs)]
                actor = builder.make_inference_actor(inference, adders=adders)
            else:
                actor = builder.make_inference_actor(
                    inference, adder=builder.make_adder(table))
        else:
            client = VariableClient(variable_source, update_period=1)
            policy = builder.make_policy(evaluation=False)
            if num_envs > 1:
                adders = [builder.make_adder(table) for _ in range(num_envs)]
                actor = builder.make_batched_actor(policy, client, adders,
                                                   seed)
            else:
                actor = builder.make_actor(
                    policy, client, builder.make_adder(table), seed)
        if resilient:
            actor = _ResilientActor(actor)
        # weight-sync cadence lives in the LOOP (update_period in env steps /
        # ticks); the client fetches on every poke it does receive.  A tick
        # of the vectorized loop covers num_envs transitions, so the tick
        # period shrinks accordingly.
        update_period = max(options.variable_update_period // num_envs, 1)
        if num_envs > 1:
            self.env = VectorEnv(env_factory, num_envs, seed=seed)
            self.loop = VectorizedEnvironmentLoop(
                self.env, actor, counter=counter, label="actor",
                update_period=update_period)
        else:
            self.env = env_factory(seed)
            self.loop = EnvironmentLoop(self.env, actor, counter=counter,
                                        label="actor",
                                        update_period=update_period)
        self.max_episodes = max_episodes
        self._stop = threading.Event()

    def run(self):
        try:
            self.loop.run(num_episodes=self.max_episodes,
                          should_stop=self._stop.is_set)
        finally:
            if self._telemetry_pusher is not None:
                self._telemetry_pusher.stop()   # final push to the hub

    def stop(self):
        self._stop.set()


class ReturnsLog:
    """Append-only episode-return log a remote evaluator reports into (the
    parent cannot reach into a child process to read a plain list)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List[float] = []

    def append(self, value: float):
        with self._lock:
            self._items.append(float(value))

    def items(self) -> List[float]:
        with self._lock:
            return list(self._items)


class _EvaluatorWorker:
    """Background evaluator (§4.2): an actor with NO adder that periodically
    pulls weights and logs episode returns against learner steps."""

    def __init__(self, env_factory, builder, variable_source, counter,
                 seed: int, returns_log=None, period_s: float = 1.0,
                 telemetry=None):
        self._telemetry_pusher = (telemetry.install()
                                  if telemetry is not None else None)
        builder = _builder_of(builder)
        self.env = env_factory(seed)
        client = VariableClient(variable_source, update_period=1)
        actor = builder.make_actor(builder.make_policy(evaluation=True),
                                   client, adder=None, seed=seed)
        self.loop = EnvironmentLoop(self.env, actor, counter=counter,
                                    label="evaluator", should_update=True)
        self.period_s = period_s
        self.returns: List[float] = []
        self._log = returns_log
        self._stop = threading.Event()

    def run(self):
        try:
            while not self._stop.is_set():
                result = self.loop.run_episode()
                self.returns.append(result["episode_return"])
                if self._log is not None:
                    self._log.append(result["episode_return"])
                self._stop.wait(self.period_s)
        finally:
            if self._telemetry_pusher is not None:
                self._telemetry_pusher.stop()   # final push to the hub

    def stop(self):
        self._stop.set()


class DistributedAgent:
    """Handle onto a launched distributed program."""

    def __init__(self, program, launcher, learner, table, counter,
                 datasets=(), eval_log=None, inference_server=None,
                 telemetry_hub=None, telemetry_pusher=None):
        self.program = program
        self.launcher = launcher
        self.learner = learner
        self.table = table
        self.counter = counter
        self.datasets = [d for d in datasets if d is not None]
        self.eval_log = eval_log
        self.inference_server = inference_server
        self.telemetry_hub = telemetry_hub
        self._telemetry_pusher = telemetry_pusher

    def evaluator_returns(self) -> List[float]:
        """Episode returns reported by the evaluator node (works for both
        backends; the evaluator may live in another process)."""
        return self.eval_log.items() if self.eval_log is not None else []

    def learner_stats(self) -> Optional[dict]:
        """Per-replica step counts + averaging rounds when the learner is a
        multi-learner (``result.extras['learners']``); None otherwise."""
        stats = getattr(self.learner, "stats", None)
        return stats() if callable(stats) else None

    def stop(self):
        # launcher first: it marks the shutdown as user-initiated (so late
        # rate-limiter wakeups are noise, not worker errors) and stops every
        # node, including the replay shards.
        self.launcher.stop()
        self.table.stop()
        for dataset in self.datasets:
            # close (not just stop): sampler threads are joined and the
            # queue drained, so sequential runs in one process cannot
            # accumulate leaked prefetch threads.
            if hasattr(dataset, "close"):
                dataset.close()
            elif hasattr(dataset, "stop"):
                dataset.stop()
        try:
            self.launcher.join(timeout=30)
        except JoinTimeout as e:
            # best-effort teardown (runs in the experiment's finally path):
            # a straggler node must not destroy a fully computed result —
            # real worker errors still propagate above.
            import sys
            print(f"[distributed] warning: {e}", file=sys.stderr)
        # After join: the final parent push captures the services' end-of-run
        # state (replay tables and courier servers are parent-resident).
        # Worker processes pushed their own final snapshots on the way out.
        if self._telemetry_pusher is not None:
            self._telemetry_pusher.stop()

    def telemetry_snapshot(self):
        """Merged run-wide telemetry (None when telemetry is off).  Most
        informative AFTER ``stop()``, once every node's final push landed."""
        return (self.telemetry_hub.snapshot()
                if self.telemetry_hub is not None else None)


def make_distributed_agent(builder: AgentBuilder, env_factory,
                           num_actors: int,
                           seed: int = 0,
                           max_learner_steps: Optional[int] = None,
                           with_evaluator: bool = False,
                           num_replay_shards: Optional[int] = None,
                           prefetch_size: Optional[int] = None,
                           launcher: str = "local",
                           builder_factory=None,
                           spec=None,
                           num_envs_per_actor: Optional[int] = None,
                           inference: Optional[str] = None,
                           inference_max_batch_size: Optional[int] = None,
                           inference_max_wait_ms: float = 2.0,
                           num_learner_replicas: Optional[int] = None,
                           learner_average_period: Optional[int] = None,
                           telemetry: Optional[bool] = None,
                           telemetry_push_period_s: Optional[float] = None,
                           telemetry_jsonl: Optional[str] = None,
                           restart_policy=None,
                           chaos=None,
                           rpc_retry=None,
                           barrier_timeout_s: Optional[float] = None,
                           min_quorum: Optional[int] = None,
                           learner_sync: Optional[str] = None,
                           replay_routing: Optional[str] = None,
                           restore=None) -> DistributedAgent:
    """Replicated actors + one learner + replay (+ background evaluator),
    on a Launchpad-lite graph — Fig 4 of the paper.

    ``launcher`` selects the execution backend from the registry
    (``"local"`` threads / ``"multiprocess"`` one OS process per worker).
    Backends that place workers out-of-process pickle the worker nodes; for
    those, pass the (module-level, picklable) ``builder_factory`` + ``spec``
    so each child rebuilds its own builder — the same factory
    ``ExperimentConfig`` already carries.

    With ``num_replay_shards > 1`` the replay service is a ``ShardedReplay``
    built from the builder's own ``make_replay`` — one replay *service* node
    per shard is placed in the program graph (each independently courier-
    addressable).  With ``prefetch_size > 0`` the learner consumes batches
    through a ``PrefetchingDataset`` instead of the synchronous dataset.

    ``num_envs_per_actor > 1`` makes every actor node a vectorized acting
    worker (a ``VectorEnv`` + batched actor, one policy call per N env
    transitions); ``inference="server"`` additionally centralizes policy
    evaluation in a SEED-style inference service node on the builder's
    device that coalesces ``select_action`` RPCs from all actor workers
    into batched forward passes (the builder's own server where it has one,
    the generic ``InferenceServer`` otherwise).  All four default to the
    builder's ``BuilderOptions``.

    ``num_learner_replicas > 1`` places one ``learner/replica_i`` node per
    replay shard (replica i consumes shard i's — optionally prefetching —
    dataset exclusively) plus a ``learner/param_server`` service that
    merges replica params/opt-state every ``learner_average_period``
    per-replica steps; the ``learner`` endpoint keeps serving
    ``get_variables`` unchanged, so actors, evaluators, and checkpoints
    see ONE logical learner.  ``barrier_timeout_s`` / ``min_quorum``
    enable the parameter server's quorum mode.

    ``rpc_retry`` (a ``RetryConfig``) tunes courier reconnect/retry backoff
    in every worker.  ``restore`` is a pre-launch hook called as
    ``restore(learner, table, counter)`` once every service exists but
    before any worker runs — exact-resume state is applied through it.
    ``restart_policy`` wraps every actor in graceful degradation (a
    service's unreachable window costs skipped adds, not dead workers);
    the multiprocess launcher refuses it, and ``chaos``,
    ``learner_sync="async"`` and ``replay_routing="affinity"`` raise, until
    ROADMAP slice 7b ports elastic supervision and service failover (and
    with them the reference's ``service_snapshot_period_s``).
    """
    launcher_cls = get_launcher(launcher)
    if chaos is not None:
        raise _not_ported("chaos injection")
    program = Program("distributed_agent")
    program.restart_policy = restart_policy
    options = builder.options
    # Telemetry first: every component constructed below registers its
    # metrics/probes against the (re)configured process registry.  The
    # parent process is node "services" — under the multiprocess launcher
    # all service nodes (replay, param server, inference, courier servers)
    # are parent-resident, so its registry carries their metrics; under the
    # local launcher it carries the whole run.
    telemetry_on = _resolve(telemetry, options.telemetry)
    push_period = _resolve(telemetry_push_period_s,
                           options.telemetry_push_period_s)
    _telemetry.configure(enabled=telemetry_on, node="services")
    metrics_hub = MetricsHub(jsonl_path=telemetry_jsonl) \
        if telemetry_on else None
    _effective_sync(options, learner_sync)
    routing = _effective_routing(options, replay_routing)
    replicas, multi = _effective_replicas(options, num_learner_replicas)
    period = _resolve(learner_average_period,
                      options.learner_average_period)
    num_shards = (_replica_sharding(options, num_replay_shards, replicas)
                  if multi else _effective_shards(options, num_replay_shards))
    prefetch = _resolve(prefetch_size, options.prefetch_size)
    num_envs = _resolve(num_envs_per_actor, options.num_envs_per_actor)
    inference_mode = _resolve(inference, options.inference)
    if inference_mode not in ("local", "server"):
        raise ValueError(f"inference must be 'local' or 'server', "
                         f"got {inference_mode!r}")

    table = make_replay_shards(builder.make_replay, num_shards,
                               routing=routing)
    _register_replay_probe(table)
    datasets: List = []
    param_server = None
    replica_workers: List[LearnerReplicaWorker] = []
    if multi:
        replica_learners, datasets, shards = _make_replica_learners(
            builder, table, replicas, prefetch=prefetch)
        param_server = ParameterServer(
            replicas, period, barrier_timeout_s=barrier_timeout_s,
            min_quorum=min_quorum)
        replica_workers = [
            LearnerReplicaWorker(replica_learner, param_server, i,
                                 period, max_steps=max_learner_steps,
                                 dataset=datasets[i], shard=shards[i])
            for i, replica_learner in enumerate(replica_learners)]
        learner = MultiLearner(replica_learners, average_period=period,
                               param_server=param_server,
                               workers=replica_workers)
        worker = None
    else:
        iterator = builder.make_dataset(table)
        if prefetch > 0:
            iterator = PrefetchingDataset.over_iterator(
                iterator, prefetch_size=prefetch)
            datasets = [iterator]
        learner = builder.make_learner(
            iterator, priority_update_cb=table.update_priorities)
        worker = _LearnerWorker(learner, max_steps=max_learner_steps)

    inference_server = None
    if inference_mode == "server":
        # window sized so one full sweep of the fleet fits in a single
        # forward pass (requests are rows: num_envs per vectorized actor);
        # max_batch_size=num_envs disables coalescing (one request per
        # pass — the per-actor-call baseline).
        max_batch = _resolve(inference_max_batch_size,
                             max(num_actors * num_envs, 2))
        if max_batch < num_envs:
            raise ValueError(
                f"inference_max_batch_size={max_batch} cannot hold one "
                f"vectorized actor's request of num_envs_per_actor="
                f"{num_envs} rows (requests are never split)")
        # Builders with stateful serving (KV caches, recurrent cores) bring
        # their own service; everyone else gets the generic batcher.
        inference_server = builder.make_inference_server(
            worker if worker is not None else learner,
            max_batch_size=max_batch,
            max_wait_ms=inference_max_wait_ms,
            update_period=options.variable_update_period,
            rng_seed=seed + 777_777)
        if inference_server is None:
            policy = builder.make_policy(evaluation=False)
            # Generic server inference supports exactly the builders that
            # use the DEFAULT feed-forward batched actor: an override means
            # the agent needs per-step state or per-env extras (recurrent
            # core state, IMPALA's behaviour logits, MCTS planning) that a
            # weightless InferenceClientActor cannot produce — reject at
            # config time rather than crash in the batcher thread mid-run.
            custom_batched = (type(builder).make_batched_actor
                              is not AgentBuilder.make_batched_actor)
            if policy is None or custom_batched \
                    or not policy_is_feed_forward(policy):
                raise ValueError(
                    f"{type(builder).__name__} does not support "
                    f"inference='server': the server batches plain "
                    f"(params, generator, obs) -> action policies only (no "
                    f"recurrent state, no per-step extras) — keep "
                    f"inference='local' for this agent")
            inference_server = InferenceServer(
                policy, worker if worker is not None else learner,
                max_batch_size=max_batch,
                max_wait_ms=inference_max_wait_ms,
                update_period=options.variable_update_period,
                rng_seed=seed + 777_777, device=builder.device)

    # What crosses into worker processes: a picklable builder stand-in when
    # the backend needs one, the shared builder instance otherwise.
    actor_builder = builder
    if launcher_cls.requires_pickling and builder_factory is not None:
        if spec is None:
            spec = getattr(builder, "spec", None)
        actor_builder = _DeferredBuilder(builder_factory, spec)

    counter_handle = program.add_node(
        "counter", Counter, role="service",
        interface=("increment", "get_counts"))
    # The hub is an ordinary service node: worker processes push snapshots
    # to it over the same courier plumbing as every other edge.  Added
    # before the worker nodes so launchers that pickle workers have a
    # courier server bound to it by then (Handle → RemoteHandle).
    hub_handle = None
    telemetry_pusher = None
    if metrics_hub is not None:
        hub_handle = program.add_node(
            "telemetry/hub", lambda: metrics_hub, role="service",
            interface=HUB_INTERFACE)
        telemetry_pusher = MetricsPusher(metrics_hub, "services",
                                         push_period).start()
    # replay placement: one service node per shard (independently
    # addressable — what a multi-host launcher would schedule onto separate
    # replay servers), plus the routing front-end the adders talk to.
    if isinstance(table, ShardedReplay):
        for i, shard in enumerate(table.shards):
            program.add_node(f"replay/shard_{i}", lambda s=shard: s,
                             role="service", interface=REPLAY_INTERFACE)
    replay_handle = program.add_node("replay", lambda: table, role="service",
                                     interface=REPLAY_INTERFACE)
    if multi:
        # replica i has shard affinity with replay/shard_i; the param
        # server is the exchange point; the "learner" endpoint stays the
        # one variable source actors and evaluators already use.
        program.add_node("learner/param_server", lambda: param_server,
                         role="service", interface=PARAM_SERVER_INTERFACE)
        for i, replica_worker in enumerate(replica_workers):
            program.add_node(f"learner/replica_{i}",
                             lambda w=replica_worker: w, role="service",
                             interface=("get_variables",))
        learner_handle = program.add_node("learner", lambda: learner,
                                          role="service",
                                          interface=("get_variables",))
    else:
        learner_handle = program.add_node("learner", lambda: worker,
                                          role="service",
                                          interface=("get_variables",))
    inference_handle = None
    if inference_server is not None:
        inference_handle = program.add_node(
            "inference", lambda: inference_server, role="service",
            interface=getattr(inference_server, "INTERFACE",
                              INFERENCE_INTERFACE))
    actor_telemetry = None
    if hub_handle is not None:
        actor_telemetry = Replica(
            lambda i: WorkerTelemetry(hub_handle, f"actor/{i}", push_period))
    program.add_node(
        "actor", _ActorWorker, env_factory, actor_builder, learner_handle,
        counter_handle, replay_handle,
        Replica(lambda i: seed + 1000 * (i + 1)),
        role="worker", num_replicas=num_actors,
        num_envs=num_envs, inference=inference_handle,
        telemetry=actor_telemetry, rpc_retry=rpc_retry,
        resilient=restart_policy is not None)
    eval_log_handle = None
    if with_evaluator:
        eval_log_handle = program.add_node(
            "eval_log", ReturnsLog, role="service",
            interface=("append", "items"))
        eval_telemetry = None
        if hub_handle is not None:
            eval_telemetry = WorkerTelemetry(hub_handle, "evaluator",
                                             push_period)
        program.add_node("evaluator", _EvaluatorWorker, env_factory,
                         actor_builder, learner_handle, counter_handle,
                         seed + 999_999, eval_log_handle, role="worker",
                         telemetry=eval_telemetry)

    if restore is not None:
        # Exact-resume: services (learner, replay, counter) exist but no
        # worker has produced a transition yet — restored state is the
        # first state anything observes.
        restore(learner, table, program.resolve("counter"))
    launched = launcher_cls(program).launch()
    agent = DistributedAgent(program, launched, learner, table,
                             program.resolve("counter"),
                             datasets=datasets,
                             eval_log=(program.resolve("eval_log")
                                       if with_evaluator else None),
                             inference_server=inference_server,
                             telemetry_hub=metrics_hub,
                             telemetry_pusher=telemetry_pusher)
    if with_evaluator and program.node("evaluator").placement != "process":
        agent.evaluator = program.resolve("evaluator")
    return agent
