"""Experiment configuration: everything needed to reproduce a run.

An ``ExperimentConfig`` is the single declarative object from which both
``run_experiment`` (single-process, §2.2) and ``run_distributed_experiment``
(Launchpad-lite program, §2.4) construct the SAME agent — the builder is
shared unchanged between the two execution modes, which is the paper's
central modularity claim.

The port keeps every field and check of the JAX package's config.  The
three fields whose types live in the distributed runtime
(``restart_policy``, ``chaos`` and ``rpc_retry``) raise
``NotImplementedError`` when set, until that runtime is ported (ROADMAP
slice 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.builders import AgentBuilder
from repro_torch.core.types import Environment, EnvironmentSpec

BuilderFactory = Callable[[EnvironmentSpec], AgentBuilder]
EnvironmentFactory = Callable[[int], Environment]
LoggerFactory = Callable[[str], Callable[[Dict[str, Any]], None]]


@dataclasses.dataclass
class ExperimentConfig:
    """Declarative description of a training run.

    builder_factory: spec -> AgentBuilder (called once per run).
    environment_factory: seed -> Environment (called per actor/evaluator).
    seed: base RNG seed; actors and evaluators derive offsets from it.
    num_episodes: training episodes (single-process runs).
    max_actor_steps: stop once the shared actor-step counter passes this
        (distributed runs; optional cap for single-process runs).
    logger_factory: label -> logger callable, attached to the train loop.
    checkpoint_dir: if set, learner state is checkpointed there.
    checkpoint_every: learner steps between checkpoints (0 = only final).
    eval_every: run an eval pass every N training episodes (0 = only final).
    eval_episodes: episodes per eval pass.
    num_replay_shards: replay shards built from the builder's
        ``make_replay`` (None = defer to the builder's options; >1 = a
        ``ShardedReplay`` service, one replay node per shard in the
        distributed program graph).
    prefetch_size: learner prefetch queue depth in batches (None = defer to
        the builder's options; >0 = a ``PrefetchingDataset`` on the
        distributed learner hot path).
    launcher: execution backend for distributed runs, resolved through the
        distributed launcher registry — ``"local"`` (worker nodes
        on threads) or ``"multiprocess"`` (each worker node in its own OS
        process with courier RPC edges; requires ``builder_factory`` and
        ``environment_factory`` to be picklable, i.e. module-level).
    num_envs_per_actor: environments per actor (None = defer to the
        builder's options; N > 1 = each actor is a ``VectorEnv`` + batched
        actor evaluating ONE vmapped policy call per N env transitions —
        single-process and distributed runs alike).
    inference: policy-evaluation placement for distributed runs (None =
        defer to the builder's options) — ``"local"`` (each actor holds its
        own policy copy) or ``"server"`` (SEED-style: one ``InferenceServer``
        service node coalesces ``select_action`` RPCs from every actor
        worker into batched forward passes).  Single-process runs always
        evaluate locally.
    inference_max_batch_size: the server's coalescing window in observation
        ROWS per forward pass (None = one full fleet sweep,
        ``num_actors * num_envs_per_actor``; ``num_envs_per_actor`` disables
        coalescing — every request dispatches alone).
    inference_max_wait_ms: how long the server holds an open window for
        more requests, measured from the window's first request.
    num_learner_replicas: learner replicas built from the builder's
        ``make_learner`` (None = defer to the builder's options).  With
        N > 1 each replica consumes its own replay shard's dataset
        (``num_replay_shards`` must be unset or equal to N) and a
        ``ParameterServer`` periodically averages replica params/opt-state;
        actors, evaluators, and checkpoints still see ONE logical learner.
        Setting this explicitly — even to 1 — routes the run through the
        multi-learner machinery, which is exactly equivalent to the plain
        single-learner path at N=1 (the parity the test net proves).
    learner_average_period: per-replica SGD steps between parameter-
        averaging rounds (None = defer to the builder's options).
    telemetry: enable the ``repro_torch.telemetry`` layer (None = defer to the
        builder's options).  When on, every worker process records hot-path
        metrics (courier RPC latency/bytes, inference queue-wait and batch
        occupancy, replay block times and occupancy, barrier waits) and
        pushes periodic snapshots to a run-wide ``MetricsHub``; the merged
        snapshot is returned in ``ExperimentResult.extras["telemetry"]``.
    telemetry_push_period_s: seconds between worker snapshot pushes (None =
        defer to the builder's options).
    telemetry_jsonl: if set, the hub appends every received snapshot to
        this JSONL file (one ``{node, time, metrics}`` record per push).
    resume: restore the run from ``checkpoint_dir``'s latest run-wide
        snapshot (learner + replay contents + counters + RNG streams) and
        continue.  Single-process runs resume bit-exactly; distributed
        runs restore the same state but re-interleave asynchronously (see
        ROADMAP "Elastic & resumable runs").  No snapshot present = start
        fresh.  Requires ``checkpoint_dir``.
    restart_policy: a ``RestartPolicy`` (slice 7) enabling elastic
        actor pools under the multiprocess launcher — dead ``role="worker"``
        replicas are classified (crash / preemption / shutdown) and
        respawned with exponential backoff under a per-worker budget,
        instead of failing the run.  None = fail-fast (the default).
    chaos: a ``ChaosPolicy`` (slice 7) injecting seeded faults
        (worker kills after N steps, service kills by activity, courier
        RPC delay/drop) into distributed runs — the harness the chaos
        acceptance tests drive.  None = no injection.
    rpc_retry: a ``RetryConfig`` (slice 7) tuning courier
        client-side retry/backoff — how long calls reconnect through a
        service's restart window before raising ``ServiceUnavailable``,
        and how many attempts idempotent methods get when a response is
        lost.  Installed process-globally in every worker.  None = the
        courier defaults.
    barrier_timeout_s: parameter-server quorum mode — a round whose first
        contribution is this old merges whatever >= ``min_quorum``
        replicas delivered instead of stalling on stragglers.  None (the
        default) keeps the strict all-or-nothing barrier.
    min_quorum: minimum replica contributions for a timed-out round to
        merge (None with ``barrier_timeout_s`` set = 1).  Requires
        ``barrier_timeout_s``.
    learner_sync: how learner replicas exchange parameters (None = defer
        to the builder's options, whose default is ``"barrier"``) —
        ``"barrier"`` (strict all-or-nothing rendezvous), ``"quorum"``
        (barrier + ``barrier_timeout_s``/``min_quorum``), or ``"async"``
        (push/pull ``AsyncParameterService``: replicas push at their own
        cadence and pull the latest staleness-weighted blend, never
        waiting for peers).  ``"async"`` engages the multi-learner
        machinery even at one replica — the 1-replica parity case — and
        is incompatible with the quorum knobs.
    replay_routing: insert routing across replay shards (None = defer to
        the builder's options) — ``"round_robin"``, ``"hash"``, or
        ``"affinity"`` (vectorized actors write each env's stream
        straight to its assigned shard through per-env ``ShardWriter``s;
        priority updates route back by key).
    service_snapshot_period_s: cadence at which the service watchdog
        snapshots recoverable services for failover (None = 0.5s).  Only
        meaningful with ``restart_policy`` under the multiprocess
        launcher.
    """

    builder_factory: BuilderFactory
    environment_factory: EnvironmentFactory
    seed: int = 0
    num_episodes: int = 100
    max_actor_steps: Optional[int] = None
    logger_factory: Optional[LoggerFactory] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    eval_every: int = 0
    eval_episodes: int = 10
    num_replay_shards: Optional[int] = None
    prefetch_size: Optional[int] = None
    launcher: str = "local"
    num_envs_per_actor: Optional[int] = None
    inference: Optional[str] = None
    inference_max_batch_size: Optional[int] = None
    inference_max_wait_ms: float = 2.0
    num_learner_replicas: Optional[int] = None
    learner_average_period: Optional[int] = None
    telemetry: Optional[bool] = None
    telemetry_push_period_s: Optional[float] = None
    telemetry_jsonl: Optional[str] = None
    resume: bool = False
    restart_policy: Optional[Any] = None
    chaos: Optional[Any] = None
    rpc_retry: Optional[Any] = None
    barrier_timeout_s: Optional[float] = None
    min_quorum: Optional[int] = None
    learner_sync: Optional[str] = None
    replay_routing: Optional[str] = None
    service_snapshot_period_s: Optional[float] = None

    def __post_init__(self):
        if self.num_episodes < 1:
            raise ValueError(f"num_episodes must be >= 1, "
                             f"got {self.num_episodes}")
        if self.eval_every < 0 or self.eval_episodes < 0:
            raise ValueError("eval cadence values must be >= 0")
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, "
                             f"got {self.checkpoint_every}")
        if self.num_replay_shards is not None and self.num_replay_shards < 1:
            raise ValueError(f"num_replay_shards must be >= 1, "
                             f"got {self.num_replay_shards}")
        if self.prefetch_size is not None and self.prefetch_size < 0:
            raise ValueError(f"prefetch_size must be >= 0, "
                             f"got {self.prefetch_size}")
        if not self.launcher or not isinstance(self.launcher, str):
            raise ValueError(f"launcher must be a backend name, "
                             f"got {self.launcher!r}")
        if self.num_envs_per_actor is not None \
                and self.num_envs_per_actor < 1:
            raise ValueError(f"num_envs_per_actor must be >= 1, "
                             f"got {self.num_envs_per_actor}")
        if self.inference is not None \
                and self.inference not in ("local", "server"):
            raise ValueError(f"inference must be 'local' or 'server', "
                             f"got {self.inference!r}")
        if self.inference_max_batch_size is not None \
                and self.inference_max_batch_size < 1:
            raise ValueError(f"inference_max_batch_size must be >= 1, "
                             f"got {self.inference_max_batch_size}")
        if self.inference_max_wait_ms < 0:
            raise ValueError(f"inference_max_wait_ms must be >= 0, "
                             f"got {self.inference_max_wait_ms}")
        if self.num_learner_replicas is not None \
                and self.num_learner_replicas < 1:
            raise ValueError(f"num_learner_replicas must be >= 1, "
                             f"got {self.num_learner_replicas}")
        if self.learner_average_period is not None \
                and self.learner_average_period < 1:
            raise ValueError(f"learner_average_period must be >= 1, "
                             f"got {self.learner_average_period}")
        if self.telemetry_push_period_s is not None \
                and self.telemetry_push_period_s <= 0:
            raise ValueError(f"telemetry_push_period_s must be > 0, "
                             f"got {self.telemetry_push_period_s}")
        if self.resume and not self.checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        for name in ("restart_policy", "chaos", "rpc_retry"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"ExperimentConfig.{name} is not ported yet (ROADMAP "
                    f"slice 7, distributed execution)")
        if self.barrier_timeout_s is not None and self.barrier_timeout_s <= 0:
            raise ValueError(f"barrier_timeout_s must be > 0, "
                             f"got {self.barrier_timeout_s}")
        if self.min_quorum is not None:
            if self.barrier_timeout_s is None:
                raise ValueError(
                    "min_quorum requires barrier_timeout_s (a round only "
                    "closes below full strength when the barrier times out)")
            if self.min_quorum < 1:
                raise ValueError(f"min_quorum must be >= 1, "
                                 f"got {self.min_quorum}")
        if self.learner_sync is not None:
            if self.learner_sync not in ("barrier", "quorum", "async"):
                raise ValueError(
                    f"learner_sync must be 'barrier', 'quorum' or 'async', "
                    f"got {self.learner_sync!r}")
            if self.learner_sync == "quorum" \
                    and self.barrier_timeout_s is None:
                raise ValueError(
                    "learner_sync='quorum' requires barrier_timeout_s "
                    "(the timeout is what lets a round close below full "
                    "strength)")
            if self.learner_sync == "async" and (
                    self.barrier_timeout_s is not None
                    or self.min_quorum is not None):
                raise ValueError(
                    "learner_sync='async' is incompatible with "
                    "barrier_timeout_s/min_quorum: async replicas never "
                    "rendezvous, so there is no round to time out")
        if self.replay_routing is not None \
                and self.replay_routing not in ("round_robin", "hash",
                                                "affinity"):
            raise ValueError(
                f"replay_routing must be 'round_robin', 'hash' or "
                f"'affinity', got {self.replay_routing!r}")
        if self.service_snapshot_period_s is not None \
                and self.service_snapshot_period_s <= 0:
            raise ValueError(f"service_snapshot_period_s must be > 0, "
                             f"got {self.service_snapshot_period_s}")


@dataclasses.dataclass
class ExperimentResult:
    """What a run hands back: curves, eval points, and the live learner."""

    train_returns: List[float]
    actor_steps: List[int]
    walltime: List[float]
    # (progress, mean_return): progress is actor steps for online runs,
    # learner steps for offline runs (no actors exist there).
    eval_returns: List[Tuple[int, float]]
    counts: Dict[str, float]
    learner_steps: int
    learner: Any
    builder: AgentBuilder
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def final_eval_return(self) -> Optional[float]:
        return self.eval_returns[-1][1] if self.eval_returns else None
