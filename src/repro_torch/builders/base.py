"""The formal builder protocol (§2.2/§2.4 of the paper).

Acme's central design claim is that ONE builder yields both the
single-process agent and the distributed program.  ``AgentBuilder`` turns
the seed's informal duck-typed convention into a typed contract:

  make_replay()            -> Table           (replay buffer / queue)
  make_adder(table)        -> Adder | None    (None for offline builders)
  make_dataset(table)      -> learner batch iterator
  make_learner(it, cb)     -> Learner
  make_policy(evaluation)  -> policy fn (or None for planning actors)
  make_actor(policy, client, adder, seed) -> Actor

plus a frozen ``BuilderOptions`` bundle replacing the loose
``variable_update_period`` / ``min_observations`` / ``observations_per_step``
instance attributes that every agent used to hand-roll.  Execution layers
(``agents.builders.make_agent``) consume only this
contract, so new execution modes (offline-only, evaluator fleets, async
actors) never require per-agent edits.

Concrete subclasses self-register; ``registered_builders()`` is the basis
of the conformance test in ``tests/test_torch_agents.py``.
"""
from __future__ import annotations

import abc
import dataclasses
import inspect
from typing import Any, Dict, Iterator, List, Optional, Type


@dataclasses.dataclass(frozen=True)
class BuilderOptions:
    """Execution-schedule knobs shared by every agent.

    variable_update_period: actor->learner weight-sync cadence (in actor
        ``update()`` calls).
    min_observations: observations before the first learner step (the
        single-process analogue of the rate limiter's min_size_to_sample).
    observations_per_step: observations per learner step (the synchronous
        samples-per-insert schedule, §2.5).
    batch_size: learner batch size — used by execution layers to decide
        whether a consuming (queue) dataset can serve a full batch.
    offline: the builder learns from a fixed dataset; it has no adder and
        its actors never feed replay (§2.6).
    num_replay_shards: replay shards the execution layer builds from
        ``make_replay`` (1 = single table; >1 = ``ShardedReplay`` with one
        full table + selector + rate limiter per shard).
    prefetch_size: learner-side prefetch queue depth in batches (0 = the
        synchronous dataset; >0 wraps it in a ``PrefetchingDataset`` on the
        distributed learner hot path).
    num_envs_per_actor: environments each actor drives through a
        ``VectorEnv`` + batched actor (1 = the classic single-env loop;
        N > 1 = one batched policy call per N env transitions).
    inference: where actor policy evaluation runs in distributed programs —
        ``"local"`` (each actor evaluates its own policy copy) or
        ``"server"`` (SEED-style: actors RPC a central ``InferenceServer``
        that coalesces requests into batched forward passes).
    num_learner_replicas: learner replicas the execution layer builds from
        ``make_learner`` (1 = the classic single SGD stream; N > 1 = one
        replica per replay shard, periodically merged by parameter
        averaging — actors and checkpoints still see one logical learner).
    learner_average_period: per-replica SGD steps between parameter-
        averaging rounds (params, target params, optimizer state, and step
        counters are all element-wise averaged).
    learner_sync: how replicas exchange parameters — ``"barrier"`` (strict
        all-or-nothing rendezvous), ``"quorum"`` (barrier with a timeout:
        needs ``barrier_timeout_s`` at the experiment layer), or
        ``"async"`` (push/pull ``AsyncParameterService``: each replica
        pushes at its own cadence and pulls the latest staleness-weighted
        blend, never waiting for peers).  ``"async"`` engages the
        multi-learner machinery even at one replica (the parity case).
    replay_routing: how inserts are routed across replay shards —
        ``"round_robin"`` (default), ``"hash"``, or ``"affinity"``
        (vectorized actors write each env's stream straight to its
        assigned shard through per-env ``ShardWriter``s).
    telemetry: enable ``repro_torch.telemetry`` for this agent's runs — every
        process records RPC latencies, queue waits, block times etc. into
        its ``MetricRegistry`` and pushes snapshots to a run-wide
        ``MetricsHub``.  Off by default: disabled metrics are no-op nulls.
    telemetry_push_period_s: seconds between a worker's snapshot pushes to
        the hub.
    """

    variable_update_period: int = 10
    min_observations: int = 0
    observations_per_step: float = 1.0
    batch_size: int = 1
    offline: bool = False
    num_replay_shards: int = 1
    prefetch_size: int = 0
    num_envs_per_actor: int = 1
    inference: str = "local"
    num_learner_replicas: int = 1
    learner_average_period: int = 50
    learner_sync: str = "barrier"
    replay_routing: str = "round_robin"
    telemetry: bool = False
    telemetry_push_period_s: float = 0.5

    def __post_init__(self):
        if self.variable_update_period < 1:
            raise ValueError(
                f"variable_update_period must be >= 1, got "
                f"{self.variable_update_period}")
        if self.min_observations < 0:
            raise ValueError(
                f"min_observations must be >= 0, got {self.min_observations}")
        if self.observations_per_step <= 0:
            raise ValueError(
                f"observations_per_step must be > 0, got "
                f"{self.observations_per_step}")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.num_replay_shards < 1:
            raise ValueError(
                f"num_replay_shards must be >= 1, got "
                f"{self.num_replay_shards}")
        if self.prefetch_size < 0:
            raise ValueError(
                f"prefetch_size must be >= 0, got {self.prefetch_size}")
        if self.num_envs_per_actor < 1:
            raise ValueError(
                f"num_envs_per_actor must be >= 1, got "
                f"{self.num_envs_per_actor}")
        if self.inference not in ("local", "server"):
            raise ValueError(
                f"inference must be 'local' or 'server', got "
                f"{self.inference!r}")
        if self.num_learner_replicas < 1:
            raise ValueError(
                f"num_learner_replicas must be >= 1, got "
                f"{self.num_learner_replicas}")
        if self.learner_average_period < 1:
            raise ValueError(
                f"learner_average_period must be >= 1, got "
                f"{self.learner_average_period}")
        if self.learner_sync not in ("barrier", "quorum", "async"):
            raise ValueError(
                f"learner_sync must be 'barrier', 'quorum' or 'async', got "
                f"{self.learner_sync!r}")
        if self.replay_routing not in ("round_robin", "hash", "affinity"):
            raise ValueError(
                f"replay_routing must be 'round_robin', 'hash' or "
                f"'affinity', got {self.replay_routing!r}")
        if self.telemetry_push_period_s <= 0:
            raise ValueError(
                f"telemetry_push_period_s must be > 0, got "
                f"{self.telemetry_push_period_s}")


class AgentBuilder(abc.ABC):
    """Typed factory bundle from which agents are assembled.

    Subclasses pass their ``BuilderOptions`` and the device their learner
    and actors run on to ``super().__init__`` and implement the six
    ``make_*`` factories.  Concrete subclasses are recorded in a registry
    used by the builder-conformance test.
    """

    _registry: List[Type["AgentBuilder"]] = []

    def __init__(self, options: BuilderOptions, device="cuda"):
        if not isinstance(options, BuilderOptions):
            raise TypeError(
                f"options must be a BuilderOptions, got {type(options)!r}")
        self._options = options
        self.device = device

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        AgentBuilder._registry.append(cls)

    @property
    def options(self) -> BuilderOptions:
        return self._options

    # ------------------------------------------------------ factory contract
    @abc.abstractmethod
    def make_replay(self):
        """The replay table (or queue) feeding the learner."""

    @abc.abstractmethod
    def make_adder(self, table) -> Optional[Any]:
        """An adder writing actor experience into ``table``; None if the
        builder is offline (fixed dataset, no insertion path)."""

    @abc.abstractmethod
    def make_dataset(self, table) -> Iterator:
        """The learner-facing batch iterator over ``table``."""

    @abc.abstractmethod
    def make_learner(self, iterator, priority_update_cb=None):
        """The learner consuming ``iterator``; ``priority_update_cb`` feeds
        TD-error priorities back to the replay table (may be ignored)."""

    @abc.abstractmethod
    def make_policy(self, evaluation: bool = False):
        """The policy function (behaviour or greedy); None for actors that
        plan rather than evaluate a standalone policy (MCTS)."""

    @abc.abstractmethod
    def make_actor(self, policy, variable_client, adder, seed: int = 0):
        """The actor running ``policy``, pulling weights from
        ``variable_client`` and feeding ``adder`` (which may be None)."""

    def make_batched_actor(self, policy, variable_client, adders,
                           seed: int = 0):
        """A batched actor stepping ``len(adders)`` envs through ONE batched
        policy call, fanning transitions out to per-env ``adders``.

        Not abstract: the default runs a feed-forward
        ``(params, generator, obs)`` policy over the stacked observations.
        Builders with recurrent actors override it to thread stacked core
        state; planning actors (MCTS) override it to raise.
        """
        from repro_torch.core.actors import BatchedFeedForwardActor
        return BatchedFeedForwardActor(policy, variable_client, adders,
                                       rng_seed=seed, device=self.device)

    def make_inference_server(self, variable_source, *, max_batch_size: int,
                              max_wait_ms: float, update_period: int,
                              rng_seed: int = 0):
        """A custom inference service for ``inference="server"`` programs.

        The generic feed-forward ``InferenceServer`` and the distributed
        programs that place it come with ROADMAP slice 7, so the default
        raises.
        """
        raise NotImplementedError(
            f"{type(self).__name__}: inference='server' needs the "
            "distributed programs of ROADMAP slice 7")

    def make_inference_actor(self, inference, adder=None, adders=None):
        """The actor-side client for an inference service node; the default
        raises until the inference client actor is ported (ROADMAP slice 7).
        """
        raise NotImplementedError(
            f"{type(self).__name__}: the inference client actor comes with "
            "ROADMAP slice 7")


def registered_builders() -> List[Type[AgentBuilder]]:
    """All concrete AgentBuilder subclasses imported so far."""
    return [cls for cls in AgentBuilder._registry
            if not inspect.isabstract(cls)]
