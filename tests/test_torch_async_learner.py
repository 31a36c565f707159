"""The port's async learner sync and shard-affine routing against the JAX
package's ``repro.learners`` and ``repro.replay``: the cases of the
reference's ``tests/test_async_learner.py`` that no other port test
covers, on the same numpy inputs.

- ``weighted_average_states`` equals the reference's bit for bit on numpy
  trees and on DQN learner states carried across by ``state_from_jax``
  (float32 ``leaf * w`` summed in replica order; integer counters exact on
  agreement, weighted floor mean otherwise), and the reference's
  hand-computed cases;
- ``AsyncParameterService``'s three merges (mean, ema, step_weighted) equal
  the reference service's blends bit for bit; the single contribution is
  verbatim; staleness bounds, lazy recomputation, invalidate, stop,
  mark_down and its snapshot (``HostTree``) behave as the reference's;
- a one-replica async ``MultiLearner`` is the plain learner, bit for bit,
  directly and through ``run_experiment``;
- shard-affine routing: ``ShardWriter`` keys and the env-to-shard
  assignment equal the reference's; routed and round-robin inserts sample
  identically; one config drives affinity and async end to end;
- program placement of ``learner/param_service``, and the chaos policy's
  seeded per-node jitter equal to the reference's.

The acceptances (multiprocess) are in ``test_torch_accept_async.py`` and
``test_torch_accept_async_failover.py``.
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from repro import learners as jax_learners
from repro.agents import dqn as jax_dqn
from repro.agents import builders as jax_builders
from repro.core import make_environment_spec as jax_spec
from repro.envs import Catch as JaxCatch
from repro.replay import ShardedReplay as JaxShardedReplay
from repro.replay import MinSize as JaxMinSize
from repro.replay import Table as JaxTable
from repro.replay import Uniform as JaxUniform
from repro.replay import dataset as jax_dataset
from repro.resilience import ChaosPolicy as JaxChaosPolicy
from repro_torch import tree
from repro_torch.agents import dqn
from repro_torch.agents.builders import make_agent, make_distributed_agent
from repro_torch.agents.common import state_from_jax
from repro_torch.core import make_environment_spec, types
from repro_torch.envs import Catch
from repro_torch.experiments import run_experiment
from repro_torch.learners import (ASYNC_PARAM_SERVICE_INTERFACE,
                                  AsyncParameterService, MultiLearner,
                                  ParameterServer, weighted_average_states)
from repro_torch.replay import (MinSize, ShardedReplay, ShardWriter, Table,
                                Uniform, make_replay_shards)
from repro_torch.replay.dataset import ReplaySample, SampleInfo
from repro_torch.resilience import ChaosPolicy, HostTree
from torch_factories import (DQNCatchBuilderFactory, catch_env_factory,
                             make_dqn_catch_config)
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
SMALL = dict(min_replay_size=8, samples_per_insert=0.0, batch_size=8,
             n_step=1, prioritized=False)
# (weights, steps) a service merge is driven with: fresh and stale pushes
WEIGHTS = [[1.0, 3.0], [0.25, 0.25, 0.5], [1e-3, 7.0, 2.5, 1.0],
           [0.1, 0.2, 0.3, 0.4, 0.5]]
MERGES = ("mean", "ema", "step_weighted")


# ----------------------------------------------------------------- helpers
def _spec():
    return make_environment_spec(Catch(seed=0))


def _dqn_builder(seed=0, **overrides):
    return dqn.DQNBuilder(_spec(), dqn.DQNConfig(**dict(SMALL, **overrides)),
                          seed=seed, device=CPU)


def _batches(num_batches, seed=0, port=True):
    """Deterministic DQN-shaped batches (Catch observations), as the
    port's or the reference's ReplaySamples."""
    out = []
    for b in range(num_batches):
        rng = np.random.RandomState(seed * 1000 + b)
        fields = (rng.rand(8, 10, 5).astype(np.float32),
                  rng.randint(0, 3, size=8).astype(np.int32),
                  rng.randn(8).astype(np.float32),
                  np.ones(8, np.float32),
                  rng.rand(8, 10, 5).astype(np.float32))
        keys = np.arange(8, dtype=np.int64)
        probs = np.full(8, 1.0 / 64)
        if port:
            out.append(ReplaySample(SampleInfo(keys, probs),
                                    types.Transition(*fields, ())))
        else:
            from repro.core import types as jax_types
            out.append(jax_dataset.ReplaySample(
                jax_dataset.SampleInfo(keys, probs),
                jax_types.Transition(*fields, ())))
    return out


def _assert_equal_to_reference(port, ref):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), (a, b)


def _assert_states_equal(a, b):
    leaves_a, leaves_b = tree.leaves(a), tree.leaves(b)
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y)


def _tensors(numpy_tree):
    return tree.map(torch.as_tensor, numpy_tree)


def _numpy_states(count, seed):
    rng = np.random.RandomState(seed)
    return [{"params": {"w": rng.randn(3, 4).astype(np.float32),
                        "b": np.float32(rng.randn())},
             "opt": {"mu": rng.randn(4).astype(np.float32) * 1e-3,
                     "nu": rng.rand(4).astype(np.float32) * 1e-7},
             "steps": np.int32(rng.randint(0, 1000)),
             "agreed": np.int32(2 ** 24 + 1),
             "ticks": rng.randint(-50, 50, size=3).astype(np.int32)}
            for _ in range(count)]


def _jax_dqn_states(count):
    """``count`` reference DQN learner states, diverged on different batch
    orders."""
    cfg = jax_dqn.DQNConfig(**SMALL)
    states = []
    for r in range(count):
        batches = _batches(4, seed=r, port=False)
        learner = jax_dqn.make_learner(jax_spec(JaxCatch(seed=0)), cfg,
                                       iter(batches), jax.random.key(r))
        for _ in range(r + 1):
            learner.step()
        states.append(learner.state)
    return states


def _w(value):
    """The one-leaf tree the service-math tests blend."""
    return {"w": torch.tensor(value, dtype=torch.float32)}


class _StubLearner:
    """Deterministic 'learner': step() adds 1.0 to its single param."""

    def __init__(self, w):
        self.state = _w(w)

    def step(self):
        self.state = {"w": self.state["w"] + 1.0}
        return {}


def _make_uniform_table():
    return Table("t", 64, Uniform(0), MinSize(1))


def _make_jax_uniform_table():
    return JaxTable("t", 64, JaxUniform(0), JaxMinSize(1))


# -------------------------------------------- weighted averaging math unit
@pytest.mark.parametrize("weights", WEIGHTS, ids=lambda w: f"{len(w)}")
def test_weighted_average_states_equals_reference_on_numpy_trees(weights):
    """Floats: one f32 multiply and add a replica in replica order, the
    same bits as the reference; integers: exact on agreement (past 2^24),
    the weighted floor mean otherwise, negative ones included."""
    states = _numpy_states(len(weights), seed=len(weights))
    ref = jax_learners.weighted_average_states(states, weights)
    port = weighted_average_states([_tensors(s) for s in states], weights)
    _assert_equal_to_reference(port, ref)
    assert int(port["agreed"]) == 2 ** 24 + 1


@pytest.mark.parametrize("weights", WEIGHTS[:3], ids=lambda w: f"{len(w)}")
def test_weighted_average_states_on_dqn_states_equals_reference(weights):
    """Reference DQN states carried across by ``state_from_jax`` blend to
    the reference's blend exactly: params, target params, Adam's moments
    and its step, and the (disagreeing) step counters."""
    jax_states = _jax_dqn_states(len(weights))
    ref = jax_learners.weighted_average_states(jax_states, weights)
    port = weighted_average_states(
        [state_from_jax(s, CPU) for s in jax_states], weights)
    _assert_equal_to_reference(port.params, ref.params)
    _assert_equal_to_reference(port.target_params, ref.target_params)
    _assert_equal_to_reference(tuple(port.opt_state), tuple(ref.opt_state))
    _assert_equal_to_reference(port.steps, ref.steps)


def test_weighted_average_states_matches_hand_computed_mean():
    """Float leaves take the normalized weighted mean; dtypes survive."""
    s1 = {"params": {"w": torch.tensor([1.0, 3.0]), "b": torch.tensor(2.0)}}
    s2 = {"params": {"w": torch.tensor([3.0, 5.0]), "b": torch.tensor(6.0)}}
    merged = weighted_average_states([s1, s2], [1.0, 3.0])
    # weights normalize to 0.25/0.75
    np.testing.assert_allclose(merged["params"]["w"], [2.5, 4.5], rtol=1e-6)
    np.testing.assert_allclose(merged["params"]["b"], 5.0, rtol=1e-6)
    assert merged["params"]["w"].dtype == torch.float32


def test_weighted_average_states_single_state_is_identity():
    """One state: the exact tree comes back regardless of its weight —
    what makes a 1-replica async blend bit-equivalent to the plain
    learner."""
    state = {"w": torch.tensor([1.0, 2.0]),
             "steps": torch.tensor(7, dtype=torch.int32)}
    assert weighted_average_states([state], [0.125]) is state


def test_weighted_average_states_integer_agreement_exact():
    """Agreeing integer counters merge exactly at any magnitude (no float
    round-trip), whatever the weights."""
    big = 2 ** 24 + 1
    s1 = {"steps": torch.tensor(big, dtype=torch.int32)}
    s2 = {"steps": torch.tensor(big, dtype=torch.int32)}
    merged = weighted_average_states([s1, s2], [1.0, 7.0])
    assert int(merged["steps"]) == big
    assert merged["steps"].dtype == torch.int32


def test_weighted_average_states_integer_disagreement_floor_mean():
    """Disagreeing counters take the weighted floor mean in float64:
    steps 10 and 20 under weights 1:3 -> 0.25*10 + 0.75*20 = 17.5 -> 17."""
    s1 = {"steps": torch.tensor(10, dtype=torch.int32)}
    s2 = {"steps": torch.tensor(20, dtype=torch.int32)}
    merged = weighted_average_states([s1, s2], [1.0, 3.0])
    assert int(merged["steps"]) == 17
    assert merged["steps"].dtype == torch.int32


def test_weighted_average_states_rejects_bad_args():
    state = _w(1.0)
    with pytest.raises(ValueError):
        weighted_average_states([], [])
    with pytest.raises(ValueError):
        weighted_average_states([state, state], [1.0])
    with pytest.raises(ValueError):
        weighted_average_states([state, state], [1.0, -0.5])
    with pytest.raises(ValueError):
        weighted_average_states([state, state], [0.0, 0.0])
    with pytest.raises(ValueError):    # structures differ, as jax.tree.map
        weighted_average_states([state, {"v": state["w"]}], [1.0, 1.0])


def test_weighted_average_states_keeps_leaves_on_their_device():
    states = [{"w": torch.full((3,), float(i)),
               "n": torch.tensor(i, dtype=torch.int64)} for i in range(2)]
    merged = weighted_average_states(states, [1.0, 1.0])
    assert merged["w"].device == states[0]["w"].device
    assert merged["w"].tolist() == [0.5, 0.5, 0.5]
    assert merged["n"].dtype == torch.int64 and int(merged["n"]) == 0


# --------------------------------------------------- async service: merges
@pytest.mark.parametrize("merge", MERGES)
def test_async_service_blends_equal_the_reference_service(merge):
    """Three reference DQN states pushed at different steps (so ema and
    step_weighted weight them differently) blend to the reference
    service's blend bit for bit."""
    jax_states = _jax_dqn_states(3)
    ref = jax_learners.AsyncParameterService(3, merge=merge, ema_alpha=0.5)
    port = AsyncParameterService(3, merge=merge, ema_alpha=0.5)
    for rid, (state, step) in enumerate(zip(jax_states, (12, 9, 10))):
        ref.push(rid, state, step)
        port.push(rid, state_from_jax(state, CPU), step)
    ref_blend, port_blend = ref.pull(), port.pull()
    _assert_equal_to_reference(port_blend.params, ref_blend.params)
    _assert_equal_to_reference(tuple(port_blend.opt_state),
                               tuple(ref_blend.opt_state))
    _assert_equal_to_reference(port_blend.steps, ref_blend.steps)
    assert port.stats() == ref.stats()


def test_async_service_single_contribution_is_verbatim():
    """One contributor: pull() returns the pushed tree object itself — no
    averaging round-trip (the 1-replica parity guarantee)."""
    service = AsyncParameterService(num_replicas=2, merge="ema")
    assert service.pull() is None       # nothing pushed yet
    state = _w(2.0)
    service.push(0, state, step=5)
    assert service.pull() is state


def test_async_service_mean_merge_hand_computed():
    service = AsyncParameterService(2, merge="mean")
    service.push(0, _w(2.0), step=10)
    service.push(1, _w(6.0), step=8)
    np.testing.assert_allclose(service.pull()["w"], 4.0, rtol=1e-6)


def test_async_service_ema_merge_weights_by_staleness():
    """ema weight = alpha**age, age = max_step - step: steps 10 and 8 at
    alpha 0.5 weight 1 : 0.25 -> (1*2 + 0.25*6) / 1.25 = 2.8."""
    service = AsyncParameterService(2, merge="ema", ema_alpha=0.5)
    service.push(0, _w(2.0), step=10)
    service.push(1, _w(6.0), step=8)
    np.testing.assert_allclose(service.pull()["w"], 2.8, rtol=1e-6)


def test_async_service_step_weighted_merge():
    """step_weighted weight = 1 + step: steps 1 and 3 weight 2 : 4 ->
    (2*2 + 4*6) / 6 = 28/6."""
    service = AsyncParameterService(2, merge="step_weighted")
    service.push(0, _w(2.0), step=1)
    service.push(1, _w(6.0), step=3)
    np.testing.assert_allclose(service.pull()["w"], 28.0 / 6.0, rtol=1e-6)


def test_async_service_blend_is_lazy():
    """The blend recomputes only when a push changed something: repeated
    pulls share one merge; the next push dirties it again."""
    service = AsyncParameterService(2, merge="mean")
    service.push(0, _w(2.0), step=1)
    service.push(1, _w(4.0), step=1)
    service.pull()
    service.pull()
    assert service.rounds == 1
    service.push(0, _w(6.0), step=2)
    np.testing.assert_allclose(service.pull()["w"], 5.0, rtol=1e-6)
    assert service.rounds == 2


def test_async_service_staleness_bound_drops_old_contributions():
    """Contributions older than the bound leave the blend (and are
    counted); a fresh re-push re-enters."""
    service = AsyncParameterService(2, merge="mean", staleness_bound=2)
    service.push(0, _w(1.0), step=0)
    fresh = _w(5.0)
    service.push(1, fresh, step=10)
    assert service.pull() is fresh
    stats = service.stats()
    assert stats["staleness_bound"] == 2
    assert stats["dropped_stale"] == 1
    assert stats["contributors"] == 2   # still tracked, just not blended
    service.push(0, _w(3.0), step=9)
    np.testing.assert_allclose(service.pull()["w"], 4.0, rtol=1e-6)


def test_async_service_invalidate_drops_contribution():
    service = AsyncParameterService(2, merge="mean")
    service.push(0, _w(2.0), step=1)
    survivor = _w(8.0)
    service.push(1, survivor, step=1)
    service.invalidate(0)
    assert service.pull() is survivor
    assert service.stats()["contributors"] == 1


# ----------------------------------------------- async service: lifecycle
def test_async_service_stats_and_activity():
    service = AsyncParameterService(3, merge="ema")
    service.push(0, _w(1.0), step=4)
    service.push(1, _w(2.0), step=6)
    service.pull()
    assert service.stats() == {"num_replicas": 3, "merge": "ema",
                               "pushes": 2, "pulls": 1, "merges": 1,
                               "contributors": 2, "max_step": 6}
    assert service.activity() == 3      # pushes + pulls


def test_async_service_stop_quiesces_push_and_pull():
    service = AsyncParameterService(1)
    service.push(0, _w(1.0), step=1)
    service.stop()
    assert service.stopped
    assert service.pull() is None       # a stopping fleet adopts nothing
    service.push(0, _w(9.0), step=2)    # no-op, not an error
    assert service.stats()["pushes"] == 1


def test_async_service_mark_down_raises_service_unavailable():
    """Simulated death: the data path raises ServiceUnavailable (a
    ConnectionError, so replica workers degrade through their existing
    handler) while metadata stays readable for the watchdog."""
    from repro_torch.distributed.courier import ServiceUnavailable

    assert issubclass(ServiceUnavailable, ConnectionError)
    service = AsyncParameterService(2)
    service.push(0, _w(1.0), step=1)
    service.mark_down()
    with pytest.raises(ServiceUnavailable):
        service.push(1, _w(2.0), step=1)
    with pytest.raises(ServiceUnavailable):
        service.pull()
    assert service.stats()["pushes"] == 1      # metadata path stays up
    assert "contrib" in service.state_dict()
    service.mark_up()
    assert service.pull() is not None


def test_async_service_state_dict_roundtrip():
    """A restored service blends exactly what the snapshot held; the
    snapshot holds each contribution as one host copy and pickles."""
    service = AsyncParameterService(2, merge="mean")
    service.push(0, _w(2.0), step=3)
    service.push(1, _w(6.0), step=5)
    before = service.pull()
    snapshot = pickle.loads(pickle.dumps(service.state_dict()))
    assert all(isinstance(c, HostTree)
               for c, _ in snapshot["contrib"].values())
    fresh = AsyncParameterService(2, merge="mean")
    fresh.load_state_dict(snapshot)
    _assert_states_equal(fresh.pull(), before)
    assert fresh.stats()["max_step"] == 5
    assert fresh.stats()["pushes"] == 2


def test_async_service_snapshot_of_dqn_states_restores_leaf_for_leaf():
    """Contributions with the learner's leaf types (float32 params and
    moments, int32 counters) come back leaf for leaf, dtypes included."""
    states = [state_from_jax(s, CPU) for s in _jax_dqn_states(2)]
    service = AsyncParameterService(2, merge="ema")
    for rid, state in enumerate(states):
        service.push(rid, state, step=rid + 3)
    fresh = AsyncParameterService(2, merge="ema")
    fresh.load_state_dict(pickle.loads(pickle.dumps(service.state_dict())))
    for rid, state in enumerate(states):
        restored, step = fresh._contrib[rid]
        assert step == rid + 3
        _assert_states_equal(restored, state)
    _assert_states_equal(fresh.pull(), service.pull())


def test_async_service_rejects_bad_args():
    with pytest.raises(ValueError):
        AsyncParameterService(num_replicas=0)
    with pytest.raises(ValueError):
        AsyncParameterService(2, merge="median")
    with pytest.raises(ValueError):
        AsyncParameterService(2, ema_alpha=0.0)
    with pytest.raises(ValueError):
        AsyncParameterService(2, ema_alpha=1.5)
    with pytest.raises(ValueError):
        AsyncParameterService(2, staleness_bound=0)
    service = AsyncParameterService(2)
    with pytest.raises(ValueError):
        service.push(2, _w(1.0), step=1)
    with pytest.raises(ValueError):
        service.push(0, _w(1.0), step=-1)


# ------------------------------------------------------------- parity net
def test_one_replica_async_multi_learner_matches_plain_learner():
    """On IDENTICAL batches from the same seed, a 1-replica async
    MultiLearner and the plain learner are bit-identical — every pull
    returns the replica's own state verbatim."""
    batches = _batches(12)
    plain = _dqn_builder(seed=3).make_learner(iter(list(batches)))
    multi = MultiLearner(
        [_dqn_builder(seed=3).make_learner(iter(list(batches)))],
        average_period=4, async_service=AsyncParameterService(1))
    for _ in range(12):
        plain.step()
        multi.step()
    _assert_states_equal(multi.state, plain.state)
    assert int(multi.state.steps) == int(plain.state.steps) == 12
    service = multi.async_service.stats()
    assert service["pushes"] == service["pulls"] == 3   # 12 steps / period 4
    assert service["contributors"] == 1


def test_run_experiment_async_parity_with_single_learner_path():
    """learner_sync='async' engages the multi-learner machinery even at
    one replica and lands on exactly the same state as the default path —
    same seed, same env stream, same sampled batches."""
    base = make_dqn_catch_config(
        seed=0, min_replay_size=16, samples_per_insert=0.0, batch_size=16,
        prioritized=False, num_episodes=15, eval_episodes=0)
    plain = run_experiment(base)
    asynced = run_experiment(dataclasses.replace(
        base, learner_sync="async", learner_average_period=7))
    assert plain.learner_steps == asynced.learner_steps > 0
    _assert_states_equal(asynced.learner.state.params,
                         plain.learner.state.params)
    _assert_states_equal(tuple(asynced.learner.state.opt_state),
                         tuple(plain.learner.state.opt_state))
    learners = asynced.extras["learners"]
    assert learners["num_replicas"] == 1
    assert learners["sync"] == "async"
    assert learners["service"]["contributors"] == 1
    assert learners["per_replica_steps"] == [asynced.learner_steps]
    assert "learners" not in plain.extras


def test_sequential_async_schedule_pushes_at_own_period():
    """2 stub replicas, period 1, mean merge — fully hand-computed: each
    replica pushes/pulls at ITS OWN boundary, a lone contributor adopts its
    own state verbatim, and later pulls blend both contributions."""
    multi = MultiLearner([_StubLearner(0.0), _StubLearner(10.0)],
                         average_period=1,
                         async_service=AsyncParameterService(2, merge="mean"))
    multi.step()   # replica 0: w=1, push(0, 1, step=1), pull -> verbatim 1
    np.testing.assert_allclose(multi.replicas[0].state["w"], 1.0)
    multi.step()   # replica 1: w=11, push(1, 11, 1), pull -> mean(1,11)=6
    np.testing.assert_allclose(multi.replicas[1].state["w"], 6.0)
    multi.step()   # replica 0: w=2, push(0, 2, 2), pull -> mean(2,11)=6.5
    np.testing.assert_allclose(multi.replicas[0].state["w"], 6.5)
    stats = multi.stats()
    assert stats["sync"] == "async"
    assert stats["per_replica_steps"] == [2, 1]
    assert stats["service"]["contributors"] == 2
    assert stats["service"]["max_step"] == 2


def test_sequential_async_schedule_equals_the_reference_multi_learner():
    """Two replicas from the reference's init on fixed batch streams,
    ema merge, period 3: every blend the port adopts equals the
    reference's up to the learners' own summation-order noise (1e-6, as
    ``test_torch_multi_learner.py`` holds the barrier schedule)."""
    period, steps = 3, 12
    ref = jax_learners.MultiLearner(
        [jax_dqn.make_learner(jax_spec(JaxCatch(seed=0)),
                              jax_dqn.DQNConfig(**SMALL),
                              iter(_batches(steps, seed=s, port=False)),
                              jax.random.key(s)) for s in (1, 2)],
        average_period=period,
        async_service=jax_learners.AsyncParameterService(2))
    replicas = []
    for s, ref_replica in zip((1, 2), ref.replicas):
        learner = _dqn_builder().make_learner(iter(_batches(steps, seed=s)))
        learner.state = state_from_jax(ref_replica.state, CPU)
        replicas.append(learner)
    port = MultiLearner(replicas, average_period=period,
                        async_service=AsyncParameterService(2))
    for _ in range(2 * steps):
        ref.step()
        port.step()
    assert port.stats()["service"] == ref.stats()["service"]
    for replica, ref_replica in zip(port.replicas, ref.replicas):
        for a, b in zip(tree.leaves(replica.state.params),
                        jax.tree.leaves(ref_replica.state.params)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)
        assert int(replica.state.steps) == int(ref_replica.state.steps)


def test_multi_learner_rejects_both_server_and_service():
    with pytest.raises(ValueError, match="not both"):
        MultiLearner([_StubLearner(0.0)],
                     param_server=ParameterServer(1, 1),
                     async_service=AsyncParameterService(1))


# ------------------------------------------------------ config validation
def test_experiment_config_validates_sync_and_routing():
    base = make_dqn_catch_config(seed=0)
    with pytest.raises(ValueError, match="learner_sync"):
        dataclasses.replace(base, learner_sync="eventually")
    with pytest.raises(ValueError, match="barrier_timeout_s"):
        dataclasses.replace(base, learner_sync="quorum")
    with pytest.raises(ValueError, match="incompatible"):
        dataclasses.replace(base, learner_sync="async",
                            barrier_timeout_s=1.0)
    with pytest.raises(ValueError, match="incompatible"):
        dataclasses.replace(base, learner_sync="async",
                            barrier_timeout_s=1.0, min_quorum=1)
    with pytest.raises(ValueError, match="replay_routing"):
        dataclasses.replace(base, replay_routing="sticky")


def test_builder_options_validate_sync_and_routing():
    from repro_torch.builders.base import BuilderOptions

    with pytest.raises(ValueError, match="learner_sync"):
        BuilderOptions(learner_sync="eventually")
    with pytest.raises(ValueError, match="replay_routing"):
        BuilderOptions(replay_routing="sticky")
    assert BuilderOptions(learner_sync="async",
                          replay_routing="affinity").learner_sync == "async"


def test_make_agent_rejects_async_for_offline_builders():
    from repro_torch.agents.bc import BCBuilder, BCConfig

    items = [types.Transition(np.zeros((10, 5), np.float32), np.int32(i % 3),
                              np.float32(0.0), np.float32(1.0),
                              np.zeros((10, 5), np.float32))
             for i in range(8)]
    builder = BCBuilder(_spec(), items, BCConfig(batch_size=4), seed=0,
                        device=CPU)
    with pytest.raises(ValueError, match="offline"):
        make_agent(builder, learner_sync="async")


def test_make_distributed_agent_rejects_async_with_quorum_knobs():
    builder = DQNCatchBuilderFactory()(_spec())
    with pytest.raises(ValueError, match="incompatible"):
        make_distributed_agent(builder, catch_env_factory, num_actors=1,
                               seed=0, num_learner_replicas=2,
                               learner_sync="async", barrier_timeout_s=1.0)


# --------------------------------------------------- shard-affine routing
def test_shard_writer_keys_interchangeable_with_front_end():
    """shard_view inserts produce keys the ShardedReplay front-end routes
    back to the owning shard; only the written shard grows; the front
    end's routing cursor is never touched — as in the reference."""
    port = ShardedReplay.from_factory(_make_uniform_table, 2,
                                      routing="affinity")
    ref = JaxShardedReplay.from_factory(_make_jax_uniform_table, 2,
                                        routing="affinity")
    keys = [port.shard_view(0).insert(np.full(3, k, np.float32))
            for k in range(6)]
    ref_keys = [ref.shard_view(0).insert(np.full(3, k, np.float32))
                for k in range(6)]
    assert keys == ref_keys
    assert all(port.shard_of(k) == 0 for k in keys)
    assert [s.size() for s in port.shards] == [6, 0]
    assert port.size() == 6
    port.update_priorities(keys, [2.0] * len(keys))
    assert port._insert_ticket.value == 0
    port.stop()
    ref.stop()


def test_routed_and_round_robin_inserts_sample_identically():
    """The same item stream written shard-directly (affinity) and through
    the front-end cursor (round_robin) produces the same global keys, the
    same shard contents, and the same sampled batches."""
    routed = ShardedReplay.from_factory(_make_uniform_table, 2,
                                        routing="affinity")
    plain = ShardedReplay.from_factory(_make_uniform_table, 2,
                                       routing="round_robin")
    writers = [routed.shard_view(i) for i in range(2)]
    for k in range(16):
        data = np.full(3, k, np.float32)
        assert writers[k % 2].insert(data) == plain.insert(data)
    for (item_r, prob_r), (item_p, prob_p) in zip(routed.sample(8),
                                                  plain.sample(8)):
        assert item_r.key == item_p.key
        assert prob_r == prob_p
        np.testing.assert_array_equal(item_r.data, item_p.data)
    routed.stop()
    plain.stop()


def test_make_replay_shards_threads_routing_through():
    sharded = make_replay_shards(_make_uniform_table, 2, routing="affinity")
    assert isinstance(sharded, ShardedReplay)
    assert sharded.routing == "affinity"
    with pytest.raises(ValueError, match="routing"):
        ShardedReplay(sharded.shards, routing="sticky")
    sharded.stop()


@pytest.mark.parametrize("num_envs", [1, 2, 3])
def test_make_agent_affine_adders_write_where_the_reference_writes(num_envs):
    """Under affinity each env's adder writes through a ShardWriter onto
    the shard the reference assigns it (env e -> shard e % num_shards),
    and the same insert stream gets the reference's global keys."""
    port = make_agent(_dqn_builder(), num_replay_shards=2,
                      num_envs=num_envs, replay_routing="affinity")
    jax_builder = jax_dqn.DQNBuilder(jax_spec(JaxCatch(seed=0)),
                                     jax_dqn.DQNConfig(**SMALL), seed=0)
    ref = jax_builders.make_agent(jax_builder, num_replay_shards=2,
                                  num_envs=num_envs,
                                  replay_routing="affinity")

    def sinks(agent):
        adders = getattr(agent.actor, "_adders", None) \
            or [agent.actor._adder]
        return [adder.table for adder in adders]

    port_sinks, ref_sinks = sinks(port), sinks(ref)
    assert all(isinstance(s, ShardWriter) for s in port_sinks)
    assert [(s.shard_idx, s.num_shards) for s in port_sinks] \
        == [(s.shard_idx, s.num_shards) for s in ref_sinks]
    for k in range(5):
        for port_sink, ref_sink in zip(port_sinks, ref_sinks):
            item = np.full(3, k, np.float32)
            assert port_sink.insert(item) == ref_sink.insert(item)


def test_run_experiment_affinity_async_end_to_end_with_telemetry():
    """One ExperimentConfig drives async learner replicas and shard-affine
    vectorized adders, with the routing counters proving every insert went
    shard-direct and the push/pull staleness histograms populated."""
    config = make_dqn_catch_config(
        seed=0, min_replay_size=16, samples_per_insert=0.0, batch_size=16,
        prioritized=False, num_episodes=12, eval_episodes=0,
        num_envs_per_actor=2, num_learner_replicas=2,
        learner_average_period=5, learner_sync="async",
        replay_routing="affinity", telemetry=True)
    result = run_experiment(config)
    assert result.learner_steps > 0
    learners = result.extras["learners"]
    assert learners["sync"] == "async"
    assert learners["num_replicas"] == 2
    assert learners["rounds"] >= 1
    assert learners["service"]["pushes"] > 0
    merged = result.extras["telemetry"]["merged"]
    assert merged["replay/routing/shard_0/inserts"]["value"] > 0
    assert merged["replay/routing/shard_1/inserts"]["value"] > 0
    assert merged["learner/push_staleness"]["count"] > 0
    assert merged["learner/pull_age_steps"]["count"] > 0


# ------------------------------------------------------ program placement
def test_make_distributed_agent_places_async_param_service():
    builder = DQNCatchBuilderFactory(samples_per_insert=0.0)(_spec())
    dist = make_distributed_agent(builder, catch_env_factory, num_actors=1,
                                  seed=0, num_learner_replicas=2,
                                  learner_average_period=10,
                                  learner_sync="async", prefetch_size=2)
    try:
        names = {n.name for n in dist.program.nodes}
        assert "learner/param_service" in names
        assert "learner/param_server" not in names
        node = dist.program.node("learner/param_service")
        assert node.interface == ASYNC_PARAM_SERVICE_INTERFACE
        assert isinstance(dist.learner, MultiLearner)
        service = dist.program.resolve("learner/param_service")
        assert dist.learner.async_service is service
        for i in range(2):
            worker = dist.program.resolve(f"learner/replica_{i}")
            assert worker.sync_mode == "async"
            assert worker.param_server is service
    finally:
        dist.stop()
    assert all(d.closed for d in dist.datasets)


def test_make_distributed_agent_wires_shard_writers_to_actors():
    """With affinity, the actor nodes get one handle a replay shard and
    their index, as the reference's do; chaos reaches the program only
    under a launcher that pickles (process isolation)."""
    builder = DQNCatchBuilderFactory(samples_per_insert=0.0)(_spec())
    chaos = ChaosPolicy(kill_after_steps=5, kill_targets=("actor/0",))
    dist = make_distributed_agent(builder, catch_env_factory, num_actors=2,
                                  seed=0, num_replay_shards=2,
                                  replay_routing="affinity", chaos=chaos,
                                  max_learner_steps=1)
    try:
        for i in range(2):
            kwargs = dist.program.node(f"actor/{i}").kwargs
            assert len(kwargs["shard_tables"]) == 2
            assert kwargs["actor_index"] == i
            assert kwargs["chaos"] is None       # local launcher: threads
        assert dist.program.chaos_policy is None
    finally:
        dist.stop()


# --------------------------------------------------------- chaos schedules
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_chaos_policy_jitter_equals_the_reference(seed):
    """The seeded per-node jitter (``random.Random(f"{seed}/{node}")``) gives
    the reference's kill steps for actors and services alike."""
    kwargs = dict(kill_after_steps=100, kill_jitter_steps=50, seed=seed,
                  kill_targets=("actor/0", "actor/3", "replay/shard_1",
                                "learner/replica_0"))
    port, ref = ChaosPolicy(**kwargs), JaxChaosPolicy(**kwargs)
    for node in kwargs["kill_targets"]:
        assert port.schedule_for(node).kill_step \
            == ref.schedule_for(node).kill_step
        assert port.service_schedule_for(node).kill_step \
            == ref.service_schedule_for(node).kill_step
    injector, ref_injector = (ChaosPolicy(rpc_drop_rate=0.4, seed=seed)
                              .rpc_injector(),
                              JaxChaosPolicy(rpc_drop_rate=0.4, seed=seed)
                              .rpc_injector())
    outcomes = []
    for inj in (injector, ref_injector):
        drops = []
        for _ in range(50):
            try:
                inj.before_send()
                drops.append(False)
            except ConnectionError:
                drops.append(True)
        outcomes.append(drops)
    assert outcomes[0] == outcomes[1]
