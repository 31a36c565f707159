"""repro_torch.learners against the JAX package's ``repro.learners``.

- ``average_states`` equals the reference's exactly on the same numpy
  trees and on DQN learner states carried across by ``state_from_jax``:
  floats fold left in float32 in the reference's order, and integers take
  the int64 floor mean (exact past 2^24);
- the ``ParameterServer`` in barrier mode, in quorum mode (the reference's
  ``tests/test_resilience.py`` quorum cases) and on stop;
- a one-replica ``MultiLearner`` is bit-identical to the plain learner;
- two replicas fed the same fixed batches as the reference's
  ``MultiLearner``, from the same init: after 3 averaging rounds of period
  5, params, target params and Adam's moments within 1e-6 (absolute) of
  the reference's (the same f32 math in another summation order;
  ``test_torch_dqn.py`` holds one learner to the same atol);
- the reference's ``tests/test_multi_learner.py`` cases on the port's
  assembly: the sequential schedule, shard affinity of replica nodes,
  checkpoints of the merged state, prefetch teardown.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import learners as jax_learners
from repro.agents import dqn as jax_dqn
from repro.core import make_environment_spec as jax_spec
from repro.core import types as jax_types
from repro.envs import Catch as JaxCatch
from repro.replay import dataset as jax_dataset
from repro_torch import tree
from repro_torch.agents import dqn
from repro_torch.agents.common import state_from_jax
from repro_torch.core import make_environment_spec, types
from repro_torch.envs import Catch
from repro_torch.learners import (LearnerReplicaWorker, MultiLearner,
                                  ParameterServer, average_states)
from repro_torch.replay.dataset import ReplaySample, SampleInfo
from torch_factories import (DQNCatchBuilderFactory, catch_env_factory,
                             make_dqn_catch_config)
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
JOIN_S = 30
TWO_REPLICA_ATOL = 1e-6
SMALL = dict(min_replay_size=8, samples_per_insert=0.0, batch_size=8,
             n_step=1, prioritized=False)


# ----------------------------------------------------------------- helpers
def _spec():
    return make_environment_spec(Catch(seed=0))


def _dqn_builder(seed=0, **overrides):
    return dqn.DQNBuilder(_spec(), dqn.DQNConfig(**dict(SMALL, **overrides)),
                          seed=seed, device=CPU)


def _batch_fields(seed, batch_size=8):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch_size, 10, 5).astype(np.float32),
            rng.randint(0, 3, size=batch_size).astype(np.int32),
            rng.randn(batch_size).astype(np.float32),
            np.ones(batch_size, np.float32),
            rng.rand(batch_size, 10, 5).astype(np.float32))


def _batches(num_batches, seed=0, port=True):
    """Deterministic DQN-shaped batches (Catch observations), as the
    port's or the reference's ReplaySamples."""
    out = []
    for b in range(num_batches):
        fields = _batch_fields(seed * 1000 + b)
        keys = np.arange(8, dtype=np.int64)
        probs = np.full(8, 1.0 / 64)
        if port:
            out.append(ReplaySample(SampleInfo(keys, probs),
                                    types.Transition(*fields, ())))
        else:
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


def _assert_close_to_reference(port, ref):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TWO_REPLICA_ATOL, rtol=0)


def _assert_states_equal(a, b):
    leaves_a, leaves_b = tree.leaves(a), tree.leaves(b)
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _tensors(numpy_tree):
    return tree.map(torch.as_tensor, numpy_tree)


# ----------------------------------------------------- averaging math unit
def _numpy_states(count, seed):
    rng = np.random.RandomState(seed)
    return [{"params": {"w": rng.randn(3, 4).astype(np.float32),
                        "b": np.float32(rng.randn())},
             "opt": {"mu": rng.randn(4).astype(np.float32) * 1e-3,
                     "nu": rng.rand(4).astype(np.float32) * 1e-7},
             "steps": np.int32(rng.randint(0, 1000)),
             "ticks": rng.randint(-50, 50, size=3).astype(np.int32)}
            for _ in range(count)]


@pytest.mark.parametrize("count", [2, 3, 5])
def test_average_states_equals_reference_on_numpy_trees(count):
    """Floats fold left in f32 in the reference's order (the same bits);
    integers take the int64 floor mean, negative ones included."""
    states = _numpy_states(count, seed=count)
    ref = jax_learners.average_states(states)
    port = average_states([_tensors(s) for s in states])
    _assert_equal_to_reference(port, ref)


def test_average_states_matches_hand_computed_pytree_mean():
    """Params, optimizer moments, and integer step counters are all
    element-wise averaged; dtypes are preserved."""
    s1 = {"params": {"w": torch.tensor([1.0, 3.0]), "b": torch.tensor(2.0)},
          "opt": {"mu": torch.tensor([0.5, 0.5]),
                  "nu": torch.tensor([4.0, 0.0])},
          "steps": torch.tensor(10, dtype=torch.int32)}
    s2 = {"params": {"w": torch.tensor([3.0, 5.0]), "b": torch.tensor(6.0)},
          "opt": {"mu": torch.tensor([1.5, 0.5]),
                  "nu": torch.tensor([0.0, 2.0])},
          "steps": torch.tensor(10, dtype=torch.int32)}
    merged = average_states([s1, s2])
    assert merged["params"]["w"].tolist() == [2.0, 4.0]
    assert merged["params"]["b"].item() == 4.0
    assert merged["opt"]["mu"].tolist() == [1.0, 0.5]
    assert merged["opt"]["nu"].tolist() == [2.0, 1.0]
    assert merged["steps"].item() == 10
    assert merged["steps"].dtype == torch.int32
    assert merged["params"]["w"].dtype == torch.float32


def test_average_states_integer_counters_exact_past_float32_precision():
    """Equal counters above 2^24 (where float32 rounds odd integers) merge
    exactly, as in the reference; disagreeing ones floor like numpy's."""
    big = 2 ** 24 + 1
    for values in ([big, big], [big, big + 2], [-3, -4], [2 ** 30 + 1] * 3):
        ref = jax_learners.average_states(
            [{"steps": np.int32(v)} for v in values])
        port = average_states(
            [{"steps": torch.tensor(v, dtype=torch.int32)} for v in values])
        assert port["steps"].dtype == torch.int32
        assert int(port["steps"]) == int(ref["steps"]) \
            == sum(values) // len(values)


def test_average_states_single_state_is_identity():
    """One replica: no float round-trip — the exact same tree comes back
    (what makes the 1-replica configuration bit-equivalent)."""
    state = {"w": torch.tensor([1.0, 2.0]),
             "steps": torch.tensor(7, dtype=torch.int32)}
    assert average_states([state]) is state
    with pytest.raises(ValueError):
        average_states([])


def _jax_dqn_learner(batches, seed=0):
    cfg = jax_dqn.DQNConfig(**SMALL)
    return jax_dqn.make_learner(jax_spec(JaxCatch(seed=0)), cfg,
                                iter(batches), jax.random.key(seed))


def test_average_states_on_real_learner_states_equals_reference():
    """Two reference DQN learners diverge on different batch orders; their
    states carried across by ``state_from_jax`` average to the reference's
    average exactly, Adam's moments and step counters included."""
    jb = _batches(4, port=False)
    l1 = _jax_dqn_learner(jb)
    l2 = _jax_dqn_learner(list(reversed(jb)))
    for _ in range(4):
        l1.step()
        l2.step()
    ref = jax_learners.average_states([l1.state, l2.state])
    port = average_states([state_from_jax(l1.state, CPU),
                           state_from_jax(l2.state, CPU)])
    _assert_equal_to_reference(port.params, ref.params)
    _assert_equal_to_reference(port.target_params, ref.target_params)
    _assert_equal_to_reference(tuple(port.opt_state), tuple(ref.opt_state))
    _assert_equal_to_reference(port.steps, ref.steps)


def test_average_states_keeps_leaves_on_their_device():
    states = [{"w": torch.full((3,), float(i))} for i in range(2)]
    merged = average_states(states)
    assert merged["w"].device == states[0]["w"].device
    assert merged["w"].tolist() == [0.5, 0.5, 0.5]


# ------------------------------------------------------- parameter server
def _ps_state(x):
    return {"w": torch.tensor(x, dtype=torch.float32)}


def test_parameter_server_barrier_merges_and_counts_rounds():
    server = ParameterServer(num_replicas=2, average_period=5)
    results = {}

    def contribute(rid, value):
        results[rid] = server.sync(rid, _ps_state(value))

    t = threading.Thread(target=contribute, args=(0, 1.0))
    t.start()
    contribute(1, 3.0)
    t.join(5)
    assert not t.is_alive()
    assert results[0]["w"].item() == results[1]["w"].item() == 2.0
    assert server.rounds == 1
    assert server.stats() == {"num_replicas": 2, "average_period": 5,
                              "rounds": 1}


def test_parameter_server_stop_releases_blocked_sync():
    """A half-filled round must never wedge teardown: stop() wakes the
    blocked replica with None (it keeps its own state and exits)."""
    server = ParameterServer(num_replicas=2, average_period=5)
    out = {}

    def blocked():
        out["result"] = server.sync(0, _ps_state(1.0))

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.2)
    assert t.is_alive()
    server.stop()
    t.join(5)
    assert not t.is_alive()
    assert out["result"] is None
    assert server.rounds == 0
    assert server.sync(1, _ps_state(2.0)) is None   # stopped for good


def test_parameter_server_rejects_bad_args():
    with pytest.raises(ValueError):
        ParameterServer(num_replicas=0, average_period=5)
    with pytest.raises(ValueError):
        ParameterServer(num_replicas=2, average_period=0)
    with pytest.raises(ValueError):
        ParameterServer(num_replicas=2, average_period=5, min_quorum=1)
    with pytest.raises(ValueError):
        ParameterServer(num_replicas=2, average_period=5,
                        barrier_timeout_s=1.0, min_quorum=3)
    server = ParameterServer(num_replicas=2, average_period=5)
    with pytest.raises(ValueError):
        server.sync(2, {})


def test_param_server_quorum_merges_on_timeout():
    ps = ParameterServer(2, 1, barrier_timeout_s=0.15, min_quorum=1)
    t0 = time.monotonic()
    merged = ps.sync(0, _ps_state(2.0))   # replica 1 never shows up
    elapsed = time.monotonic() - t0
    assert merged["w"].item() == 2.0
    assert elapsed >= 0.15
    stats = ps.stats()
    assert stats["rounds"] == 1
    assert stats["quorum_merges"] == 1
    assert stats["min_quorum"] == 1


def test_param_server_quorum_full_round_merges_immediately():
    ps = ParameterServer(2, 1, barrier_timeout_s=5.0, min_quorum=1)
    results = {}

    def contribute(rid, x):
        results[rid] = ps.sync(rid, _ps_state(x))

    t = threading.Thread(target=contribute, args=(0, 1.0))
    t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    contribute(1, 3.0)
    t.join(JOIN_S)
    # the full round closed on arrival, NOT after the 5s timeout
    assert time.monotonic() - t0 < 1.0
    assert results[0]["w"].item() == results[1]["w"].item() == 2.0
    assert ps.stats()["quorum_merges"] == 0


def test_param_server_late_replica_adopts_instead_of_remerging():
    """A straggler that missed a merge ADOPTS the blend instead of opening
    a lone round with its stale state."""
    ps = ParameterServer(2, 1, barrier_timeout_s=0.1, min_quorum=1)
    assert ps.sync(0, _ps_state(1.0))["w"].item() == 1.0
    assert ps.sync(1, _ps_state(9.0))["w"].item() == 1.0
    assert ps.rounds == 1
    assert ps.stats()["stale_adoptions"] == 1
    assert ps.merged["w"].item() == 1.0
    # next period it contributes fresh work
    assert ps.sync(1, _ps_state(5.0))["w"].item() == 5.0
    assert ps.rounds == 2


def test_param_server_invalidate_withdraws_parked_contribution():
    ps = ParameterServer(2, 1, barrier_timeout_s=30.0, min_quorum=2)
    out = {}

    def parked():
        out["r"] = ps.sync(0, _ps_state(666.0))   # pre-kill stale state

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.1)
    ps.invalidate(0)
    t.join(JOIN_S)
    assert not t.is_alive()
    assert out["r"] is None            # withdrawn, not adopted
    assert ps.rounds == 0
    results = {}

    def contribute(rid, x):
        results[rid] = ps.sync(rid, _ps_state(x))

    threads = [threading.Thread(target=contribute, args=(i, x))
               for i, x in ((0, 1.0), (1, 3.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert results[0]["w"].item() == results[1]["w"].item() == 2.0


# ------------------------------------------------------------- parity net
def test_one_replica_multi_learner_matches_plain_learner():
    """On IDENTICAL batches from the same seed, a 1-replica MultiLearner and
    the plain learner produce bit-identical params, target params, Adam
    state and served variables."""
    batches = _batches(12)
    plain = _dqn_builder(seed=3).make_learner(iter(list(batches)))
    multi = MultiLearner([_dqn_builder(seed=3).make_learner(
        iter(list(batches)))], average_period=4)
    for _ in range(12):
        plain.step()
        multi.step()
    _assert_states_equal(multi.state.params, plain.state.params)
    _assert_states_equal(multi.state.target_params,
                         plain.state.target_params)
    _assert_states_equal(tuple(multi.state.opt_state),
                         tuple(plain.state.opt_state))
    assert int(multi.state.steps) == int(plain.state.steps) == 12
    _assert_states_equal(multi.get_variables(("policy",))[0],
                         plain.get_variables(("policy",))[0])
    assert multi.param_server.rounds == 3


def test_two_replicas_match_the_reference_multi_learner():
    """Two replicas from the reference's init, each on its own fixed batch
    stream, 3 averaging rounds of period 5 (30 sequential steps): params,
    target params and Adam's state stay within the stated tolerance of the
    reference's MultiLearner, and the step counters are equal."""
    period, rounds = 5, 3
    streams = [_batches(period * rounds, seed=s) for s in (1, 2)]
    ref = jax_learners.MultiLearner(
        [_jax_dqn_learner(_batches(period * rounds, seed=s, port=False))
         for s in (1, 2)], average_period=period)
    replicas = []
    for stream, ref_replica in zip(streams, ref.replicas):
        learner = _dqn_builder().make_learner(iter(stream))
        learner.state = state_from_jax(ref_replica.state, CPU)
        replicas.append(learner)
    port = MultiLearner(replicas, average_period=period)
    for _ in range(2 * period * rounds):
        ref.step()
        port.step()
    assert port.param_server.rounds == ref.param_server.rounds == rounds
    for replica, ref_replica in zip(port.replicas, ref.replicas):
        state, ref_state = replica.state, ref_replica.state
        _assert_close_to_reference(state.params, ref_state.params)
        _assert_close_to_reference(state.target_params,
                                   ref_state.target_params)
        opt, ref_opt = state.opt_state, ref_state.opt_state
        assert int(opt.step) == int(ref_opt.step) == period * rounds
        _assert_close_to_reference(opt.mu, ref_opt.mu)
        _assert_close_to_reference(opt.nu, ref_opt.nu)
        assert int(state.steps) == int(ref_state.steps) == period * rounds
    # the served variables are the merged params, as numpy
    (served,) = port.get_variables(("policy",))
    _assert_close_to_reference(served, ref.get_variables(("policy",))[0])


def test_run_experiment_one_replica_parity_with_single_learner_path():
    """num_learner_replicas=1 routes through the multi-learner machinery
    and lands on exactly the same params as the default path."""
    from repro_torch.experiments import run_experiment

    base = make_dqn_catch_config(
        seed=0, min_replay_size=16, samples_per_insert=0.0, batch_size=16,
        prioritized=False, num_episodes=15, eval_episodes=0)
    plain = run_experiment(base)
    multi = run_experiment(dataclasses.replace(
        base, num_learner_replicas=1, learner_average_period=7))
    assert plain.learner_steps == multi.learner_steps > 0
    _assert_states_equal(multi.learner.state.params,
                         plain.learner.state.params)
    _assert_states_equal(tuple(multi.learner.state.opt_state),
                         tuple(plain.learner.state.opt_state))
    assert multi.extras["learners"]["num_replicas"] == 1
    assert multi.extras["learners"]["per_replica_steps"] == \
        [multi.learner_steps]
    assert "learners" not in plain.extras


def test_sequential_round_robin_averages_every_period():
    """2 replicas, period 3: after 6 facade steps (one full cycle of
    3-per-replica) every replica holds the merged state; counts and rounds
    are reported in stats()."""
    multi = MultiLearner(
        [_dqn_builder(seed=0).make_learner(iter(_batches(9, seed=1))),
         _dqn_builder(seed=0).make_learner(iter(_batches(9, seed=2)))],
        average_period=3)
    for _ in range(5):
        multi.step()
    assert multi.param_server.rounds == 0     # mid-cycle: no merge yet
    multi.step()                              # completes 3 steps per replica
    assert multi.param_server.rounds == 1
    r0, r1 = multi.replicas
    _assert_states_equal(r0.state.params, r1.state.params)
    assert multi.stats() == {"num_replicas": 2, "average_period": 3,
                             "rounds": 1, "per_replica_steps": [3, 3]}


def test_replica_worker_rejects_async_until_ported():
    learner = _dqn_builder().make_learner(iter(()))
    with pytest.raises(NotImplementedError, match="slice 7b"):
        LearnerReplicaWorker(learner, sync_mode="async")
    with pytest.raises(ValueError):
        LearnerReplicaWorker(learner, sync_mode="gossip")


# ------------------------------------------------------ program placement
def test_make_distributed_agent_places_replica_nodes_with_shard_affinity():
    from repro_torch.agents.builders import make_distributed_agent

    builder = DQNCatchBuilderFactory(samples_per_insert=0.0)(_spec())
    dist = make_distributed_agent(builder, catch_env_factory, num_actors=1,
                                  seed=0, num_learner_replicas=2,
                                  learner_average_period=10,
                                  prefetch_size=2)
    try:
        names = {n.name for n in dist.program.nodes}
        assert {"learner", "learner/param_server", "learner/replica_0",
                "learner/replica_1", "replay/shard_0",
                "replay/shard_1"} <= names
        assert isinstance(dist.learner, MultiLearner)
        # shard affinity: replica i consumes exactly replay/shard_i
        for i in range(2):
            worker = dist.program.resolve(f"learner/replica_{i}")
            assert worker.shard is dist.table.shards[i]
        # the learner endpoint's declared interface is unchanged
        assert dist.program.node("learner").interface == ("get_variables",)
    finally:
        dist.stop()
    # replica teardown closed the per-replica prefetching datasets
    assert all(d.closed for d in dist.datasets)


def test_mismatched_shards_and_replicas_rejected():
    from repro_torch.agents.builders import make_agent

    builder = DQNCatchBuilderFactory()(_spec())
    with pytest.raises(ValueError, match="shard affinity"):
        make_agent(builder, num_learner_replicas=2, num_replay_shards=3)


def test_offline_builder_rejects_explicit_replicas():
    """An offline builder asked for replicas must fail loudly, not silently
    downgrade to one plain learner."""
    from repro_torch.agents.bc import BCBuilder, BCConfig
    from repro_torch.agents.builders import make_agent

    items = [types.Transition(np.zeros((10, 5), np.float32), np.int32(i % 3),
                              np.float32(0.0), np.float32(1.0),
                              np.zeros((10, 5), np.float32))
             for i in range(8)]
    builder = BCBuilder(_spec(), items, BCConfig(batch_size=4), seed=0,
                        device=CPU)
    with pytest.raises(ValueError, match="offline"):
        make_agent(builder, num_learner_replicas=2)


def test_consuming_queue_builder_runs_multi_learner_without_hanging():
    """IMPALA's replay is a consuming Fifo queue: the lockstep schedule
    gates each sequential replica step on THAT replica's shard."""
    from repro_torch.agents.impala import IMPALABuilder, IMPALAConfig
    from repro_torch.experiments import ExperimentConfig, run_experiment

    config = ExperimentConfig(
        builder_factory=lambda spec: IMPALABuilder(
            spec, IMPALAConfig(sequence_length=3, batch_size=2), seed=0,
            device=CPU),
        environment_factory=lambda s: Catch(seed=s),
        seed=0, num_episodes=12, eval_episodes=0,
        num_learner_replicas=2, learner_average_period=2)
    result = run_experiment(config)
    assert result.learner_steps > 0
    assert result.extras["learners"]["num_replicas"] == 2


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_of_merged_state(tmp_path):
    """Checkpointing sees ONE logical learner: the saved state is the
    merged view, and restoring broadcasts it to every replica."""
    from repro_torch.checkpoint import Checkpointer

    multi = MultiLearner(
        [_dqn_builder(seed=0).make_learner(iter(_batches(4, seed=1))),
         _dqn_builder(seed=0).make_learner(iter(_batches(4, seed=2)))],
        average_period=100)   # no merge before the save: replicas diverged
    for _ in range(8):
        multi.step()
    merged = multi.state
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(merged, 4)

    fresh = MultiLearner(
        [_dqn_builder(seed=9).make_learner(iter(_batches(1))),
         _dqn_builder(seed=9).make_learner(iter(_batches(1)))],
        average_period=100)
    restored, meta = ckpt.restore(fresh.state)
    assert meta["step"] == 4
    fresh.state = restored
    for replica in fresh.replicas:
        _assert_states_equal(replica.state.params, merged.params)
        _assert_states_equal(tuple(replica.state.opt_state),
                             tuple(merged.opt_state))


# ----------------------------------------------------- prefetch teardown
def test_sequential_distributed_runs_do_not_accumulate_prefetch_threads():
    """Two back-to-back multi-learner runs with prefetching leave no
    sampler threads behind."""
    from repro_torch.experiments import run_distributed_experiment

    def live_prefetch_threads():
        return [t for t in threading.enumerate()
                if t.name.startswith("prefetch_") and t.is_alive()]

    config = make_dqn_catch_config(
        seed=0, samples_per_insert=0.0, eval_episodes=0,
        num_learner_replicas=2, learner_average_period=5, prefetch_size=2)
    for _ in range(2):
        result = run_distributed_experiment(config, num_actors=1,
                                            max_actor_steps=150,
                                            timeout_s=60)
        assert result.learner_steps >= 0
    deadline = time.time() + 5
    while live_prefetch_threads() and time.time() < deadline:
        time.sleep(0.1)
    assert not live_prefetch_threads()
