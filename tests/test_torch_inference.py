"""repro_torch.core.inference against the JAX package: the batched
``InferenceServer`` at epsilon 0 answers the reference server's greedy
actions from the same params, pads to the same power-of-two buckets (the
same stats), refuses recurrent policies, and its client actor speaks the
reference's protocol; then the builders' inference hooks and the
transformer policy's server on the CPU."""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.agents import dqn as jax_dqn
from repro.core import VariableServer as JaxVariableServer
from repro.core import make_environment_spec as jax_spec
from repro.core.inference import InferenceServer as JaxInferenceServer
from repro.envs import Catch as JaxCatch
from repro_torch import tree
from repro_torch.agents import dqn
from repro_torch.core import (INFERENCE_INTERFACE, InferenceClientActor,
                              InferenceServer, VariableServer,
                              make_environment_spec)
from repro_torch.core.inference import policy_is_feed_forward
from repro_torch.distributed.courier import CourierClosed
from repro_torch.envs import Catch
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _boards(n, seed):
    """n Catch boards: a ball somewhere, the paddle on the last row."""
    rng = np.random.RandomState(seed)
    obs = np.zeros((n, 10, 5), np.float32)
    obs[np.arange(n), rng.randint(0, 9, n), rng.randint(0, 5, n)] = 1.0
    obs[np.arange(n), 9, rng.randint(0, 5, n)] = 1.0
    return obs


def _servers(max_batch_size=8, epsilon=0.0):
    """The reference's server and the port's over the same DQN params."""
    cfg = dqn.DQNConfig(epsilon=epsilon)
    jcfg = jax_dqn.DQNConfig(epsilon=epsilon)
    init, *_ = jax_dqn.make_q_network(jax_spec(JaxCatch(seed=0)), jcfg)
    params = init(jax.random.key(5))
    ref = JaxInferenceServer(
        jax_dqn.make_behavior_policy(jax_spec(JaxCatch(seed=0)), jcfg),
        JaxVariableServer(policy=params), max_batch_size=max_batch_size,
        max_wait_ms=5.0)
    port = InferenceServer(
        dqn.make_behavior_policy(make_environment_spec(Catch(seed=0)), cfg),
        VariableServer(policy=jax.tree.map(np.asarray, params)),
        max_batch_size=max_batch_size, max_wait_ms=5.0, device=CPU)
    return ref, port


def test_greedy_actions_equal_reference():
    ref, port = _servers()
    try:
        for n, seed in ((1, 0), (3, 1), (8, 2), (5, 3)):
            obs = _boards(n, seed)
            expected = ref.select_action(obs)
            got = port.select_action(obs)
            assert got.dtype == expected.dtype == np.int32
            np.testing.assert_array_equal(got, expected)
    finally:
        ref.stop()
        port.stop()


def test_padding_stats_equal_reference():
    """One request at a time (the window closes on its deadline): each pass
    pads to the next power of two, capped at max_batch_size."""
    ref, port = _servers(max_batch_size=6)
    try:
        for n in (1, 3, 5, 6, 2):
            obs = _boards(n, n)
            ref.select_action(obs)
            port.select_action(obs)
        want = {k: v for k, v in ref.stats().items()}
        got = port.stats()
        assert got == want
        assert got["padded_rows"] == 0 + 1 + 1 + 0 + 0
        assert got["batches"] == 5 and got["rows"] == 17
    finally:
        ref.stop()
        port.stop()


def test_concurrent_requests_coalesce_into_one_pass():
    _, port = _servers(max_batch_size=8)
    port._max_wait_s = 1.0   # hold the window open for all four callers
    out = {}
    try:
        def call(i):
            out[i] = port.select_action(_boards(2, i))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        stats = port.stats()
        assert stats["batches"] == 1 and stats["rows"] == 8
        assert stats["avg_rows_per_batch"] == 8.0
        assert all(out[i].shape == (2,) for i in range(4))
    finally:
        port.stop()


def test_exploration_draws_follow_the_batch_counter():
    """The generator is seeded from (rng_seed, batch counter): two servers
    from one seed answer the same requests with the same actions, and at
    epsilon 1 the actions are random draws."""
    answers = []
    for _ in range(2):
        _, port = _servers(max_batch_size=8, epsilon=1.0)
        try:
            answers.append([port.select_action(_boards(8, 0)).tolist()
                            for _ in range(4)])
        finally:
            port.stop()
    assert answers[0] == answers[1]
    assert len({tuple(a) for a in answers[0]}) > 1


def test_stopped_server_raises_courier_closed():
    _, port = _servers()
    port.stop()
    with pytest.raises(CourierClosed):
        port.select_action(_boards(1, 0))
    ref, small = _servers(max_batch_size=2)
    ref.stop()
    try:
        with pytest.raises(ValueError, match="exceeds"):
            small.select_action(_boards(3, 0))
    finally:
        small.stop()


def test_recurrent_policies_are_rejected():
    def recurrent(params, generator, obs, state):
        return obs, state

    def feed_forward(params, generator, obs):
        return obs

    assert not policy_is_feed_forward(recurrent)
    assert policy_is_feed_forward(feed_forward)
    assert policy_is_feed_forward(lambda *args: args)
    with pytest.raises(ValueError, match="recurrent"):
        InferenceServer(recurrent, VariableServer(policy={}), device=CPU)
    assert INFERENCE_INTERFACE == ("select_action", "stats")


class _FakeInference:
    def __init__(self):
        self.calls = []

    def select_action(self, observations):
        self.calls.append(np.asarray(observations).shape)
        return np.arange(len(observations), dtype=np.int32)


class _Adder:
    def __init__(self):
        self.events = []

    def add_first(self, timestep):
        self.events.append("first")

    def add(self, action, timestep):
        self.events.append(int(action))


def test_inference_client_actor_single_and_batched():
    from repro_torch.core.types import restart

    inference = _FakeInference()
    adder = _Adder()
    actor = InferenceClientActor(inference, adder=adder)
    assert actor.select_action(np.zeros((10, 5), np.float32)) == 0
    actor.observe_first(restart(np.zeros((10, 5), np.float32)))
    actor.observe(2, restart(np.zeros((10, 5), np.float32)))
    actor.update()   # a no-op: the server owns the weights
    assert adder.events == ["first", 2]
    batched = InferenceClientActor(inference, adders=[_Adder(), _Adder()],
                                   batched=True)
    assert batched.select_action(np.zeros((2, 10, 5))).tolist() == [0, 1]
    assert inference.calls == [(1, 10, 5), (2, 10, 5)]
    with pytest.raises(ValueError):
        InferenceClientActor(inference, adder=adder, adders=[adder])


def test_default_builder_hooks_give_the_generic_client():
    builder = dqn.DQNBuilder(make_environment_spec(Catch(seed=0)),
                             device=CPU)
    assert builder.make_inference_server(
        None, max_batch_size=4, max_wait_ms=1.0, update_period=1) is None
    assert isinstance(builder.make_inference_actor(_FakeInference(),
                                                   adder=_Adder()),
                      InferenceClientActor)


def test_server_inference_rejects_builders_with_custom_batched_actors():
    """IMPALA's batched actor records behaviour logits a weightless client
    cannot produce: inference='server' is refused at assembly."""
    from repro_torch.agents.builders import make_distributed_agent
    from repro_torch.agents.impala import IMPALABuilder, IMPALAConfig

    builder = IMPALABuilder(make_environment_spec(Catch(seed=0)),
                            IMPALAConfig(sequence_length=3, batch_size=2),
                            device=CPU)
    with pytest.raises(ValueError, match="inference='server'"):
        make_distributed_agent(builder, lambda s: Catch(seed=s),
                               num_actors=1, inference="server")


def test_transformer_inference_server_on_the_builders_device():
    """The transformer builder's server: its engine on the builder's device,
    fed numpy windows, answering one action a row; the client actor keeps
    its windows on the host."""
    from repro_torch.policies import (TransformerInferenceServer,
                                      TransformerPolicyBuilder,
                                      TransformerPolicyConfig)
    from repro_torch.policies.actors import WindowedInferenceClientActor

    cfg = TransformerPolicyConfig(num_layers=1, d_model=32, num_heads=2,
                                  num_kv_heads=1, head_dim=16, d_ff=64,
                                  window=4, backend="grouped")
    builder = TransformerPolicyBuilder(make_environment_spec(Catch(seed=0)),
                                       cfg, device=CPU)
    learner = builder.make_learner(iter(()))
    # a weight refresh invalidates every cache slot: refresh rarely here
    server = builder.make_inference_server(
        learner, max_batch_size=4, max_wait_ms=1.0, update_period=100)
    try:
        assert isinstance(server, TransformerInferenceServer)
        assert server._engine.device == torch.device(CPU)
        assert server._engine.pool.num_slots >= 4
        actor = builder.make_inference_actor(server, adders=[None, None])
        assert isinstance(actor, WindowedInferenceClientActor)
        obs = np.zeros((2, 10, 5), np.float32)
        actions = actor.select_action(obs)
        assert actions.shape == (2,)
        actions = actor.select_action(obs)
        stats = server.stats()
        assert stats["prefill_rows"] == 2 and stats["decode_rows"] == 2
        assert all(isinstance(x, np.ndarray)
                   for x in tree.leaves(learner.get_variables()[0]))
    finally:
        server.stop()
