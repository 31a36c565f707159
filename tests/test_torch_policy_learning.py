"""The transformer policy's training half against the JAX package: the
sequence double-DQN learner after 1 and 10 steps from the same
``LearnerState`` on the same batches, its route through the flash
attention Function as it runs on the card, greedy actions of
``BatchedWindowedPolicyActor`` at epsilon 0, and ``TransformerPolicyBuilder``
(options, replay, adder, actors, the vectorized loop).

Tolerances, stated where used: losses and priorities within 1e-5; Adam's
moments (the gradients and their squares) within 1e-5 of each leaf's
largest magnitude after 1 and 10 steps (the reference's jnp attention and
the plain version sum in other orders; the largest seen is 4.8e-6).
Params and target params within 1e-4, a tenth of one Adam step at the
learning rate 1e-3: a gradient near Adam's eps (1e-8) moves its weight by
lr g / (|g| + eps), so summation-order noise of 1e-10 in such a gradient
moves the weight by up to 2.2e-5 (seen at a gradient of 1.4e-8, 6e-5 of
its leaf's largest weight).  After one step the test also checks that
every weight further than 1e-5 of its leaf's largest magnitude from the
reference's has a gradient below 100 eps.  Actions equal exactly.  On the
CPU the flash attention's plain version stands in for the kernel.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import replay as jax_replay
from repro.core import make_environment_spec as jax_spec
from repro.core.variable import VariableClient as JaxVariableClient
from repro.envs import Catch as JaxCatch
from repro.policies import TransformerPolicyBuilder as JaxBuilder
from repro.policies import TransformerPolicyConfig as JaxConfig
from repro.policies import learning as jax_learning
from repro_torch import replay, tree
from repro_torch.agents.builders import make_agent
from repro_torch.core import (VariableClient, VectorizedEnvironmentLoop,
                              make_environment_spec)
from repro_torch.envs import Catch, VectorEnv
from repro_torch.kernels import ops, ref
from repro_torch.policies import (TransformerPolicyBuilder,
                                  TransformerPolicyConfig, learning, network)
from repro_torch.policies.actors import BatchedWindowedPolicyActor

CPU = "cpu"
LOSS_TOL = 1e-5
LEAF_TOL = 1e-5
PARAM_ATOL = 1e-4
ADAM_EPS = 1e-8
OBS_SHAPE = (10, 5)

CONFIGS = {
    # the reference acceptance's preset (tests/conftest.py)
    "preset": dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                   head_dim=16, d_ff=64, window=4, sequence_length=10,
                   period=10, batch_size=8, min_replay_size=10,
                   samples_per_insert=0.0, target_update_period=3),
    # two layers, grouped heads, the default window against T 16
    "two_layers": dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                       head_dim=16, d_ff=64, window=8, sequence_length=16,
                       batch_size=6, target_update_period=4),
}


def _configs(name, **overrides):
    kw = dict(CONFIGS[name], **overrides)
    return (TransformerPolicyConfig(backend="grouped", **kw),
            JaxConfig(backend="jnp", **kw))


def _sequences(seed, batch, T):
    """Replayed Catch windows as the SequenceAdder writes them: boards,
    actions, rewards at episode ends, discounts, start-of-episode flags
    (some rows mid-episode) and the padding mask."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(2, T + 1, batch)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    obs = np.zeros((batch, T) + OBS_SHAPE, np.float32)
    rows, steps = np.meshgrid(np.arange(batch), np.arange(T), indexing="ij")
    obs[rows, steps, rng.randint(0, 9, (batch, T)),
        rng.randint(0, 5, (batch, T))] = 1.0
    obs[rows, steps, 9, rng.randint(0, 5, (batch, T))] = 1.0
    obs *= mask[..., None, None]
    ended = np.zeros((batch, T), bool)
    ended[np.arange(batch), lengths - 1] = rng.rand(batch) < 0.6
    starts = np.zeros((batch, T), bool)
    starts[:, 0] = rng.rand(batch) < 0.5
    return {
        "observation": obs,
        "action": (rng.randint(0, 3, (batch, T)) * mask).astype(np.int32),
        "reward": np.where(ended, rng.choice([-1.0, 1.0], (batch, T)), 0.0
                           ).astype(np.float32),
        "discount": (mask * ~ended).astype(np.float32),
        "start_of_episode": starts,
        "mask": mask,
    }


def _samples(steps, cfg, port):
    lib = replay if port else jax_replay
    for i in range(steps):
        data = _sequences(i, cfg.batch_size, cfg.sequence_length)
        rng = np.random.RandomState(50 + i)
        keys = np.arange(cfg.batch_size, dtype=np.int64) + i * cfg.batch_size
        yield lib.SampleInfo(keys, rng.rand(cfg.batch_size) * 0.01 + 1e-4), \
            data


def _learners(name, steps):
    cfg, jcfg = _configs(name)
    spec = make_environment_spec(Catch(seed=0))
    jspec = jax_spec(JaxCatch(seed=0))
    sent, jsent = [], []
    ref_learner = jax_learning.make_learner(
        jspec, jcfg, (jax_replay.ReplaySample(*s)
                      for s in _samples(steps, cfg, port=False)),
        jax.random.key(0), priority_update_cb=lambda k, p: jsent.append(
            (k, np.asarray(p))))
    port = learning.make_learner(
        spec, cfg, (replay.ReplaySample(*s)
                    for s in _samples(steps, cfg, port=True)),
        torch.Generator().manual_seed(0),
        priority_update_cb=lambda k, p: sent.append((k, p)), device=CPU)
    port.state = learning.state_from_jax(
        jax.tree.map(np.asarray, ref_learner.state), CPU)
    return ref_learner, port, jsent, sent


def _pairs(port_state, ref_state):
    """{field: (port tree, reference tree)}, the reference brought to the
    port's layout by ``state_from_jax``."""
    ref_state = learning.state_from_jax(jax.tree.map(np.asarray, ref_state),
                                        CPU)
    return {"params": (port_state.params, ref_state.params),
            "target_params": (port_state.target_params,
                              ref_state.target_params),
            "mu": (port_state.opt_state.mu, ref_state.opt_state.mu),
            "nu": (port_state.opt_state.nu, ref_state.opt_state.nu)}


def _leaf_errors(port_state, ref_state, absolute=False):
    """max |d| (over max |ref| unless ``absolute``) per field, worst leaf."""
    errors = {}
    for field, (a, b) in _pairs(port_state, ref_state).items():
        errors[field] = max(
            float((x - y).abs().max()) / (
                1.0 if absolute else max(float(y.abs().max()), 1e-30))
            for x, y in zip(tree.leaves(a), tree.leaves(b)))
    return errors


def test_state_from_jax_carries_the_reference_learner_state():
    """The port's learner from the reference's LearnerState: every leaf of
    params, target params and Adam's moments, Adam's step and the counter,
    with the stacked layers split into the port's per-layer dicts."""
    ref_learner, port, _, _ = _learners("two_layers", 0)
    state = port.state
    assert len(state.params["blocks"]) == 2
    ref_leaves = jax.tree.leaves(ref_learner.state.params)
    assert len(tree.leaves(state.params)) == \
        len(ref_leaves) - 9 + 9 * 2       # 9 stacked block leaves, 2 layers
    np.testing.assert_array_equal(
        state.params["blocks"][1]["attn"]["wq"].numpy(),
        np.asarray(ref_learner.state.params["blocks"]["attn"]["wq"][1]))
    assert all(float(e) == 0.0 for e in _leaf_errors(
        state, ref_learner.state).values())
    assert state.steps.dtype == torch.int32 and int(state.steps) == 0
    assert state.opt_state.step.dtype == torch.int32
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree.leaves(state.params), tree.leaves(state.target_params)))


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", CONFIGS)
def test_learner_steps_match_reference(name, steps):
    """Sequence double-DQN: the loss and the max/mean |td| priorities of
    every step, then params, target params (copied every few steps) and
    Adam's moments per leaf, Adam's step and the counter."""
    ref_learner, port, jsent, sent = _learners(name, steps)
    for _ in range(steps):
        ref_metrics, port_metrics = ref_learner.step(), port.step()
        np.testing.assert_allclose(port_metrics["loss"], ref_metrics["loss"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    assert len(sent) == len(jsent) == steps
    for (keys, prio), (jkeys, jprio) in zip(sent, jsent):
        np.testing.assert_array_equal(keys, jkeys)
        assert prio.shape == jprio.shape
        np.testing.assert_allclose(prio, jprio, atol=LOSS_TOL, rtol=LOSS_TOL)
    errors = _leaf_errors(port.state, ref_learner.state)
    assert max(errors["mu"], errors["nu"]) <= LEAF_TOL, errors
    absolute = _leaf_errors(port.state, ref_learner.state, absolute=True)
    assert max(absolute["params"], absolute["target_params"]) <= \
        PARAM_ATOL, absolute
    if steps == 1:
        # after one step mu = 0.1 g: the weights that differ by more than
        # LEAF_TOL of their leaf are those with a gradient near eps
        pairs = _pairs(port.state, ref_learner.state)
        for x, y, mu in zip(*(tree.leaves(t) for t in (
                *pairs["params"], pairs["mu"][1]))):
            far = (x - y).abs() > LEAF_TOL * y.abs().max()
            assert bool((mu[far].abs() / 0.1 < 100 * ADAM_EPS).all())
    assert int(port.state.opt_state.step) == steps
    assert int(port.state.steps) == int(ref_learner.state.steps) == steps


def test_learner_masks_truncated_context_and_padding():
    """Rows that start mid-episode drop their first window - 1 steps, and
    padding drops out: a batch whose every valid position is masked has
    zero loss and zero priorities, as the reference's."""
    cfg, jcfg = _configs("preset")
    data = _sequences(0, cfg.batch_size, cfg.sequence_length)
    data["start_of_episode"][:] = False
    data["mask"][:, cfg.window - 1:] = 0.0
    info = (np.arange(cfg.batch_size, dtype=np.int64),
            np.full(cfg.batch_size, 0.01))
    port = learning.make_learner(
        make_environment_spec(Catch()), cfg,
        iter([replay.ReplaySample(replay.SampleInfo(*info), data)]),
        torch.Generator().manual_seed(0), device=CPU)
    jlearner = jax_learning.make_learner(
        jax_spec(JaxCatch()), jcfg,
        iter([jax_replay.ReplaySample(jax_replay.SampleInfo(*info), data)]),
        jax.random.key(0))
    assert port.step()["loss"] == jlearner.step()["loss"] == 0.0


class _PlainFlash:
    """The flash kernel's stand-in on the CPU: the plain forward, counted
    like a launch."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q, k, v, causal, window):
        self.launches += 1
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def test_learner_runs_flash_attention_as_on_the_card(monkeypatch):
    """Dispatched as on the card: each step's online pass goes through
    ``FlashAttentionFunction`` and the target pass through the kernel
    alone, one launch per layer each; the step's results equal the plain
    route's exactly."""
    from repro_torch.kernels import flash_attention as flash_module
    name = "two_layers"
    _, port, _, plain_sent = _learners(name, 2)
    plain = [port.step() for _ in range(2)]
    _, routed, _, routed_sent = _learners(name, 2)
    flash = _PlainFlash()
    functions = []
    original = flash_module.FlashAttentionFunction.apply

    def apply(*args):
        functions.append(args[0].requires_grad)
        return original(*args)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_flash", flash)
    monkeypatch.setattr(flash_module, "flash_attention", flash)
    monkeypatch.setattr(ops.FlashAttentionFunction, "apply", apply)
    metrics = [routed.step() for _ in range(2)]
    layers = CONFIGS[name]["num_layers"]
    assert flash.launches == 2 * 2 * layers      # online + target, 2 steps
    assert functions == [True] * (2 * layers)    # the online passes only
    assert [m["loss"] for m in metrics] == [m["loss"] for m in plain]
    for (_, a), (_, b) in zip(routed_sent, plain_sent):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tree.leaves(routed.state), tree.leaves(port.state)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------------------- acting
class _Static:
    def __init__(self, params):
        self.params = params

    def get_variables(self, names=("policy",)):
        return [self.params for _ in names]


@pytest.mark.parametrize("name", CONFIGS)
def test_batched_windowed_actor_greedy_actions_match_reference(name):
    """Four Catch envs through one engine call a tick at epsilon 0, for
    three episodes each (prefill at each start, decode after, the ring
    wrapping past the window): the same actions as the reference's
    BatchedWindowedPolicyActor on the same weights.  The port's client
    hands out numpy trees, as a learner's does."""
    cfg, jcfg = _configs(name, epsilon=0.0)
    spec = make_environment_spec(Catch(seed=0))
    builder = TransformerPolicyBuilder(spec, cfg, seed=0, device=CPU)
    jbuilder = JaxBuilder(jax_spec(JaxCatch(seed=0)), jcfg, seed=0)
    jparams = jbuilder.make_learner(iter(())).state.params
    params = tree.map(lambda x: x.numpy(), network.params_from_jax(
        jax.tree.map(np.asarray, jparams), CPU))
    n = 4
    actor = builder.make_batched_actor(
        builder.make_policy(evaluation=True), VariableClient(_Static(params)),
        [None] * n)
    jactor = jbuilder.make_batched_actor(
        jbuilder.make_policy(evaluation=True),
        JaxVariableClient(_Static(jparams)), [None] * n)
    assert isinstance(actor, BatchedWindowedPolicyActor)
    envs = [Catch(seed=i) for i in range(n)]
    steps = [env.reset() for env in envs]
    for i, ts in enumerate(steps):
        actor.observe_first(ts, env_id=i)
        jactor.observe_first(ts, env_id=i)
    for _ in range(27):                    # three 9-step episodes each
        obs = np.stack([ts.observation for ts in steps])
        actions = actor.select_action(obs)
        np.testing.assert_array_equal(actions, jactor.select_action(obs))
        for i, env in enumerate(envs):
            steps[i] = env.step(actions[i])
            if steps[i].last():
                steps[i] = env.reset()
                actor.observe_first(steps[i], env_id=i)
                jactor.observe_first(steps[i], env_id=i)
    stats = actor._engine.stats()
    assert stats["decode_rows"] > stats["prefill_rows"] == 3 * n


# ------------------------------------------------------------------ builder
def test_builder_matches_reference_builder():
    """Options, config, replay table and limiter, and the adder as the
    reference builds them; the windowed actors on engines over the
    builder's device; the inference hooks raise until the distributed
    programs are ported."""
    for spi in (0.0, 4.0):
        cfg, jcfg = _configs("preset", samples_per_insert=spi)
        builder = TransformerPolicyBuilder(make_environment_spec(Catch()),
                                           cfg, seed=0, device=CPU)
        jbuilder = JaxBuilder(jax_spec(JaxCatch()), jcfg, seed=0)
        assert dataclasses.asdict(builder.options) == \
            dataclasses.asdict(jbuilder.options)
        assert builder.arch == network.make_arch(cfg, 3)
        table, jtable = builder.make_replay(), jbuilder.make_replay()
        assert type(table.rate_limiter).__name__ == \
            type(jtable.rate_limiter).__name__
        for key, value in vars(jtable.rate_limiter).items():
            if isinstance(value, (int, float)):
                assert getattr(table.rate_limiter, key) == value, key
        assert (table.capacity, type(table.selector).__name__) == \
            (jtable.capacity, type(jtable.selector).__name__)
        adder, jadder = builder.make_adder(table), jbuilder.make_adder(jtable)
        assert (adder.length, adder.period, adder.default_priority) == \
            (jadder.length, jadder.period, jadder.default_priority)
    policy = builder.make_policy()
    assert policy.epsilon == cfg.epsilon and policy.backend == "grouped"
    assert builder.make_policy(evaluation=True).epsilon == 0.0
    actor = builder.make_actor(policy, None, adder)
    assert actor._engine.device == torch.device(CPU)
    assert actor._engine.pool.num_slots == 1
    with pytest.raises(NotImplementedError, match="slice 7"):
        builder.make_inference_server(None, max_batch_size=4,
                                      max_wait_ms=1.0, update_period=1)
    with pytest.raises(NotImplementedError, match="slice 7"):
        builder.make_inference_actor(None, adder=adder)


def test_vectorized_agent_trains_through_the_loop():
    """make_agent with three envs: a BatchedWindowedPolicyActor over a
    VectorEnv, one sequence per Catch episode into replay, and learner
    steps through the loop."""
    cfg, _ = _configs("preset")
    builder = TransformerPolicyBuilder(make_environment_spec(Catch()), cfg,
                                       seed=0, device=CPU)
    agent = make_agent(builder, num_envs=3)
    assert isinstance(agent.actor, BatchedWindowedPolicyActor)
    loop = VectorizedEnvironmentLoop(VectorEnv(lambda s: Catch(seed=s), 3),
                                     agent)
    results = loop.run(num_episodes=30)
    assert len(results) >= 30
    assert agent.table.size() >= 10
    assert int(agent.learner.state.steps) > 0
    assert np.isfinite(agent.learner.metrics["loss"])
