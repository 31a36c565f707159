"""repro_torch IMPALA against the JAX package: the network's forward pass
with copied weights, the learner step on fixed batches after 1 and 10
steps, the behaviour policy's logits, batched acting, the agent schedule,
the builder contract, and the reference's own learning acceptance on Catch.

Tolerances are stated where they are used: 1e-5 on f32 forward outputs and
losses of order 1; for the learner's params and Adam moments after 1 and 10
steps, atol 1e-6 with rtol 1e-5 (the same f32 math in another summation
order; the largest differences seen are 1.5e-7 on params and 1e-9 on mu,
whose small entries carry the large relative ones).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import common as jax_common
from repro.agents import impala as jax_impala
from repro.core import agent as jax_agent
from repro.core import make_environment_spec as jax_spec
from repro.envs import Catch as JaxCatch
from repro.replay import ReplaySample as JaxReplaySample
from repro.replay import SampleInfo as JaxSampleInfo
import repro_torch.policies  # noqa: F401  (registers TransformerPolicyBuilder)
from repro_torch import tree
from repro_torch.agents import (bc, common, continuous, dqfd, dqn, impala,
                                make_agent, mcts, r2d2, r2d3)
from repro_torch.builders import (AgentBuilder, BuilderOptions,
                                  registered_builders)
from repro_torch.core import (Actor, Agent, EnvironmentLoop, VariableClient,
                              VariableSource, VectorizedEnvironmentLoop,
                              make_environment_spec)
from repro_torch.core.actors import BatchedFeedForwardActor, FeedForwardActor
from repro_torch.envs import (Catch, DeepSea, PendulumSwingup, VectorEnv,
                              split_timestep)
from repro_torch.learners import MultiLearner
from repro_torch.replay import ReplaySample, SampleInfo, ShardedReplay
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
FWD_TOL = 1e-5
LEARNER_ATOL, LEARNER_RTOL = 1e-6, 1e-5


def _spec():
    return make_environment_spec(Catch(seed=0))


def _jax_params(cfg, seed=0):
    init, *_ = jax_impala.make_network(jax_spec(JaxCatch(seed=0)), cfg)
    return init(jax.random.key(seed))


def _batch(cfg, seed):
    """One (B, T) sequence batch as the FIFO queue serves it: Catch-like
    boards, episode ends (discount 0) and zero-padded tails (mask 0)."""
    B, T = cfg.batch_size, cfg.sequence_length
    rng = np.random.RandomState(seed)
    obs = np.zeros((B, T, 10, 5), np.float32)
    rows = np.arange(B)[:, None]
    obs[rows, np.arange(T)[None], rng.randint(0, 10, (B, T)),
        rng.randint(0, 5, (B, T))] = 1.0
    obs[rows, np.arange(T)[None], 9, rng.randint(0, 5, (B, T))] = 1.0
    lengths = rng.randint(1, T + 1, B)
    lengths[: B // 2] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    discount = (rng.rand(B, T) > 0.1).astype(np.float32) * mask
    reward = (rng.randint(-1, 2, (B, T)) * (discount == 0)).astype(np.float32)
    data = {
        "observation": obs * mask[..., None, None],
        "action": (rng.randint(0, 3, (B, T)) * mask).astype(np.int32),
        "reward": reward,
        "discount": discount,
        "start_of_episode": np.zeros((B, T), np.bool_),
        "behavior_logits": (rng.randn(B, T, 3) * mask[..., None]
                            ).astype(np.float32),
        "mask": mask,
    }
    data["start_of_episode"][:, 0] = True
    return data


def _samples(cfg, n, numpy_info):
    B = cfg.batch_size
    for i in range(n):
        info = (np.arange(B, dtype=np.int64) + i * B, np.ones(B))
        data = _batch(cfg, seed=i)
        yield (JaxReplaySample(JaxSampleInfo(*info), data) if numpy_info
               else ReplaySample(SampleInfo(*info), data))


def _assert_tree_close(port, ref, atol, rtol):
    port_leaves = [np.asarray(x) for x in tree.leaves(port)]
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(port_leaves) == len(ref_leaves) > 0
    for a, b in zip(port_leaves, ref_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


# ------------------------------------------------------------------ network
@pytest.mark.parametrize("hidden", [64, 16])
def test_forward_matches_reference_with_copied_params(hidden):
    cfg = impala.IMPALAConfig(hidden=hidden)
    params = _jax_params(cfg, seed=3)
    obs = np.random.RandomState(0).rand(7, 10, 5).astype(np.float32)
    _, apply, _, _ = jax_impala.make_network(jax_spec(JaxCatch()), cfg)
    _, port_apply, _, _ = impala.make_network(_spec(), cfg, device=CPU)
    logits, values = apply(params, obs.reshape(7, -1))
    port_logits, port_values = port_apply(
        impala.params_from_jax(params, device=CPU),
        torch.as_tensor(obs.reshape(7, -1)))
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(logits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(port_values.numpy(), np.asarray(values),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_init_has_the_reference_leaves():
    cfg = impala.IMPALAConfig()
    init, *_ = impala.make_network(_spec(), cfg, device=CPU)
    params = init(torch.Generator().manual_seed(0))
    ref = _jax_params(cfg)
    assert [tuple(x.shape) for x in tree.leaves(params)] == \
        [x.shape for x in jax.tree.leaves(ref)]
    w = params["torso"][0]["w"]
    assert float(w.abs().max()) <= 2 * 50 ** -0.5 + 1e-6   # truncated at 2σ
    assert float(params["torso"][0]["b"].abs().max()) == 0.0
    again = init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                  tree.leaves(again)))


# ------------------------------------------------------------------ learner
def _learners(cfg, n):
    ref = jax_impala.make_learner(jax_spec(JaxCatch()), cfg,
                                  _samples(cfg, n, True), jax.random.key(0))
    port = impala.make_learner(_spec(), cfg, _samples(cfg, n, False),
                               torch.Generator().manual_seed(0), device=CPU)
    port.state = port.state._replace(
        params=impala.params_from_jax(ref.state.params, device=CPU))
    return ref, port


@pytest.mark.parametrize("steps", [1, 10])
def test_learner_steps_match_reference(steps):
    """At the reference's IMPALAConfig defaults (T 20, B 16, hidden 64):
    every metric, the params and Adam's step, mu and nu.  After the first
    step mu = (1 - b1) g, so it checks the (clipped) gradients leaf for
    leaf, and nu = (1 - b2) g^2 their squares."""
    cfg = impala.IMPALAConfig()
    ref, port = _learners(cfg, steps)
    for _ in range(steps):
        ref_metrics, port_metrics = ref.step(), port.step()
        for name in ("loss", "pg_loss", "v_loss", "entropy"):
            np.testing.assert_allclose(port_metrics[name], ref_metrics[name],
                                       atol=FWD_TOL, rtol=FWD_TOL)
        assert port_metrics["learner_steps"] == ref_metrics["learner_steps"]
    _assert_tree_close(port.state.params, ref.state.params, LEARNER_ATOL,
                       LEARNER_RTOL)
    opt, ref_opt = port.state.opt_state, ref.state.opt_state
    assert int(opt.step) == int(ref_opt.step) == steps
    assert opt.step.dtype == torch.int32
    if steps == 1:
        # the gradients themselves, through mu = 0.1 g: f32 tolerance
        _assert_tree_close(tree.map(lambda m: m / 0.1, opt.mu),
                           jax.tree.map(lambda m: m / 0.1, ref_opt.mu),
                           FWD_TOL, FWD_TOL)
    _assert_tree_close(opt.mu, ref_opt.mu, LEARNER_ATOL, LEARNER_RTOL)
    _assert_tree_close(opt.nu, ref_opt.nu, LEARNER_ATOL, LEARNER_RTOL)
    assert int(port.state.steps) == int(ref.state.steps) == steps


def test_learner_feeds_vtrace_views_without_copies(monkeypatch):
    """The learner hands V-trace its five (B, T) sequences as (T, B)
    transposed views, strides (1, T), with no copy; the kernel reads that
    layout as it is."""
    from repro_torch.kernels import ops, ref
    cfg = impala.IMPALAConfig()
    B, T = cfg.batch_size, cfg.sequence_length
    seen = []

    def spy(*inputs, clip_rho, clip_c):
        seen.append(inputs)
        return ref.vtrace_ref(*inputs, clip_rho=clip_rho, clip_c=clip_c)

    monkeypatch.setattr(ops, "vtrace", spy)
    _, port = _learners(cfg, 1)
    port.step()
    assert len(seen) == 1 and len(seen[0]) == 5
    for x in seen[0]:
        assert x.shape == (T, B) and x.stride() == (1, T)
        assert x._is_view() and not x.requires_grad
        assert x.transpose(0, 1).is_contiguous()


def test_learner_contract():
    """One host copy per step carries the metrics and the step counter;
    get_variables hands out numpy; walltime accumulates."""
    cfg = impala.IMPALAConfig(sequence_length=5, batch_size=4)
    learner = impala.make_learner(_spec(), cfg, _samples(cfg, 3, False),
                                  torch.Generator().manual_seed(0),
                                  device=CPU)
    metrics = learner.step()
    assert set(metrics) == {"loss", "pg_loss", "v_loss", "entropy",
                            "learner_steps", "learner_walltime"}
    assert metrics["learner_steps"] == 1.0
    assert all(isinstance(v, float) for v in metrics.values())
    assert learner.metrics == metrics
    walltime = learner.learner_walltime
    assert walltime > 0
    learner.step()
    assert learner.learner_walltime > walltime
    (variables,) = learner.get_variables(["policy"])
    leaves = tree.leaves(variables)
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)


def test_torch_learner_sends_priorities_with_the_sample_keys():
    cfg = impala.IMPALAConfig(sequence_length=5, batch_size=4)
    got = []
    state = common.LearnerState({"w": torch.zeros(2)}, (), (),
                                torch.zeros((), dtype=torch.int32))

    def update(state, sample):
        assert sample.data["reward"].dtype == torch.float32
        priorities = sample.data["reward"].sum(-1).abs()
        return (state._replace(steps=state.steps + 1),
                {"loss": priorities.sum()}, priorities)

    learner = common.TorchLearner(
        state, update, _samples(cfg, 1, False),
        priority_update_cb=lambda keys, p: got.append((keys, p)), device=CPU)
    metrics = learner.step()
    data = _batch(cfg, seed=0)
    expected = np.abs(data["reward"].sum(-1))
    np.testing.assert_array_equal(got[0][0], np.arange(4))
    np.testing.assert_allclose(got[0][1], expected)
    assert metrics["loss"] == pytest.approx(expected.sum())
    assert metrics["learner_steps"] == 1.0


def test_fresh_copy_and_importance_weights_match_reference():
    probs = np.random.RandomState(0).rand(9).astype(np.float32)
    probs[3] = 0.0
    np.testing.assert_allclose(
        common.importance_weights(torch.as_tensor(probs), 0.4).numpy(),
        np.asarray(jax_common.importance_weights(jnp.asarray(probs), 0.4)),
        rtol=1e-6)
    params = {"a": [torch.ones(3)]}
    copy = common.fresh_copy(params)
    copy["a"][0].add_(1)
    assert float(params["a"][0].sum()) == 3.0


# ------------------------------------------------------------------- acting
class _StaticSource(VariableSource):
    def __init__(self, params):
        self.params = params

    def get_variables(self, names=()):
        return [self.params for _ in names]


def _policy_pair(cfg):
    params = _jax_params(cfg, seed=5)
    ref_policy = jax_impala.make_behavior_policy(jax_spec(JaxCatch()), cfg)
    port_policy = impala.make_behavior_policy(_spec(), cfg)
    return params, ref_policy, port_policy


def test_behaviour_logits_match_reference_at_equal_params():
    cfg = impala.IMPALAConfig()
    params, ref_policy, port_policy = _policy_pair(cfg)
    port_params = impala.params_from_jax(params, device=CPU)
    obs = np.random.RandomState(1).rand(5, 10, 5).astype(np.float32)
    actions, logits = port_policy(port_params, torch.Generator(),
                                  torch.as_tensor(obs))
    assert actions.dtype == torch.int32 and actions.shape == (5,)
    for i in range(5):
        _, ref_logits = ref_policy(params, jax.random.key(i),
                                   jnp.asarray(obs[i]))
        np.testing.assert_allclose(logits[i].numpy(), np.asarray(ref_logits),
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_behaviour_policy_samples_the_softmax():
    """Draws follow softmax(logits) (the reference's categorical): 20000
    Gumbel-max draws at fixed logits, each action's frequency within 0.015
    of its probability (over 5 standard deviations)."""
    cfg = impala.IMPALAConfig()
    params, _, port_policy = _policy_pair(cfg)
    port_params = impala.params_from_jax(params, device=CPU)
    obs = torch.as_tensor(np.random.RandomState(2).rand(1, 10, 5),
                          dtype=torch.float32).expand(20000, 10, 5)
    actions, logits = port_policy(port_params,
                                  torch.Generator().manual_seed(0), obs)
    freq = np.bincount(actions.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.015)


class _RecordingAdder:
    def __init__(self):
        self.firsts, self.adds = [], []

    def add_first(self, timestep):
        self.firsts.append(timestep)

    def add(self, action, next_timestep, extras=()):
        self.adds.append((action, extras))


def test_batched_impala_actor_routes_each_envs_logits_to_its_adder():
    """One batched call for 4 Catch envs: adder i gets env i's action and
    the reference's behaviour logits for env i's observation; the
    single-env actor records its logits the same way."""
    cfg = impala.IMPALAConfig()
    params, ref_policy, port_policy = _policy_pair(cfg)
    source = _StaticSource(jax.tree.map(np.asarray, params))
    adders = [_RecordingAdder() for _ in range(4)]
    actor = impala.BatchedIMPALAActor(port_policy, VariableClient(source),
                                      adders, rng_seed=3, device=CPU)
    env = VectorEnv(lambda s: Catch(seed=s), 4)
    first = env.reset()
    assert len({o.tobytes() for o in first.observation}) > 1
    actions = actor.select_action(first.observation)
    assert actions.dtype == np.int32 and actions.shape == (4,)
    ts = env.step(actions)
    for i in range(4):
        actor.observe(actions[i], split_timestep(ts, i), env_id=i)
    for i, adder in enumerate(adders):
        (action, extras), = adder.adds
        assert action == actions[i]
        _, ref_logits = ref_policy(params, jax.random.key(0),
                                   jnp.asarray(first.observation[i]))
        np.testing.assert_allclose(extras["behavior_logits"],
                                   np.asarray(ref_logits), atol=FWD_TOL,
                                   rtol=FWD_TOL)

    adder = _RecordingAdder()
    single = impala.IMPALAActor(port_policy, VariableClient(source), adder,
                                rng_seed=3, device=CPU)
    obs = split_timestep(first, 2).observation
    action = single.select_action(obs)
    single.observe(action, split_timestep(ts, 2))
    (recorded, extras), = adder.adds
    assert recorded == action and np.asarray(action).shape == ()
    _, ref_logits = ref_policy(params, jax.random.key(0), jnp.asarray(obs))
    np.testing.assert_allclose(extras["behavior_logits"],
                               np.asarray(ref_logits), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_actor_draws_are_seeded_by_seed_and_step():
    """The step counter is the whole RNG state: two actors with the same
    seed draw the same actions; a restored step counter resumes the
    stream; another seed draws differently."""
    cfg = impala.IMPALAConfig()
    params, _, policy = _policy_pair(cfg)
    source = _StaticSource(jax.tree.map(np.asarray, params))
    obs = np.random.RandomState(0).rand(64, 10, 5).astype(np.float32)

    def run(seed, steps=6, state=None):
        actor = BatchedFeedForwardActor(
            lambda p, g, o: policy(p, g, o)[0], VariableClient(source),
            rng_seed=seed, device=CPU)
        if state is not None:
            actor.load_state_dict(state)
        draws = [actor.select_action(obs) for _ in range(steps)]
        return draws, actor.state_dict()

    a, state = run(0)
    b, _ = run(0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert state["steps"] == 6
    resumed, _ = run(0, steps=3, state={"steps": 3, "client": state["client"]})
    assert all(np.array_equal(x, y) for x, y in zip(a[3:], resumed))
    c, _ = run(1)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert not all(np.array_equal(a[0], x) for x in a[1:])


def test_feed_forward_actor_returns_row_zero():
    cfg = impala.IMPALAConfig()
    params, _, policy = _policy_pair(cfg)
    actor = FeedForwardActor(lambda p, g, o: policy(p, g, o)[0],
                             VariableClient(_StaticSource(
                                 jax.tree.map(np.asarray, params))),
                             device=CPU)
    action = actor.select_action(np.zeros((10, 5), np.float32))
    assert np.asarray(action).shape == () and 0 <= int(action) < 3


# -------------------------------------------------------- schedule and loop
class _CountingLearner:
    def __init__(self):
        self.steps = 0

    def step(self):
        self.steps += 1
        return {}

    def get_variables(self, names=()):
        return [{} for _ in names]


class _NullActor:
    def select_action(self, observation):
        return 0

    def observe_first(self, timestep, **kwargs):
        pass

    def observe(self, action, next_timestep, **kwargs):
        pass

    def update(self, wait=False):
        pass

    def state_dict(self):
        return {}


@pytest.mark.parametrize("min_obs,per_step,batch", [
    (0, 1.0, 1), (10, 1.0, 16), (5, 4.0, 3), (7, 0.5, 2)])
def test_agent_schedule_matches_reference(min_obs, per_step, batch):
    """The same observation counts, delivered singly and in batches, give
    the same learner steps as the reference Agent."""
    rng = np.random.RandomState(min_obs)
    counts = []
    for cls in (Agent, jax_agent.Agent):
        learner = _CountingLearner()
        agent = cls(_NullActor(), learner, min_obs, per_step)
        trace = []
        for _ in range(30):
            for _ in range(rng.randint(1, batch + 1)):
                agent.observe(0, None)
            agent.update()
            trace.append(learner.steps)
        counts.append((trace, agent.state_dict()))
        rng = np.random.RandomState(min_obs)
    assert counts[0] == counts[1]


def test_vectorized_impala_agent_trains_through_the_loop():
    """make_agent with 4 envs: a batched actor over a VectorEnv, one
    padded sequence per Catch episode into the queue, learner steps as the
    queue fills, and the counters of the reference loop."""
    cfg = impala.IMPALAConfig(sequence_length=5, batch_size=4)
    agent = make_agent(impala.IMPALABuilder(_spec(), cfg, seed=0,
                                            device=CPU), num_envs=4)
    assert isinstance(agent.actor, impala.BatchedIMPALAActor)
    loop = VectorizedEnvironmentLoop(VectorEnv(lambda s: Catch(seed=s), 4),
                                     agent)
    results = loop.run(num_episodes=24)
    assert len(results) >= 24
    assert {r["episode_length"] for r in results} == {9}
    assert sorted({r["env_id"] for r in results}) == [0, 1, 2, 3]
    assert results[-1]["environment_loop_episodes"] == len(results)
    steps = int(agent.learner.state.steps)
    assert steps >= 5
    metrics = agent.learner.step() if agent.table.size() >= 4 else None
    assert metrics is None or np.isfinite(metrics["loss"])


def test_make_agent_rejects_paths_not_ported():
    """Sharded replay and learner replicas are ported; async learner sync
    and shard-affine routing come with slice 7b."""
    cfg = impala.IMPALAConfig(sequence_length=3, batch_size=2)
    builder = impala.IMPALABuilder(_spec(), cfg, device=CPU)
    for kwargs in (dict(learner_sync="async"),
                   dict(replay_routing="affinity")):
        with pytest.raises(NotImplementedError, match="slice 7b"):
            make_agent(builder, **kwargs)
    with pytest.raises(ValueError):
        make_agent(builder, learner_sync="bogus")
    agent = make_agent(builder, num_learner_replicas=1)
    assert isinstance(agent.learner, MultiLearner)
    assert isinstance(make_agent(builder).learner, common.TorchLearner)
    sharded = make_agent(builder, num_replay_shards=2)
    assert isinstance(sharded.table, ShardedReplay)
    assert isinstance(sharded.learner, common.TorchLearner)
    replicas = make_agent(builder, num_learner_replicas=2)
    assert isinstance(replicas.learner, MultiLearner)
    assert replicas.table.num_shards == 2


@pytest.mark.parametrize("period", [None, 1, 10])
def test_make_agent_takes_learner_average_period(period):
    """run_experiment passes learner_average_period on, as the reference
    does; without replicas it changes nothing, and two replicas average
    every ``period`` steps (the builder's default of 50 when None)."""
    cfg = impala.IMPALAConfig(sequence_length=3, batch_size=2)
    builder = impala.IMPALABuilder(_spec(), cfg, device=CPU)
    agent = make_agent(builder, learner_average_period=period)
    assert isinstance(agent.learner, common.TorchLearner)
    agent = make_agent(builder, num_learner_replicas=2,
                       learner_average_period=period)
    assert agent.learner.average_period == (
        builder.options.learner_average_period if period is None
        else period)


# ------------------------------------------------------------- builder API
def _make_dqfd():
    demos = dqfd.generate_deep_sea_demos(DeepSea(size=4, seed=0),
                                         num_demos=4)
    cfg = dqfd.DQfDConfig(min_replay_size=8, samples_per_insert=0.0,
                          batch_size=8, n_step=1, demo_ratio=0.5)
    spec = make_environment_spec(DeepSea(size=4, seed=0))
    return (dqfd.DQfDBuilder(spec, demos, cfg, seed=0, device=CPU),
            DeepSea(size=4, seed=0))


def _make_r2d2():
    cfg = r2d2.R2D2Config(sequence_length=4, period=2, burn_in=0,
                          batch_size=4, min_replay_size=4,
                          samples_per_insert=0.0)
    return r2d2.R2D2Builder(_spec(), cfg, seed=0, device=CPU), Catch(seed=0)


def _make_r2d3():
    env = DeepSea(size=4, seed=0)
    demos = dqfd.generate_sequence_demos(DeepSea(size=4, seed=0),
                                         lambda e: e.optimal_action(),
                                         num_demos=4, sequence_length=4,
                                         period=3)
    cfg = r2d3.R2D3Config(sequence_length=4, period=3, burn_in=0,
                          batch_size=4, min_replay_size=4,
                          samples_per_insert=0.0, demo_ratio=0.5)
    return (r2d3.R2D3Builder(make_environment_spec(env), demos, cfg, seed=0,
                             device=CPU), DeepSea(size=4, seed=0))


def _make_transformer_policy():
    from repro_torch.policies import (TransformerPolicyBuilder,
                                      TransformerPolicyConfig)
    # the reference's factory uses backend "jnp", the port's "grouped"
    cfg = TransformerPolicyConfig(num_layers=1, d_model=32, num_heads=2,
                                  num_kv_heads=1, head_dim=16, d_ff=64,
                                  window=4, sequence_length=4, period=2,
                                  batch_size=4, min_replay_size=4,
                                  samples_per_insert=0.0, backend="grouped")
    return (TransformerPolicyBuilder(_spec(), cfg, seed=0, device=CPU),
            Catch(seed=0))


def _collect_catch_transitions(n_episodes=10):
    """The reference factory's dataset: n-step-1 Catch transitions of a
    seeded random policy."""
    from repro_torch.adders import NStepTransitionAdder
    from repro_torch.replay import MinSize, Table, Uniform

    env = Catch(seed=0)
    table = Table("tmp", 10_000, Uniform(0), MinSize(1))
    adder = NStepTransitionAdder(table, 1, 0.99)
    rng = np.random.RandomState(0)
    for _ in range(n_episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            a = int(rng.randint(3))
            ts = env.step(a)
            adder.add(a, ts)
    return [table._items[k].data for k in table._order]


def _make_mcts():
    cfg = mcts.MCTSConfig(num_simulations=4, search_depth=4, batch_size=2,
                          min_replay_size=2)
    return (mcts.MCTSBuilder(_spec(), lambda seed: Catch(seed=seed), cfg,
                             seed=0, device=CPU), Catch(seed=0))


def _make_continuous():
    cfg = continuous.ContinuousConfig(algo="d4pg", hidden=32, batch_size=8,
                                      min_replay_size=8,
                                      samples_per_insert=0.0, n_step=1,
                                      num_atoms=11, vmax=30.0)
    env = PendulumSwingup(seed=0, episode_len=30)
    return (continuous.ContinuousBuilder(make_environment_spec(env), cfg,
                                         seed=0, device=CPU),
            PendulumSwingup(seed=0, episode_len=30))


def _make_bc():
    items = _collect_catch_transitions(4)
    return (bc.BCBuilder(_spec(), items, bc.BCConfig(batch_size=8), seed=0,
                         device=CPU), Catch(seed=0))


# The port's mirror of the reference's FACTORIES
# (tests/test_builders_api.py).
FACTORIES = {
    "IMPALABuilder": lambda: (impala.IMPALABuilder(
        _spec(), impala.IMPALAConfig(sequence_length=3, batch_size=2),
        seed=0, device=CPU), Catch(seed=0)),
    "DQNBuilder": lambda: (dqn.DQNBuilder(
        _spec(), dqn.DQNConfig(batch_size=4, min_replay_size=10),
        seed=0, device=CPU), Catch(seed=0)),
    "DQfDBuilder": _make_dqfd,
    "R2D2Builder": _make_r2d2,
    "R2D3Builder": _make_r2d3,
    "TransformerPolicyBuilder": _make_transformer_policy,
    "MCTSBuilder": _make_mcts,
    "ContinuousBuilder": _make_continuous,
    "BCBuilder": _make_bc,
}


def test_every_registered_builder_has_a_conformance_factory():
    names = {cls.__name__ for cls in registered_builders()}
    assert names == set(FACTORIES)


@pytest.mark.parametrize("cls", registered_builders(),
                         ids=lambda c: c.__name__)
def test_builder_conformance(cls):
    """The port's mirror of tests/test_builders_api.py: replay -> adder ->
    dataset -> learner -> policy -> actor, ending in a real learner
    step."""
    builder, env = FACTORIES[cls.__name__]()
    assert isinstance(builder, AgentBuilder)
    assert isinstance(builder.options, BuilderOptions)
    table = builder.make_replay()
    adder = builder.make_adder(table)
    iterator = builder.make_dataset(table)
    learner = builder.make_learner(
        iterator, priority_update_cb=table.update_priorities)
    policy = builder.make_policy(evaluation=False)
    actor = builder.make_actor(policy, VariableClient(learner), adder, seed=0)
    for _ in range(3):
        ts = env.reset()
        actor.observe_first(ts)
        while not ts.last():
            action = actor.select_action(ts.observation)
            ts = env.step(action)
            actor.observe(action, ts)
    assert table.size() > 0, "actor experience never reached replay"
    assert not table.rate_limiter.would_block_sample()
    assert table.size() >= builder.options.batch_size
    assert np.isfinite(learner.step()["loss"])
    # the inference="server" client: an actor holding no weights
    assert isinstance(builder.make_inference_actor(None, adder=adder), Actor)


def test_builder_options_validation():
    for bad in (dict(batch_size=0), dict(variable_update_period=0),
                dict(min_observations=-1), dict(observations_per_step=0.0),
                dict(num_replay_shards=0), dict(inference="remote"),
                dict(learner_sync="gossip"), dict(replay_routing="x"),
                dict(telemetry_push_period_s=0.0)):
        with pytest.raises(ValueError):
            BuilderOptions(**bad)


# ------------------------------------------------------------ acceptance
def test_impala_learns_catch():
    """The reference's own acceptance (tests/test_agents_learning.py):
    Catch(seed=2), T 5, B 4, lr 3e-3, entropy 0.02, builder seed 1, 600
    episodes; the mean of the last 50 returns beats the first 50 by 0.3."""
    env = Catch(seed=2)
    cfg = impala.IMPALAConfig(sequence_length=5, batch_size=4,
                              learning_rate=3e-3, entropy_cost=0.02)
    agent = make_agent(impala.IMPALABuilder(make_environment_spec(env), cfg,
                                            seed=1, device=CPU))
    loop = EnvironmentLoop(env, agent)
    rets = [loop.run_episode()["episode_return"] for _ in range(600)]
    assert np.mean(rets[-50:]) > np.mean(rets[:50]) + 0.3
