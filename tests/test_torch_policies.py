"""repro_torch.policies against repro.policies: the Q-network views, the
engine (ring wrap, mixed prefill and decode, re-prefill after
invalidate_all, generation bump), the slot pool, the server, and the slice
as a whole — Catch episodes through the environment loop, locally and
through the inference server, with the same weights at epsilon 0."""
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import make_environment_spec as jax_make_spec
from repro.core.loop import EnvironmentLoop as JaxEnvironmentLoop
from repro.core.variable import VariableClient as JaxVariableClient
from repro.envs import Catch as JaxCatch
from repro.policies import PolicyEngine as JaxPolicyEngine
from repro.policies import TransformerInferenceServer as JaxServer
from repro.policies import TransformerPolicyBuilder as JaxBuilder
from repro.policies import TransformerPolicyConfig as JaxConfig
from repro.policies import actors as jax_actors
from repro.policies import network as jax_network
from repro_torch.core import EnvironmentLoop, VariableClient
from repro_torch.distributed.courier import CourierClosed
from repro_torch.envs import Catch
from repro_torch.policies import (CacheSlotsExhausted, KVCachePool,
                                  PolicyEngine, TransformerInferenceServer,
                                  TransformerPolicy, TransformerPolicyConfig,
                                  network)
from repro_torch.policies import actors
from repro_torch.policies.actors import _WindowBuffer
from repro_torch.telemetry import registry as telemetry

WINDOW = 4
OBS_SHAPE = (10, 5)
NUM_ACTIONS = 3
Q_TOL = 1e-4
ARCH_KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
               head_dim=16, d_ff=64, window=WINDOW, epsilon=0.0)


# The JAX side runs jitted (ArchConfig is hashable), as its engine does.
_jax_init = jax.jit(jax_network.init, static_argnums=(1, 2, 3))
_jax_q_sequence = jax.jit(jax_network.q_sequence, static_argnums=1)
_jax_q_prefill = jax.jit(jax_network.q_prefill, static_argnums=1)
_jax_q_decode = jax.jit(jax_network.q_decode, static_argnums=1,
                        static_argnames="backend")


def _arches(num_layers=2):
    kw = dict(ARCH_KW, num_layers=num_layers)
    return (network.make_arch(TransformerPolicyConfig(**kw), NUM_ACTIONS),
            jax_network.make_arch(JaxConfig(**kw), NUM_ACTIONS))


def _weights(seed=0, num_layers=2):
    """(port params, JAX params): one set of weights in both packages."""
    _, jarch = _arches(num_layers)
    jparams = _jax_init(jax.random.key(seed), jarch, 50, NUM_ACTIONS)
    return (network.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu"), jparams)


def _engines(num_slots, backend="ref", num_layers=2):
    arch, jarch = _arches(num_layers)
    return (PolicyEngine(arch, OBS_SHAPE, NUM_ACTIONS, num_slots=num_slots,
                         backend=backend, device="cpu"),
            JaxPolicyEngine(jarch, OBS_SHAPE, NUM_ACTIONS,
                            num_slots=num_slots, backend="jnp"))


def _oracle_q(jparams, window, length, num_layers=2):
    """The reference's full-sequence recompute Q at the newest real frame."""
    _, jarch = _arches(num_layers)
    q = _jax_q_sequence(jparams, jarch,
                        jnp.asarray(window).reshape(1, WINDOW, -1))[0]
    return np.asarray(q[max(length - 1, 0)])


class _Source:
    """get_variables handing out a fresh params OBJECT each bump()."""

    def __init__(self, params):
        self._params = params

    def bump(self):
        self._params = dict(self._params)

    def get_variables(self, names=("policy",)):
        return [self._params for _ in names]


# ============================================================ network views
def test_q_sequence_prefill_decode_match_jax():
    params, jparams = _weights()
    arch, jarch = _arches()
    rng = np.random.RandomState(0)
    obs = rng.rand(3, WINDOW, 50).astype(np.float32)
    np.testing.assert_allclose(
        network.q_sequence(params, arch, torch.as_tensor(obs)).numpy(),
        np.asarray(_jax_q_sequence(jparams, jarch, jnp.asarray(obs))),
        atol=Q_TOL, rtol=Q_TOL)

    lengths = np.asarray([WINDOW, 2, 1], np.int32)
    cache = network.init_cache(arch, 3, device="cpu")
    q, cache = network.q_prefill(params, arch, cache, torch.as_tensor(obs),
                                 torch.as_tensor(lengths))
    jq, jcache = _jax_q_prefill(jparams, jarch,
                                       jax_network.init_cache(jarch, 3),
                                       jnp.asarray(obs), jnp.asarray(lengths))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=Q_TOL,
                               rtol=Q_TOL)

    pos = lengths.copy()
    for _ in range(WINDOW + 1):                    # past the ring wrap
        step = rng.rand(3, 50).astype(np.float32)
        q, cache = network.q_decode(params, arch, cache,
                                    torch.as_tensor(step),
                                    torch.as_tensor(pos), backend="ref")
        jq, jcache = _jax_q_decode(jparams, jarch, jcache, jnp.asarray(step),
                                   jnp.asarray(pos), backend="ref")
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=Q_TOL,
                                   rtol=Q_TOL)
        pos += 1


# ==================================================================== engine
@pytest.mark.parametrize("backend", ["ref", "grouped"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_engine_matches_jax_engine(backend, num_layers):
    """Three episodes in one engine for 3x the window: ring wrap, env1
    restarting mid-run (prefill beside decode in one call), a forced
    re-prefill after invalidate_all, and a weights refresh (a new params
    object bumps the generation).  Actions and routing counters equal the
    JAX engine's.  With one layer, incremental decode computes exactly the
    full recompute over the window, so Q-values equal that oracle's too;
    with two, a token's layer-1 state has seen frames older than the window
    once the ring wraps, so the oracle no longer applies."""
    params, jparams = _weights(1, num_layers)
    engine, jengine = _engines(3, backend, num_layers)
    rng = np.random.RandomState(3)
    bufs = [_WindowBuffer(WINDOW, OBS_SHAPE) for _ in range(3)]
    for t in range(3 * WINDOW):
        if t == 5:
            bufs[1].reset()                  # env1 starts a new episode
        if t == 7:
            engine.pool.invalidate_all()
            jengine.pool.invalidate_all()
        if t == 9:                           # same values, new objects
            params = dict(params)
            jparams = jax.tree.map(lambda x: x, jparams)
        for b in bufs:
            b.push(rng.rand(*OBS_SHAPE).astype(np.float32))
        windows = np.stack([b.window_array() for b in bufs])
        positions = [b.t for b in bufs]
        keys = ["e0", "e1", "e2"]
        acts, q = engine.select_with_q(params, keys, windows, positions)
        jacts = jengine.select(jparams, keys, windows, positions)
        np.testing.assert_array_equal(acts, np.asarray(jacts))
        for i, b in enumerate(bufs):
            if num_layers == 1:
                np.testing.assert_allclose(
                    q[i], _oracle_q(jparams, windows[i],
                                    min(b.t + 1, WINDOW), num_layers),
                    atol=Q_TOL, rtol=Q_TOL)
    stats, jstats = engine.stats(), jengine.stats()
    for name in ("prefill_rows", "decode_rows", "prefill_batches",
                 "decode_batches", "cache_invalidations", "stale_reprefills",
                 "pool_invalidations"):
        assert stats[name] == jstats[name], name
    assert stats["cache_invalidations"] == 1
    assert stats["stale_reprefills"] == 6


def test_engine_exploration_is_seeded_per_batch():
    params, _ = _weights()
    arch, _ = _arches()
    window = np.zeros((1, WINDOW) + OBS_SHAPE, np.float32)

    def run(seed):
        engine = PolicyEngine(arch, OBS_SHAPE, NUM_ACTIONS, num_slots=1,
                              epsilon=1.0, rng_seed=seed, device="cpu")
        # position 0 every call: the slot restarts, one prefill each
        return [int(engine.select(params, ["e"], window, [0])[0])
                for _ in range(20)]

    assert run(0) == run(0)
    assert run(0) != run(1)
    assert set(run(0)) == {0, 1, 2}


def test_engine_records_pass_times_when_telemetry_is_on():
    params, _ = _weights()
    arch, _ = _arches()
    telemetry.configure(enabled=True)
    try:
        engine = PolicyEngine(arch, OBS_SHAPE, NUM_ACTIONS, num_slots=1,
                              device="cpu")
        buf = _WindowBuffer(WINDOW, OBS_SHAPE)
        for _ in range(3):
            buf.push(np.ones(OBS_SHAPE, np.float32))
            engine.select(params, ["e"], buf.window_array()[None], [buf.t])
        snap = telemetry.snapshot()
    finally:
        telemetry.unconfigure()
    assert snap["inference/engine/prefill_ms"]["count"] == 1
    assert snap["inference/engine/decode_ms"]["count"] == 2
    assert snap["inference/engine/decode_rows"]["value"] == 2


# ============================================================ slot lifecycle
def _pool(**kw):
    arch, _ = _arches()
    return KVCachePool(arch, device="cpu", **kw)


def test_pool_recycle_on_episode_end():
    pool = _pool(num_slots=2)
    a = pool.acquire("a")
    b = pool.acquire("b")
    assert pool.held() == 2 and a.index != b.index
    pool.release("a")
    assert pool.held() == 1
    c = pool.acquire("c")               # recycles a's slot
    assert c.index == a.index
    assert c.pos == -1 and c.cache_pos == -1
    assert pool.cache["kv"]["k"].shape == (2, 3, WINDOW, 2, 16)


def test_pool_exhaustion_backpressure_and_reaping():
    pool = _pool(num_slots=1, timeout_s=0.05, reap_idle_s=None)
    pool.acquire("a")
    t0 = time.monotonic()
    with pytest.raises(CacheSlotsExhausted):
        pool.acquire("b")
    assert time.monotonic() - t0 >= 0.04   # it actually waited
    assert pool.stats["exhausted_waits"] == 1

    thread = threading.Thread(target=lambda: (time.sleep(0.05),
                                              pool.release("a")))
    thread.start()
    assert pool.acquire("b", timeout=2.0).key == "b"
    thread.join(timeout=2.0)
    assert not thread.is_alive()

    pool = _pool(num_slots=2, timeout_s=0.05, reap_idle_s=0.1)
    dead = pool.acquire("dead-client")
    pool.acquire("live-client")
    time.sleep(0.15)
    pool.lookup("live-client")             # the live one is touched
    fresh = pool.acquire("fresh-client")   # pressure: reaps only the dead
    assert fresh.index == dead.index
    assert pool.stats["reaped"] == 1
    assert pool.lookup("dead-client") is None
    assert pool.lookup("live-client") is not None


def test_pool_invalidate_all_and_scratch_scatter():
    pool = _pool(num_slots=2)
    slot = pool.acquire("a")
    slot.pos = 5
    generation = pool.generation
    pool.invalidate_all()
    assert pool.generation == generation + 1
    assert slot.generation == generation      # now stale
    assert pool.held() == 1                   # still held, must re-prefill

    idx = torch.as_tensor([slot.index, pool.scratch_index,
                           pool.scratch_index])
    sub = pool.gather(idx)
    for t in sub["kv"].values():
        t.fill_(7.0)
    pool.scatter(idx, sub)
    k = pool.cache["kv"]["k"]
    assert bool((k[:, slot.index] == 7.0).all())
    assert bool((k[:, 1 - slot.index] == 0.0).all())   # untouched live row


# ================================================================== serving
def test_transformer_inference_server_roundtrip_and_stop():
    params, _ = _weights()
    arch, _ = _arches()
    engine = PolicyEngine(arch, OBS_SHAPE, NUM_ACTIONS, num_slots=4,
                          device="cpu")
    source = _Source(params)
    server = TransformerInferenceServer(engine, source, max_batch_size=4,
                                        max_wait_ms=1.0, update_period=1)
    try:
        assert server.window() == WINDOW
        rng = np.random.RandomState(5)
        bufs = [_WindowBuffer(WINDOW, OBS_SHAPE) for _ in range(2)]
        for _ in range(WINDOW + 2):
            for b in bufs:
                b.push(rng.rand(*OBS_SHAPE).astype(np.float32))
            actions = server.select_action(
                np.stack([b.window_array() for b in bufs]),
                np.asarray([b.t for b in bufs]), "client-1")
            assert actions.shape == (2,)
        stats = server.stats()
        assert stats["requests"] == WINDOW + 2
        assert stats["rows"] == 2 * (WINDOW + 2)
        assert stats["pool_held_slots"] == 2
        assert stats["decode_rows"] == 2 * (WINDOW + 1)

        source.bump()          # a new params object => re-prefill
        for b in bufs:
            b.push(rng.rand(*OBS_SHAPE).astype(np.float32))
        server.select_action(np.stack([b.window_array() for b in bufs]),
                             np.asarray([b.t for b in bufs]), "client-1")
        assert server.stats()["cache_invalidations"] == 1

        server.release("client-1")
        assert server.stats()["pool_held_slots"] == 0
    finally:
        server.stop()
    with pytest.raises(CourierClosed):
        server.select_action(np.zeros((1, WINDOW) + OBS_SHAPE, np.float32),
                             np.zeros((1,), np.int64), "c")


# ======================================================= the slice as a whole
class _Recording:
    """Forwards to an actor and records the actions it selects."""

    def __init__(self, actor):
        self.actor = actor
        self.actions = []

    def select_action(self, observation):
        action = self.actor.select_action(observation)
        self.actions.append(int(action))
        return action

    def observe_first(self, timestep):
        self.actor.observe_first(timestep)

    def observe(self, action, next_timestep):
        self.actor.observe(action, next_timestep=next_timestep)

    def update(self, wait=False):
        self.actor.update(wait)


def _episodes(loop_cls, env, actor, n=5):
    recording = _Recording(actor)
    returns = [r["episode_return"]
               for r in loop_cls(env, recording).run(num_episodes=n)]
    return recording.actions, returns


@pytest.mark.parametrize("mode", ["local", "server"])
def test_catch_episodes_match_jax_at_epsilon_zero(mode):
    """The slice end to end: Catch through the environment loop, acting by
    windowed KV-cache decode — locally, or through the batching server —
    gives the JAX package's actions and returns over 5 episodes."""
    params, jparams = _weights(4)
    engine, jengine = _engines(4, "auto")
    if mode == "local":
        ours = _episodes(EnvironmentLoop, Catch(seed=7), actors.
                         WindowedPolicyActor(engine,
                                             VariableClient(_Source(params))))
        theirs = _episodes(JaxEnvironmentLoop, JaxCatch(seed=7),
                           jax_actors.WindowedPolicyActor(
                               jengine, JaxVariableClient(_Source(jparams))))
    else:
        server = TransformerInferenceServer(engine, _Source(params),
                                            max_batch_size=4)
        jserver = JaxServer(jengine, _Source(jparams), max_batch_size=4)
        try:
            ours = _episodes(EnvironmentLoop, Catch(seed=7),
                             actors.WindowedInferenceClientActor(server))
            theirs = _episodes(JaxEnvironmentLoop, JaxCatch(seed=7),
                               jax_actors.WindowedInferenceClientActor(
                                   jserver))
        finally:
            server.stop()
            jserver.stop()
    assert ours == theirs
    assert len(ours[0]) == 5 * 9 and all(r in (-1.0, 1.0) for r in ours[1])
    assert engine.stats()["decode_rows"] > 0


def test_transformer_policy_call_matches_jax_policy():
    params, jparams = _weights(5)
    arch, _ = _arches()
    spec = jax_make_spec(JaxCatch(seed=0))
    jpolicy = JaxBuilder(spec, JaxConfig(**ARCH_KW)).make_policy(
        evaluation=True)
    policy = TransformerPolicy(arch, OBS_SHAPE, NUM_ACTIONS, epsilon=0.0,
                               backend="auto", cache_slots=4,
                               slot_timeout_s=1.0)
    rng = np.random.RandomState(6)
    generator = torch.Generator().manual_seed(0)
    for length in range(1, WINDOW + 1):
        window = np.zeros((WINDOW,) + OBS_SHAPE, np.float32)
        window[:length] = rng.rand(length, *OBS_SHAPE)
        obs = {"window": window, "length": np.int32(length)}
        expected = jpolicy(jparams, jax.random.key(0),
                           jax.tree.map(jnp.asarray, obs))
        assert int(policy(params, generator, obs)) == int(expected)
