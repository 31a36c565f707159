"""repro_torch.replay and repro_torch.adders against the JAX package: the
same inserts, seeds and Catch streams go through both, and everything must
be exactly equal — sampled keys and probabilities, rate-limiter blocking,
table snapshots, dataset batches and adder items, byte for byte."""
import threading
import types

import numpy as np
import pytest

from repro import replay as jax_replay
from repro.adders.sequence import EpisodeAdder as JaxEpisodeAdder
from repro.adders.sequence import SequenceAdder as JaxSequenceAdder
from repro.envs import Catch as JaxCatch
from repro_torch import replay
from repro_torch.adders import EpisodeAdder, SequenceAdder
from repro_torch.distributed.courier import ServiceUnavailable
from repro_torch.envs import Catch

PACKAGES = {"port": replay, "ref": jax_replay}


def _item(i):
    return {"x": np.full((2, 3), i, np.float32), "k": np.int32(i)}


def _assert_same_tree(a, b):
    """Equal structure, dtypes, shapes and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for key in a:
            _assert_same_tree(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        assert a.tobytes() == b.tobytes(), (a, b)


def _selector(pkg, kind, seed):
    if kind == "Fifo":
        return pkg.Fifo()
    if kind == "Lifo":
        return pkg.Lifo()
    if kind == "Uniform":
        return pkg.Uniform(seed=seed)
    return pkg.Prioritized(priority_exponent=0.6, capacity=64, seed=seed)


def _drive(pkg, kind, seed=7):
    """Inserts with varied priorities, priority updates, FIFO eviction at
    capacity 40, and interleaved samples; returns every sampled (key,
    probability) and the final table."""
    table = pkg.Table("t", 40, _selector(pkg, kind, seed), pkg.MinSize(1))
    rng = np.random.RandomState(seed)
    drawn = []
    for i in range(60):
        table.insert(_item(i), priority=float(rng.rand() * 3))
        if i % 4 == 3:
            for item, prob in table.sample(3 if table.selector.consumes
                                           else 5):
                drawn.append((item.key, prob))
        if i % 10 == 9 and kind == "Prioritized":
            keys = sorted(table._items)[:5]
            table.update_priorities(keys, rng.rand(5) * 5)
    return drawn, table


@pytest.mark.parametrize("kind", ["Fifo", "Lifo", "Uniform", "Prioritized"])
def test_selectors_sample_the_same_keys_and_probabilities(kind):
    port, port_table = _drive(replay, kind)
    ref, ref_table = _drive(jax_replay, kind)
    assert port == ref          # exact keys and float probabilities
    assert len(port) > 20
    assert port_table.size() == ref_table.size()


def test_prioritized_selector_state_matches_reference():
    _, port_table = _drive(replay, "Prioritized")
    _, ref_table = _drive(jax_replay, "Prioritized")
    port_state = port_table.selector.state_dict()
    ref_state = ref_table.selector.state_dict()
    np.testing.assert_array_equal(port_state["tree"], ref_state["tree"])
    assert port_state["slot"] == ref_state["slot"]
    assert port_state["free"] == ref_state["free"]
    assert port_state["rng"] == ref_state["rng"]


def _limiter_trace(pkg, make_limiter, ops):
    """Per op: would insert/sample block before it, then do it if not."""
    limiter = make_limiter(pkg)
    trace = []
    for op in ops:
        blocked = (limiter.would_block_insert() if op == "i"
                   else limiter.would_block_sample())
        trace.append((op, blocked))
        if not blocked:
            (limiter.await_can_insert if op == "i"
             else limiter.await_can_sample)(timeout=0.1)
    return trace, limiter.inserts, limiter.samples


@pytest.mark.parametrize("make_limiter", [
    lambda pkg: pkg.MinSize(4),
    lambda pkg: pkg.SampleToInsertRatio(2.0, min_size_to_sample=3,
                                        error_buffer=4.0),
    lambda pkg: pkg.SampleToInsertRatio(0.5, min_size_to_sample=2,
                                        error_buffer=1.0),
], ids=["MinSize", "SPI2", "SPI0.5"])
def test_rate_limiters_block_and_release_like_the_reference(make_limiter):
    ops = list(np.random.RandomState(3).choice(["i", "s"], 80, p=[0.4, 0.6]))
    port = _limiter_trace(replay, make_limiter, ops)
    ref = _limiter_trace(jax_replay, make_limiter, ops)
    assert port == ref
    assert any(blocked for _, blocked in port[0])
    assert any(not blocked for op, blocked in port[0] if op == "s")


def test_blocked_sample_is_released_by_an_insert():
    table = replay.Table("q", 10, replay.Fifo(), replay.MinSize(2))
    table.insert(_item(0))
    got = []
    sampler = threading.Thread(target=lambda: got.extend(table.sample(1)))
    sampler.start()
    sampler.join(timeout=0.2)
    assert sampler.is_alive()          # blocked below min size
    table.insert(_item(1))
    sampler.join(timeout=10)
    assert not sampler.is_alive() and got[0][0].key == 0
    with pytest.raises(replay.RateLimiterTimeout):
        replay.Table("e", 4, replay.Fifo(), replay.MinSize(1)).sample(
            1, timeout=0.05)


def test_marked_down_table_raises_service_unavailable():
    table = replay.Table("q", 10)
    table.mark_down()
    with pytest.raises(ServiceUnavailable):
        table.insert(_item(0))
    table.mark_up()
    assert table.insert(_item(0)) == 0


@pytest.mark.parametrize("kind", ["Fifo", "Uniform", "Prioritized"])
def test_table_state_dict_round_trips(kind):
    """A snapshot restored into a fresh table continues with the same
    sample stream as the table it was taken from, and equals the
    reference's snapshot."""
    _, table = _drive(replay, kind)
    _, ref_table = _drive(jax_replay, kind)
    state = table.state_dict()
    ref_state = ref_table.state_dict()
    assert state["next_key"] == ref_state["next_key"]
    assert state["rate_limiter"] == ref_state["rate_limiter"]
    assert [k for k, _, _ in state["items"]] == \
        [k for k, _, _ in ref_state["items"]]
    _assert_same_tree([d for _, d, _ in state["items"]],
                      [d for _, d, _ in ref_state["items"]])
    restored = replay.Table("t", 40, _selector(replay, kind, 99),
                            replay.MinSize(1))
    restored.load_state_dict(state)
    n = 3 if table.selector.consumes else 8
    assert [(i.key, p) for i, p in restored.sample(n)] == \
        [(i.key, p) for i, p in table.sample(n)]


def test_as_iterator_is_a_class_iterator_with_reference_batches():
    tables = {}
    for name, pkg in PACKAGES.items():
        tables[name] = pkg.Table("q", 100, pkg.Uniform(seed=5),
                                 pkg.MinSize(1))
        for i in range(12):
            tables[name].insert(_item(i))
    iterators = {name: pkg.as_iterator(tables[name], 4)
                 for name, pkg in PACKAGES.items()}
    port_it = iterators["port"]
    assert not isinstance(port_it, types.GeneratorType)
    assert iter(port_it) is port_it
    for _ in range(3):
        port, ref = next(port_it), next(iterators["ref"])
        _assert_same_tree(list(port.info), list(ref.info))
        _assert_same_tree(port.data, ref.data)


def test_dataset_from_list_matches_reference():
    items = [_item(i) for i in range(9)]
    port = replay.dataset_from_list(items, 4, seed=2)
    ref = jax_replay.dataset_from_list(items, 4, seed=2)
    for _ in range(3):
        a, b = next(port), next(ref)
        _assert_same_tree(list(a.info), list(b.info))
        _assert_same_tree(a.data, b.data)


# ------------------------------------------------------------------- adders
def _adder_items(env, adder_cls, table_pkg, kwargs, episodes, extras):
    """Random-action Catch episodes through an adder; returns the items in
    insertion order."""
    table = table_pkg.Table("q", 10_000, table_pkg.Fifo(),
                            table_pkg.MinSize(1))
    adder = adder_cls(table, **kwargs)
    rng = np.random.RandomState(11)
    for _ in range(episodes):
        ts = env.reset()
        adder.add_first(ts)
        while not ts.last():
            action = np.int32(rng.randint(3))
            ts = env.step(action)
            if extras:
                adder.add(action, ts, extras={
                    "behavior_logits": rng.randn(3).astype(np.float32)})
            else:
                adder.add(action, ts)
    return [table._items[k].data for k in table._order]


@pytest.mark.parametrize("kwargs", [
    dict(sequence_length=20, period=20),      # IMPALA: one padded item
    dict(sequence_length=5, period=5),        # non-overlapping + padding
    dict(sequence_length=4, period=2),        # overlapping, R2D2-style
    dict(sequence_length=3, period=3, pad_end=False),
], ids=["impala", "strided", "overlap", "no_pad"])
@pytest.mark.parametrize("extras", [True, False])
def test_sequence_adder_items_are_byte_equal(kwargs, extras):
    port = _adder_items(Catch(seed=4), SequenceAdder, replay, kwargs, 6,
                        extras)
    ref = _adder_items(JaxCatch(seed=4), JaxSequenceAdder, jax_replay,
                       kwargs, 6, extras)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        _assert_same_tree(a, b)
        assert list(a) == list(b)                 # key order too
    if kwargs.get("pad_end", True) and kwargs["sequence_length"] > 9:
        assert port[0]["mask"].sum() < len(port[0]["mask"])   # padded


def test_episode_adder_items_are_byte_equal():
    port = _adder_items(Catch(seed=1), EpisodeAdder, replay,
                        dict(max_episode_length=4), 3, False)
    ref = _adder_items(JaxCatch(seed=1), JaxEpisodeAdder, jax_replay,
                       dict(max_episode_length=4), 3, False)
    assert len(port) == len(ref) > 3
    for a, b in zip(port, ref):
        _assert_same_tree(a, b)
