"""repro_torch.replay's sharded service and prefetching pipeline against
the JAX package: the same inserts, seeds and sample calls through both
``ShardedReplay``s give the same sampled keys, probabilities, priorities and
per-shard stats, exactly, under round-robin and hash routing; a
``ShardWriter`` hands out the reference's global keys.  Then the
reference's ``tests/test_sharded_replay.py`` unit, stress and prefetch
cases on the port."""
import threading
import time

import numpy as np
import pytest

from repro import replay as jax_replay
from repro_torch import replay
from repro_torch.builders import BuilderOptions
from repro_torch.replay import (Fifo, MinSize, PrefetchingDataset,
                                Prioritized, RateLimiterTimeout,
                                SampleToInsertRatio, ShardedReplay,
                                ShardWriter, Table, Uniform, as_iterator,
                                make_replay_shards)

PACKAGES = {"port": replay, "ref": jax_replay}


def _uniform_factory(capacity=1000, min_size=1):
    return lambda: Table("t", capacity, Uniform(0), MinSize(min_size))


def _factory(pkg, selector):
    """A shard factory over ``pkg``'s classes: uniform or prioritized
    selection from seed 0 (the same stream in both packages)."""
    if selector == "uniform":
        return lambda: pkg.Table("t", 64, pkg.Uniform(0), pkg.MinSize(2))
    return lambda: pkg.Table(
        "t", 64, pkg.Prioritized(priority_exponent=0.8, seed=0),
        pkg.MinSize(2))


def _drive(pkg, routing, selector, num_shards=3):
    """Inserts (past capacity, so evictions too), priority updates and
    samples; everything observable, in call order."""
    sr = pkg.ShardedReplay.from_factory(_factory(pkg, selector), num_shards,
                                        routing=routing)
    rng = np.random.RandomState(7)
    seen = []
    keys = []
    for i in range(220):
        keys.append(sr.insert({"v": np.int32(i)},
                              priority=float(rng.rand() + 0.1)))
        if i % 37 == 36:
            recent = keys[-10:]
            sr.update_priorities(recent, list(rng.rand(len(recent)) + 0.5))
        if i % 23 == 22:
            out = sr.sample(5)
            seen.append([(item.key, int(item.data["v"]), item.priority,
                          prob) for item, prob in out])
    seen.append(keys)
    seen.append(sr.stats())
    return seen


@pytest.mark.parametrize("selector", ["uniform", "prioritized"])
@pytest.mark.parametrize("routing", ["round_robin", "hash"])
def test_sharded_sampling_equals_reference(routing, selector):
    port = _drive(replay, routing, selector)
    ref = _drive(jax_replay, routing, selector)
    assert port == ref
    assert port[-1]["num_shards"] == 3
    assert len(port[-1]["per_shard"]) == 3


def test_shard_writer_keys_equal_reference():
    out = {}
    for name, pkg in PACKAGES.items():
        sr = pkg.ShardedReplay.from_factory(_factory(pkg, "prioritized"), 4)
        writers = [sr.shard_view(i) for i in range(4)]
        keys = [writers[i % 4].insert(i, priority=1.0 + i)
                for i in range(12)]
        writers[1].update_priorities([keys[1], keys[5]], [7.0, 9.0])
        out[name] = (keys, [w.size() for w in writers],
                     [(item.key, item.priority) for item, _ in sr.sample(8)])
    assert out["port"] == out["ref"]
    keys = out["port"][0]
    assert [k % 4 for k in keys] == [i % 4 for i in range(12)]


def test_shard_writer_rejects_keys_of_other_shards_and_pickles():
    import pickle

    sr = ShardedReplay.from_factory(_uniform_factory(), 2)
    writer = sr.shard_view(0)
    assert isinstance(writer, ShardWriter)
    key = writer.insert("x")
    assert key % 2 == 0 and sr.shards[0].size() == 1
    with pytest.raises(ValueError, match="belongs to shard 1"):
        writer.update_priorities([key + 1], [1.0])
    with pytest.raises(ValueError):
        ShardWriter(sr.shards[0], 2, 2)
    clone = pickle.loads(pickle.dumps(ShardWriter(None, 1, 2)))
    assert (clone.shard_idx, clone.num_shards) == (1, 2)


def test_sharded_state_dict_roundtrip_resumes_routing():
    sr = ShardedReplay.from_factory(_uniform_factory(), 3)
    for i in range(7):
        sr.insert(i)
    sr.sample(2)
    state = sr.state_dict()
    fresh = ShardedReplay.from_factory(_uniform_factory(), 3)
    fresh.load_state_dict(state)
    assert fresh.insert(100) == sr.insert(100)
    assert [s.size() for s in fresh.shards] == [s.size() for s in sr.shards]
    with pytest.raises(ValueError, match="shard count"):
        ShardedReplay.from_factory(_uniform_factory(), 2).load_state_dict(
            state)


# --------------------------------------------------------------- unit tests
def test_round_robin_routing_balances_shards():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    for i in range(20):
        sr.insert(i)
    assert [s.size() for s in sr.shards] == [5, 5, 5, 5]
    assert sr.size() == 20


def test_hash_routing_balances_shards():
    sr = ShardedReplay.from_factory(_uniform_factory(10_000), 4,
                                    routing="hash")
    for i in range(1000):
        sr.insert(i)
    sizes = [s.size() for s in sr.shards]
    assert min(sizes) > 150, sizes


def test_global_keys_encode_owning_shard():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    keys = [sr.insert({"v": i}) for i in range(16)]
    assert len(set(keys)) == 16, "global keys must be unique"
    for i, key in enumerate(keys):
        idx, local = sr.shard_of(key), key // sr.num_shards
        assert idx == i % 4                   # round-robin placement
        assert sr.shards[idx]._items[local].data == {"v": i}


def test_sampled_items_carry_global_keys_and_scaled_probs():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    for i in range(16):
        sr.insert(i)
    for item, prob in sr.sample(8):
        idx, local = sr.shard_of(item.key), item.key // 4
        assert sr.shards[idx]._items[local].data == item.data
        # per-shard uniform prob (1/4) scaled by the shard mixture (1/4)
        assert prob == pytest.approx(1 / 16)


def test_update_priorities_routes_to_owning_shard():
    sr = ShardedReplay.from_factory(
        lambda: Table("t", 100, Prioritized(priority_exponent=1.0),
                      MinSize(1)), 4)
    keys = [sr.insert(i, priority=1.0) for i in range(8)]
    sr.update_priorities(keys, [float(10 + i) for i in range(8)])
    for i, key in enumerate(keys):
        idx, local = sr.shard_of(key), key // 4
        assert sr.shards[idx]._items[local].priority == float(10 + i)


def test_interleaved_sampling_touches_every_shard():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    for i in range(8):
        sr.insert(i)
    shards_hit = {sr.shard_of(item.key) for item, _ in sr.sample(8)}
    assert shards_hit == {0, 1, 2, 3}


def test_aggregate_stats_and_stop():
    sr = ShardedReplay.from_factory(_uniform_factory(), 2)
    for i in range(10):
        sr.insert(i)
    sr.sample(4)
    stats = sr.stats()
    assert stats["num_shards"] == 2
    assert stats["inserts"] == sr.rate_limiter.inserts == 10
    assert stats["samples"] == sr.rate_limiter.samples == 4
    assert sum(p["inserts"] for p in stats["per_shard"]) == 10
    assert not sr.stopped
    sr.stop()
    assert sr.stopped and all(s.stopped for s in sr.shards)


def test_make_replay_shards_passthrough_single():
    table = make_replay_shards(_uniform_factory(), 1)
    assert isinstance(table, Table)
    assert isinstance(make_replay_shards(_uniform_factory(), 4),
                      ShardedReplay)


def test_sharded_fifo_preserves_global_order_single_threaded():
    sr = ShardedReplay.from_factory(
        lambda: Table("q", 100, Fifo(), MinSize(1)), 4)
    for i in range(12):
        sr.insert(i)
    got = [item.data for item, _ in sr.sample(12)]
    assert got == list(range(12))


def test_sharded_queue_survives_uneven_drain():
    """An empty queue shard must block (not IndexError) until inserts
    arrive, with the admitted-but-unserved sample rolled back."""
    sr = ShardedReplay.from_factory(
        lambda: Table("q", 100, Fifo(), MinSize(2)), 3)
    for i in range(9):
        sr.insert(i)
    sr.sample(7)
    sr.sample(2)   # table now empty on some shards
    with pytest.raises(RateLimiterTimeout):
        sr.sample(5, timeout=0.2)
    assert sr.rate_limiter.samples == 9
    sr.insert(100)  # an insert unblocks the starved shard again
    before = sr.rate_limiter.samples
    got = sr.sample(1, timeout=1.0)
    assert len(got) == 1
    assert sr.rate_limiter.samples == before + 1


def test_shard_selectors_get_distinct_rng_streams():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    for i in range(400):
        sr.insert(i)
    draws = [[s.selector.sample()[0] for _ in range(20)] for s in sr.shards]
    assert len({tuple(d) for d in draws}) == 4, (
        "shards replayed identical RNG streams")


def test_offline_builder_never_sharded():
    """Offline replay is a preloaded dataset: sharding would duplicate it
    per shard, so the execution layers pin offline builders to one table."""
    from repro_torch.agents.builders import _effective_shards

    opts = BuilderOptions(offline=True, num_replay_shards=4)
    assert _effective_shards(opts, 4) == 1
    assert _effective_shards(opts, None) == 1
    assert _effective_shards(BuilderOptions(), 4) == 4


def test_builder_options_sharding_fields():
    opts = BuilderOptions(num_replay_shards=4, prefetch_size=2)
    assert opts.num_replay_shards == 4 and opts.prefetch_size == 2
    with pytest.raises(ValueError):
        BuilderOptions(num_replay_shards=0)
    with pytest.raises(ValueError):
        BuilderOptions(prefetch_size=-1)


# ------------------------------------------------------------- stress tests
@pytest.mark.parametrize("make_table", [
    pytest.param(lambda: Table("t", 500, Uniform(0), MinSize(4)),
                 id="single_table"),
    pytest.param(lambda: ShardedReplay.from_factory(
        lambda: Table("t", 500, Uniform(0), MinSize(4)), 4),
        id="sharded_4"),
])
def test_concurrent_stress_preserves_invariants(make_table):
    """Concurrent insert/sample/update_priorities, with more threads than
    this test's share of cores and a short switch interval: size stays
    within capacity, sampled keys route to live items, nothing
    deadlocks."""
    import sys

    table = make_table()
    capacity = 500 * getattr(table, "num_shards", 1)
    errors = []
    sampled_keys = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        stop = time.time() + 1.0

        def actor(tid):
            i = 0
            while time.time() < stop:
                try:
                    table.insert({"v": np.array([tid, i])}, priority=1.0,
                                 timeout=0.2)
                except RateLimiterTimeout:
                    pass
                except Exception as e:   # noqa: BLE001 — for the assert
                    errors.append(e)
                    return
                i += 1

        def learner():
            rng = np.random.RandomState(0)
            while time.time() < stop:
                try:
                    out = table.sample(4, timeout=0.2)
                    sampled_keys.extend(item.key for item, _ in out)
                    table.update_priorities(
                        [item.key for item, _ in out],
                        [float(rng.rand()) for _ in out])
                except RateLimiterTimeout:
                    pass
                except Exception as e:   # noqa: BLE001
                    errors.append(e)
                    return

        threads = ([threading.Thread(target=actor, args=(t,))
                    for t in range(3)]
                   + [threading.Thread(target=learner) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "stress test deadlocked"
    assert not errors, errors
    assert 0 < table.size() <= capacity
    shards = getattr(table, "shards", [table])
    for shard in shards:
        # per-shard bookkeeping stayed consistent under concurrency
        assert set(shard._items) == set(shard._order)
        assert shard.size() <= shard.capacity
    if isinstance(table, ShardedReplay):
        assert table.size() == sum(s.size() for s in shards)
        assert {k % table.num_shards for k in sampled_keys} == {0, 1, 2, 3}


def test_concurrent_sharded_spi_invariant_per_shard():
    """§2.5 under sharding: each shard's own limiter holds its SPI bound."""
    spi, min_size, tol = 2.0, 8, 10.0
    sr = ShardedReplay.from_factory(
        lambda: Table("t", 10_000, Uniform(0),
                      SampleToInsertRatio(spi, min_size, tol)), 4)
    stop = time.time() + 1.0

    def actor():
        while time.time() < stop:
            try:
                sr.insert(np.zeros(2), timeout=0.2)
            except RateLimiterTimeout:
                pass

    def learner():
        while time.time() < stop:
            try:
                sr.sample(4, timeout=0.2)
            except RateLimiterTimeout:
                pass

    threads = ([threading.Thread(target=actor) for _ in range(2)]
               + [threading.Thread(target=learner) for _ in range(2)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sr.rate_limiter.inserts > 4 * min_size
    for shard in sr.shards:
        rl = shard.rate_limiter
        deficit = rl.samples - spi * (rl.inserts - min_size)
        assert abs(deficit) <= tol + spi * 8, (shard.name, deficit)


# ----------------------------------------------------------------- prefetch
def test_prefetching_dataset_direct_mode():
    table = _uniform_factory()()
    for i in range(20):
        table.insert({"obs": np.full((3,), i, np.float32)})
    ds = PrefetchingDataset(table, batch_size=4, prefetch_size=4,
                            num_threads=2)
    for _ in range(5):
        sample = next(ds)
        assert sample.data["obs"].shape == (4, 3)
        assert sample.info.keys.shape == (4,)
    ds.stop()


def test_prefetching_dataset_over_iterator():
    table = _uniform_factory()()
    for i in range(20):
        table.insert({"obs": np.full((3,), i, np.float32)})
    ds = PrefetchingDataset.over_iterator(as_iterator(table, 4))
    assert next(ds).data["obs"].shape == (4, 3)
    ds.stop()


def test_prefetching_dataset_stops_with_table():
    table = Table("t", 100, Uniform(0), MinSize(50))  # sampling blocked
    table.insert(0)
    ds = PrefetchingDataset(table, batch_size=1, prefetch_size=2)
    table.stop()
    with pytest.raises(RateLimiterTimeout, match="stopped"):
        for _ in range(100):   # bounded: must raise once workers notice
            next(ds)
    ds.stop()


def test_prefetching_dataset_over_sharded_replay():
    sr = ShardedReplay.from_factory(_uniform_factory(), 4)
    for i in range(32):
        sr.insert({"x": np.array([i], np.float32)})
    ds = PrefetchingDataset(sr, batch_size=8, prefetch_size=2,
                            num_threads=2)
    sample = next(ds)
    assert sample.data["x"].shape == (8, 1)
    assert len({int(k) % 4 for k in sample.info.keys}) == 4
    ds.stop()


def test_prefetching_dataset_close_joins_threads_and_drains():
    """close() = stop + join + drain: no sampler thread survives, no batch
    stays buffered."""
    table = Table("t", 100, Uniform(0), MinSize(1))
    for i in range(32):
        table.insert(np.full(3, i, np.float32))
    dataset = PrefetchingDataset(table, batch_size=4, prefetch_size=4,
                                 num_threads=2)
    next(dataset)
    assert not dataset.closed
    dataset.close()
    assert dataset.closed
    assert dataset.qsize() == 0
    assert all(not t.is_alive() for t in dataset._threads)
    dataset.close()   # idempotent
    table.stop()


def test_prefetching_dataset_batches_equal_reference():
    """A prefetched batch over the same table contents is the reference's
    batch: one sampler thread keeps the sample order."""
    out = {}
    for name, pkg in PACKAGES.items():
        table = pkg.Table("t", 100, pkg.Uniform(3), pkg.MinSize(1))
        for i in range(16):
            table.insert({"x": np.full(2, i, np.float32)})
        ds = pkg.PrefetchingDataset(table, batch_size=4, prefetch_size=1)
        batches = [next(ds) for _ in range(3)]
        ds.close()
        out[name] = [(b.info.keys.tolist(), b.info.probabilities.tolist(),
                      b.data["x"].tolist()) for b in batches]
    assert out["port"] == out["ref"]
