"""Replay (§2.5): the Reverb-lite table, its selectors and rate limiters,
the learner-facing dataset, its prefetching pipeline and the sharded
replay service.  Pure Python and numpy; batches stay numpy until a learner
moves them to its device, so replay items cross courier as numpy."""
from repro_torch.replay.dataset import (ReplaySample, SampleInfo, as_iterator,  # noqa: F401
                                        batch_from_samples, dataset_from_list)
from repro_torch.replay.prefetch import PrefetchingDataset  # noqa: F401
from repro_torch.replay.rate_limiter import (  # noqa: F401
    MinSize, RateLimiter, RateLimiterInterrupt, RateLimiterTimeout,
    SampleToInsertRatio)
from repro_torch.replay.selectors import Fifo, Lifo, Prioritized, Uniform  # noqa: F401
from repro_torch.replay.service import (REPLAY_INTERFACE, ROUTING_MODES,  # noqa: F401
                                        AggregateRateLimiter, ShardedReplay,
                                        ShardWriter, make_replay_shards)
from repro_torch.replay.table import Item, Table  # noqa: F401
