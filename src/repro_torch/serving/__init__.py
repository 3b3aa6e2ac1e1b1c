"""repro_torch.serving: continuous-batching query serving.

The port of `repro.serving`, the request-level layer over
`repro_torch.api` sessions:

  * `scheduler` -- `AsyncGraphServer`, the continuous-batching front
    door: per-algebra rotating fixpoint batches on the session's device
    whose converged lanes retire and refill from a request queue every
    K steps, and `RotatingBatch`, the lane mechanics;
  * `cache`     -- the bounded LRU `ResultCache` keyed (graph
    fingerprint, algebra, src), plus warm-start harvesting across one
    graph update;
  * `clock`     -- injectable time (`SystemClock` / `VirtualClock`):
    under a virtual clock every scheduling decision is replayable;
  * `request`   -- `ServeRequest`, the per-query outcome record.

`cache`, `clock` and `request` are copies of the reference's modules.
"""
from repro_torch.serving.cache import CacheEntry, ResultCache
from repro_torch.serving.clock import SystemClock, VirtualClock
from repro_torch.serving.request import ServeRequest
from repro_torch.serving.scheduler import AsyncGraphServer, RotatingBatch

__all__ = [
    "AsyncGraphServer", "RotatingBatch",
    "ResultCache", "CacheEntry",
    "ServeRequest",
    "SystemClock", "VirtualClock",
]
