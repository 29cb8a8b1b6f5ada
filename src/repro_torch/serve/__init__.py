"""repro_torch.serve — the request-level serving control plane.

Copies of ``repro.serve.cache`` and ``repro.serve.scheduler`` (numpy
only). The LM driver ``repro_torch.launch.serve`` submits token prompts
as requests and scores a batch with prefill + greedy decode; below its
score_fn, attention follows the port's kernel dispatch policy
(``repro_torch.kernels.ops``: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs its plain version). The SVM-ensemble service
(``EnsembleScorer``) comes with ROADMAP queue 1 item 11.

scheduler.py  micro-batching request scheduler: bounded queue ->
              dynamic batch assembly padded to bucket sizes -> a
              single scoring call -> responses de-multiplexed in
              submission order.
cache.py      scored-query LRU cache keyed on raw query bytes; hits
              never enter a batch.
"""
from repro_torch.serve.cache import LRUCache, query_key
from repro_torch.serve.scheduler import (
    MicroBatchScheduler,
    QueueFullError,
    SchedulerStats,
    ServeConfig,
)

__all__ = [
    "LRUCache",
    "MicroBatchScheduler",
    "QueueFullError",
    "SchedulerStats",
    "ServeConfig",
    "query_key",
]
