"""repro_torch.serve — the serving path of the one-shot global model.

Copies of ``repro.serve.cache`` and ``repro.serve.scheduler`` (numpy
only) and a port of ``repro.serve.service``. Two workloads share the
scheduler:

  * the SVM-ensemble path: ``EnsembleScorer`` packs the round's model
    once on its device (default ``"cuda"``; ``device="cpu"`` runs the
    plain scorers, as the tests do) and scores each scheduler batch
    with one launch of ``csrc/ensemble_score.cu`` (``ensemble_score``,
    or ``ensemble_score_q8`` for int8 payloads). ``repro_torch.fleet``
    serves many tenants through it; ``python3 chip_smoke.py --phases
    build,fleet`` drives both on the card;
  * the LM driver ``repro_torch.launch.serve``, which submits token
    prompts as requests and scores a batch with prefill + greedy
    decode; below its score_fn, attention follows the port's kernel
    dispatch policy (``repro_torch.kernels.ops``: a CUDA tensor launches
    the hand-written kernel, a CPU tensor runs its plain version).

scheduler.py  micro-batching request scheduler: bounded queue ->
              dynamic batch assembly padded to bucket sizes -> a
              single scoring call -> responses de-multiplexed in
              submission order.
cache.py      scored-query LRU cache keyed on raw query bytes; hits
              never enter a batch.
service.py    ``EnsembleScorer`` — the scheduler's score_fn over a
              packed ensemble; ``evaluate`` streams (group, x, y)
              triples through the merge-able per-group AUC
              accumulators of ``repro_torch.utils.metrics``.

``tests/test_torch_serve.py`` holds the scorer to the reference's on
the CPU; ``tests/test_torch_fleet.py`` the fleet.
"""
from repro_torch.serve.cache import LRUCache, query_key
from repro_torch.serve.scheduler import (
    MicroBatchScheduler,
    QueueFullError,
    SchedulerStats,
    ServeConfig,
)
from repro_torch.serve.service import EnsembleScorer

__all__ = [
    "EnsembleScorer",
    "LRUCache",
    "MicroBatchScheduler",
    "QueueFullError",
    "SchedulerStats",
    "ServeConfig",
    "query_key",
]
