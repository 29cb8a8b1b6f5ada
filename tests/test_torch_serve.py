"""The port's serving control plane and LM token sources are copies of
the reference's: on the same requests and the same numpy score_fn the
port's ``MicroBatchScheduler`` gives the reference's outputs and
``SchedulerStats`` (buckets, padding, cache hits, in-flight dedup, the
bounded queue), its ``ServeConfig`` and ``LRUCache`` behave alike, and
``make_federated_lm_data`` / ``token_batches`` give byte-identical
tokens."""
import itertools

import numpy as np
import pytest

from repro.data import lm_data as ref_lm
from repro.serve import cache as ref_cache
from repro.serve import scheduler as ref_sched
from repro.utils.seeds import derive_stream_seed
from repro_torch.data import lm_data as pt_lm
from repro_torch.serve import cache as pt_cache
from repro_torch.serve import scheduler as pt_sched

PKGS = {"ref": (ref_sched, ref_cache), "pt": (pt_sched, pt_cache)}


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(17, purpose, index))


def _score_fn(calls):
    def score(batch: np.ndarray) -> np.ndarray:
        calls.append(batch.shape)
        return np.stack([batch.sum(axis=1), batch.max(axis=1)], axis=1) * 0.5
    return score


def _requests(n_unique: int, n: int, d: int = 3) -> list:
    rng = _rng("requests", n)
    uniq = rng.normal(size=(n_unique, d)).astype(np.float32)
    return [uniq[i] for i in rng.integers(0, n_unique, size=n)]


TRAFFIC = {
    # (config kwargs, unique rows, requests, flush every)
    "one-bucket": (dict(max_batch=4, max_queue=16, buckets=(4,)), 4, 4, 4),
    "padding": (dict(max_batch=8, max_queue=64, buckets=(2, 8, 4)), 50, 13, 13),
    "cached": (dict(max_batch=8, max_queue=64, buckets=(8,), cache_size=16), 6, 40, 10),
    "dedup": (dict(max_batch=16, max_queue=64, buckets=(16,), cache_size=4), 3, 16, 16),
    "evict": (dict(max_batch=4, max_queue=8, buckets=(4,), cache_size=2, max_uncollected=8),
              9, 24, 8),
}


def _drive(pkg: str, case: str):
    sched_mod, _ = PKGS[pkg]
    cfg_kw, n_unique, n, every = TRAFFIC[case]
    calls = []
    sched = sched_mod.MicroBatchScheduler(_score_fn(calls), sched_mod.ServeConfig(**cfg_kw))
    outs = []
    rows = _requests(n_unique, n)
    for start in range(0, n, every):
        chunk = rows[start:start + every]
        if case == "evict" and start == 0:
            sched.submit_many(chunk)   # never collected: evicted at the cap
            sched.flush()
            continue
        outs.append(sched.run(chunk))
    return np.concatenate(outs), calls, vars(sched.stats), len(sched.cache)


@pytest.mark.parametrize("case", sorted(TRAFFIC))
def test_scheduler_matches_reference(case):
    out, calls, stats, cached = _drive("pt", case)
    want_out, want_calls, want_stats, want_cached = _drive("ref", case)
    assert out.tobytes() == want_out.tobytes()
    assert calls == want_calls and stats == want_stats and cached == want_cached


def test_scheduler_counts_what_it_did():
    _, calls, stats, _ = _drive("pt", "padding")
    assert calls == [(8, 3), (8, 3)] and stats["padded_rows"] == 3 and stats["batches"] == 2
    _, _, stats, _ = _drive("pt", "cached")
    assert stats["answered_from_cache"] > 0
    _, calls, stats, _ = _drive("pt", "dedup")
    assert stats["deduped_in_flight"] == 13 and len(calls) == 1
    _, _, stats, _ = _drive("pt", "evict")
    assert stats["evicted_results"] > 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_queue_full_and_failed_flush_requeue(pkg):
    sched_mod, _ = PKGS[pkg]
    cfg = sched_mod.ServeConfig(max_batch=2, max_queue=3, buckets=(2,))
    fail = itertools.chain([True], itertools.repeat(False))

    def flaky(batch):
        if next(fail):
            raise RuntimeError("transient")
        return batch[:, 0]

    sched = sched_mod.MicroBatchScheduler(flaky, cfg)
    rows = [np.full(2, i, np.float32) for i in range(4)]
    with pytest.raises(sched_mod.QueueFullError):
        sched.submit_many(rows)
    tickets = sched.submit_many(rows[:3])
    with pytest.raises(sched_mod.QueueFullError):
        sched.submit(rows[3])
    with pytest.raises(RuntimeError, match="transient"):
        sched.flush()
    assert sched.flush() == 2
    assert [float(sched.result(t)) for t in tickets] == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("kw", [dict(max_batch=0), dict(max_queue=0), dict(buckets=()),
                                dict(max_batch=9, buckets=(4, 8)),
                                dict(max_queue=10, max_uncollected=5)])
def test_serve_config_rejects_what_the_reference_rejects(kw):
    for sched_mod, _ in PKGS.values():
        with pytest.raises(ValueError):
            sched_mod.ServeConfig(**kw)


def test_serve_config_buckets_and_lru_cache_match():
    a = pt_sched.ServeConfig(max_batch=8, buckets=(8, 2, 4))
    b = ref_sched.ServeConfig(max_batch=8, buckets=(8, 2, 4))
    assert a.buckets == b.buckets == (2, 4, 8)
    assert [a.bucket_for(n) for n in range(1, 9)] == [b.bucket_for(n) for n in range(1, 9)]
    row = np.arange(3, dtype=np.float32)
    assert pt_cache.query_key(row) == ref_cache.query_key(row)
    for cap in (0, 2):
        caches = [mod.LRUCache(cap) for _, mod in PKGS.values()]
        for c in caches:
            for key in "abcab":
                if c.get(key) is None:
                    c.put(key, key.upper())
        assert len({(c.hits, c.misses, len(c), "a" in c, "b" in c) for c in caches}) == 1


@pytest.mark.parametrize("n_clients,vocab,tokens,seed", [(4, 128256, 300, 0), (3, 512, 48, 5)])
def test_federated_lm_data_is_byte_identical(n_clients, vocab, tokens, seed):
    ref = ref_lm.make_federated_lm_data(n_clients, vocab, tokens, seed=seed)
    got = pt_lm.make_federated_lm_data(n_clients, vocab, tokens, seed=seed)
    assert len(got) == len(ref) == n_clients
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("length", [200, 5])
def test_token_batches_are_byte_identical(length):
    toks = pt_lm.make_federated_lm_data(1, 512, length, seed=2)[0]
    got = pt_lm.token_batches(toks, batch=3, seq_len=16, seed=4)
    want = ref_lm.token_batches(toks, batch=3, seq_len=16, seed=4)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.shape == (3, 17) and a.tobytes() == b.tobytes()
