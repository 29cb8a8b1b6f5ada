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


# ----------------------------------------------------------------------
# EnsembleScorer: every servable form, the port's plain scorers on the
# CPU against the reference's
# ----------------------------------------------------------------------

SCORE_TOL = 1e-4   # the scorers' registry tol


def _members(d, k=5, seed=0):
    """Ragged RBF members as arrays: 9..40 supports, gamma 1 / (d u)."""
    rng = _rng(f"members d{d}", seed)
    out = []
    for _ in range(k):
        n = int(rng.integers(9, 41))
        out.append((rng.normal(size=(n, d)).astype(np.float32),
                    rng.normal(0, 0.5, n).astype(np.float32),
                    float(1.0 / (d * rng.uniform(0.5, 2.0)))))
    return out


def _servable(form):
    """(reference model, port model) of one servable form, the same numbers."""
    from repro.agg import WeightedEnsemble as RefWeighted
    from repro.comm import wire as ref_wire
    from repro.core import Ensemble as RefEnsemble
    from repro.core.averaging import LinearSVM as RefLinear
    from repro.core.svm import SVMModel as RefSVM
    from repro_torch.agg import WeightedEnsemble
    from repro_torch.comm import wire as pt_wire
    from repro_torch.core import Ensemble, SVMModel
    from repro_torch.core.averaging import LinearSVM

    d = 32 if form.endswith("d32") else 8
    arrays = _members(d)
    ref = [RefSVM(*a) for a in arrays]
    pt = [SVMModel(*a, device="cpu") for a in arrays]
    if form.startswith("fp32"):
        return RefEnsemble(ref), Ensemble(pt)
    if form.startswith("int8"):
        blobs = [ref_wire.encode(m, "int8") for m in ref]
        qref, qpt = ([ref_wire.decode(b) for b in blobs],
                     [pt_wire.decode(b, device="cpu") for b in blobs])
        return (RefEnsemble(qref), Ensemble(qpt)) if "ensemble" in form else (qref[0], qpt[0])
    if form.startswith("svm"):
        return ref[0], pt[0]
    if form.startswith("linear"):
        w = _rng("linear w").normal(size=d).astype(np.float32)
        return RefLinear(w=w, b=0.25), LinearSVM(w, 0.25, device="cpu")
    weights = np.array([0.4, 0.3, 0.15, 0.1, 0.05])
    return RefWeighted(ref, weights), WeightedEnsemble(pt, weights)


FORMS = ("fp32 d8", "fp32 d32", "int8 ensemble d8", "int8 student d32", "svm d32",
         "linear d8", "weighted d8")


def _scorers(form):
    from repro.serve import EnsembleScorer as RefScorer
    from repro_torch.serve import EnsembleScorer

    ref_model, pt_model = _servable(form)
    return RefScorer(ref_model), EnsembleScorer(pt_model, device="cpu")


@pytest.mark.parametrize("form", FORMS)
def test_ensemble_scorer_through_scheduler_matches_reference(form):
    """Both scorers behind a scheduler with buckets 8/32/256 and the LRU
    on, fed the same repeat traffic in flushes that fill each bucket:
    scores within SCORE_TOL, equal scheduler stats and padded shapes."""
    ref, pt = _scorers(form)
    assert pt.k == ref.k and pt.device.type == "cpu"
    d = int(pt.stacked.d)
    rows = _requests(90, 400, d)
    runs = []
    for pkg, scorer in (("ref", ref), ("pt", pt)):
        sched_mod, _ = PKGS[pkg]
        sched = sched_mod.MicroBatchScheduler(scorer, sched_mod.ServeConfig(
            max_batch=256, buckets=(32, 8, 256), cache_size=64))
        outs = [sched.run(rows[a:b]) for a, b in ((0, 5), (5, 35), (35, 300), (300, 400))]
        runs.append((np.concatenate(outs), vars(sched.stats)))
    (want, want_stats), (got, got_stats) = runs
    assert got.dtype == np.float32 and got.shape == (400,)
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)
    assert got_stats == want_stats and got_stats["batches"] == 4


@pytest.mark.parametrize("form", FORMS)
def test_ensemble_scorer_evaluate_matches_reference(form):
    """Streaming per-group AUCs of the port within SCORE_TOL of the
    reference's, at chunks that split groups and at one chunk."""
    ref, pt = _scorers(form)
    rng = _rng("groups", len(form))
    d = int(pt.stacked.d)
    groups = []
    for g in range(6):
        m = int(rng.integers(3, 70))
        groups.append((g, rng.normal(size=(m, d)).astype(np.float32), rng.integers(0, 2, m)))
    for chunk in (16, 4096):
        got = pt.evaluate(groups, chunk=chunk).compute()
        want = ref.evaluate(groups, chunk=chunk).compute()
        assert got.keys() == want.keys()
        for g in want:
            assert abs(got[g] - want[g]) <= SCORE_TOL, (chunk, g)


def test_ensemble_scorer_packs_once_on_its_device_and_rejects_what_the_reference_does():
    from repro.core import ConstantModel as RefConstant
    from repro.core import Ensemble as RefEnsemble
    from repro.serve import EnsembleScorer as RefScorer
    from repro_torch.comm.wire import QuantizedStackedEnsemble
    from repro_torch.core import ConstantModel, Ensemble, StackedEnsemble
    from repro_torch.core.averaging import StackedLinear
    from repro_torch.serve import EnsembleScorer

    ref, pt = _servable("fp32 d8")
    with pytest.raises(TypeError, match="ConstantModel"):
        EnsembleScorer(Ensemble([ConstantModel(0.5)] + pt.members), device="cpu")
    with pytest.raises(TypeError, match="ConstantModel"):
        RefScorer(RefEnsemble([RefConstant(0.5)] + ref.members))
    qref, qpt = _servable("int8 ensemble d8")
    with pytest.raises(TypeError, match="QuantizedSVM"):
        EnsembleScorer(Ensemble(pt.members + qpt.members), device="cpu")
    with pytest.raises(TypeError, match="cannot serve"):
        EnsembleScorer("not a model", device="cpu")
    kinds = {form: type(_scorers(form)[1].stacked) for form in FORMS}
    assert kinds == {"fp32 d8": StackedEnsemble, "fp32 d32": StackedEnsemble,
                     "int8 ensemble d8": QuantizedStackedEnsemble,
                     "int8 student d32": QuantizedStackedEnsemble, "svm d32": StackedEnsemble,
                     "linear d8": StackedLinear, "weighted d8": StackedEnsemble}
    packed = StackedEnsemble.from_members(pt.members, device="cpu")
    scorer = EnsembleScorer(packed, device="cpu")
    assert scorer.stacked is packed and scorer.k == 5
    x = _requests(7, 7, 8)
    assert scorer.scheduler().run(x).shape == (7,)


@pytest.mark.parametrize("d", [8, 32])
def test_predict_padded_matches_predict_and_the_reference(d):
    """The pre-fusion baseline (re-pack per call, the whole padded Gram in
    plain torch) against the fused path and the reference's baseline."""
    from repro.core import Ensemble as RefEnsemble
    from repro.core.svm import SVMModel as RefSVM
    from repro_torch.core import Ensemble, SVMModel

    arrays = _members(d, k=6, seed=1)
    pt = Ensemble([SVMModel(*a, device="cpu") for a in arrays])
    ref = RefEnsemble([RefSVM(*a) for a in arrays])
    x = _rng("padded", d).normal(size=(300, d)).astype(np.float32)
    got = pt.predict_padded(x, chunk=128)
    assert got.dtype == np.float32 and got.shape == (300,)
    np.testing.assert_allclose(got, pt.predict(x), atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref.predict_padded(x, chunk=128)),
                               atol=SCORE_TOL, rtol=0)
