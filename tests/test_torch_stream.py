"""The port's population substrate against the reference's, on the CPU.

Scenarios, the lazy channel and the lazy proxy pools are host numpy
copied from the reference, so they are held bit for bit: device i of
every scenario, the availability mask, each ``ChannelStream`` draw and
its materialised ``ChannelModel``, ``time_to_aggregate``, the lazy
validation/public pools. The column selection and the compact ledger
are held to the port's own report selection and event ledger and to the
reference's. The streamed engine is held to the port's bucketed tier
bitwise at chunk sizes 1, 3, 7 and 64, and to the reference's streamed
tier within the engine tolerance of 1e-4 (reports exactly). Its traced
host memory is flat in the population.
"""
import functools
import tracemalloc

import numpy as np
import pytest
import torch

from repro.comm import channel as ref_channel
from repro.comm.ledger import CommLedger as RefLedger
from repro.core import selection as ref_selection
from repro.distill import proxy as ref_proxy
from repro.sim import engine as ref_engine
from repro.sim import scenarios as ref_scenarios
from repro.utils.seeds import derive_stream_seed
from repro_torch.comm import channel as pt_channel
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.selection import (
    DeviceReport,
    ReportColumns,
    select,
    select_from_columns,
)
from repro_torch.distill import proxy as pt_proxy
from repro_torch.sim import engine as pt_engine
from repro_torch.sim import scenarios as pt_scenarios

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ALL_SCENARIOS = tuple(sorted(pt_scenarios.SCENARIOS))
STREAM_KW = dict(n_devices=12, seed=5, mean_samples=30, min_samples=20, dim=8)
SKEW_KW = dict(n_devices=24, seed=3, mean_samples=60, min_samples=40, dim=8, sigma=1.2)
TOL = 1e-4   # the reference's engine-tier tolerance


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(20, purpose, index))


# ----------------------------------------------------------------------
# scenarios and the channel: the reference's bits
# ----------------------------------------------------------------------

def test_the_registries_agree():
    assert ALL_SCENARIOS == tuple(sorted(ref_scenarios.SCENARIOS))
    assert len(ALL_SCENARIOS) == 6
    assert pt_scenarios.list_scenarios() == ref_scenarios.list_scenarios()


@pytest.mark.parametrize("scenario", ALL_SCENARIOS)
def test_scenario_devices_are_the_references_bits(scenario):
    pt = pt_scenarios.device_stream(scenario, **STREAM_KW)
    ref = ref_scenarios.device_stream(scenario, **STREAM_KW)
    assert pt.n_devices == ref.n_devices
    for i in range(pt.n_devices):
        a, b = pt.device(i), ref.device(i)
        assert a.x.dtype == np.float32 and a.y.dtype == np.float32
        assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()
        assert pt.available(i) == ref.available(i)
    assert pt.count_available() == ref.count_available()


@pytest.mark.parametrize("scenario", ALL_SCENARIOS)
def test_materialize_round_trips(scenario):
    stream = pt_scenarios.device_stream(scenario, **STREAM_KW)
    fed = pt_scenarios.make_federation(scenario, **STREAM_KW)
    assert fed.dataset.name == f"sim:{scenario}"
    assert fed.n_available == stream.count_available()
    for i, dev in enumerate(fed.dataset.devices):
        assert dev.x.tobytes() == stream.device(i).x.tobytes()
        assert dev.y.tobytes() == stream.device(i).y.tobytes()
        assert bool(fed.available[i]) == stream.available(i)
    with pytest.raises(IndexError):
        stream.device(stream.n_devices)


def test_unknown_scenario_raises_before_generation():
    with pytest.raises(KeyError, match="unknown scenario"):
        pt_scenarios.device_stream("nope")
    with pytest.raises(ValueError, match="wrap itself"):
        pt_scenarios.device_stream("availability", base="availability")


@pytest.mark.parametrize("fraction,seed", [(0.6, 5), (0.001, 1)])
def test_availability_mask_and_channel_equal_the_reference(fraction, seed):
    """The lazy mask (forced participant included, which a near-empty
    fraction triggers) and the materialised ``ChannelModel``."""
    kw = dict(n_devices=30, seed=seed, mean_samples=40, min_samples=30, fraction=fraction)
    pt = pt_scenarios.make_federation("availability", **kw)
    ref = ref_scenarios.make_federation("availability", **kw)
    np.testing.assert_array_equal(pt.available, ref.available)
    assert pt.n_available == ref.n_available >= 1
    assert pt.channel.bandwidth.tobytes() == ref.channel.bandwidth.tobytes()
    np.testing.assert_array_equal(pt.channel.dropped, ref.channel.dropped)
    assert pt.channel.deadline_s == ref.channel.deadline_s
    sizes = {i: 900 + 7 * i for i in range(0, 30, 4)}
    assert pt.channel.time_to_aggregate(sizes) == ref.channel.time_to_aggregate(sizes)
    stream = pt_scenarios.device_stream("availability", **kw)
    assert stream.channel.time_to_aggregate(sizes) == pt.channel.time_to_aggregate(sizes)


@pytest.mark.parametrize("seed,sigma,drop", [(0, 1.0, 0.3), (11, 1.3, 0.25), (4, 0.5, 0.0)])
def test_channel_stream_draws_equal_the_reference(seed, sigma, drop):
    kw = dict(seed=seed, mean_bandwidth=64 * 1024.0, sigma=sigma, drop_frac=drop,
              nominal_bytes=50_000, straggler_frac=0.1)
    pt = pt_channel.make_channel_stream(**kw)
    ref = ref_channel.make_channel_stream(**kw)
    assert pt.deadline_s == ref.deadline_s
    assert [pt.device_draws(i) for i in range(40)] == [ref.device_draws(i) for i in range(40)]
    model = pt.materialize(40)
    assert model.bandwidth.tobytes() == ref.materialize(40).bandwidth.tobytes()
    for nbytes in (10_000, 50_000, 400_000):
        np.testing.assert_array_equal(model.participation(nbytes),
                                      [pt.participates(i, nbytes) for i in range(40)])
    sizes = {i: 50_000 for i in range(0, 40, 3)}
    assert pt.time_to_aggregate(sizes) == model.time_to_aggregate(sizes) \
        == ref.time_to_aggregate(sizes)
    assert pt_channel.make_channel(40, **kw).bandwidth.tobytes() == model.bandwidth.tobytes()


def test_norm_ppf_and_deadline_equal_the_reference():
    ps = [1e-9, 0.001, 0.02425, 0.1, 0.5, 0.9, 0.97575, 0.999]
    assert [pt_channel._norm_ppf(p) for p in ps] == [ref_channel._norm_ppf(p) for p in ps]
    assert abs(pt_channel._norm_ppf(0.975) - 1.959963984540054) < 1e-8
    for frac in (0.0, 0.1, 0.5):
        assert pt_channel.calibrated_deadline(131072.0, 1.0, 5120, frac) \
            == ref_channel.calibrated_deadline(131072.0, 1.0, 5120, frac)
    with pytest.raises(ValueError, match="quantile"):
        pt_channel._norm_ppf(1.0)


# ----------------------------------------------------------------------
# columns and the compact ledger
# ----------------------------------------------------------------------

def _reports(seed, m=40):
    rng = _rng("reports", seed)
    # shuffled ids, repeated val_aucs / n_trains so the tie-breaks are hit
    return [
        DeviceReport(int(i), int(rng.choice([8, 20, 20, 44])),
                     float(rng.choice([0.42, 0.55, 0.7, 0.7])),
                     bool(rng.random() < 0.8))
        for i in rng.permutation(m)
    ]


@pytest.mark.parametrize("strategy", ("cv", "data", "random"))
@pytest.mark.parametrize("k", (3, 10, 40))
def test_select_from_columns_matches_select_and_the_reference(strategy, k):
    reports = _reports(1)
    in_id_order = sorted(reports, key=lambda r: r.device_id)
    cols = ReportColumns.from_reports(reports)
    kw = {"seed": 7} if strategy == "random" else {}
    got = select_from_columns(strategy, cols, k, **kw)
    assert got == select(strategy, in_id_order, k, **kw)
    ref_cols = ref_selection.ReportColumns.from_reports(
        [ref_selection.DeviceReport(r.device_id, r.n_train, r.val_auc, r.eligible)
         for r in reports])
    assert got == ref_selection.select_from_columns(strategy, ref_cols, k, **kw)


def test_select_from_columns_thresholds_and_round_trip():
    reports = sorted(_reports(2), key=lambda r: r.device_id)
    cols = ReportColumns.from_reports(_reports(2))
    assert select_from_columns("cv", cols, 10, auc_baseline=0.6) == \
        select("cv", reports, 10, auc_baseline=0.6)
    assert select_from_columns("data", cols, 10, min_train=21) == \
        select("data", reports, 10, min_train=21)
    with pytest.raises(KeyError, match="unknown strategy"):
        select_from_columns("best", cols, 3)
    assert list(cols.ids) == [r.device_id for r in reports]
    for r in reports:
        assert cols.report(r.device_id) == r
    with pytest.raises(KeyError):
        cols.report(99)


def _fill(led):
    led.record_batch("up", "metadata", 18, 1000, tag="metadata_upload")
    led.record("up", "metadata", 18, device_id=7, tag="metadata_upload")
    led.record("up", "model_upload", 555, codec="int8", tag="upload_cv_k3")
    led.record("up", "model_upload", 721, codec="int8", tag="upload_cv_k3")
    led.record("down", "student_download", 99, codec="fp16", tag="download_distilled")
    return led


def test_compact_ledger_matches_the_event_ledger_and_the_reference():
    full, compact = _fill(CommLedger()), _fill(CommLedger(compact=True))
    ref = _fill(RefLedger(compact=True))
    assert len(full) == len(compact) == len(ref) == 1004
    assert full.as_dict() == compact.as_dict() == ref.as_dict()
    assert full.summary() == compact.summary() == ref.summary()
    for q in (dict(direction="up"), dict(kind="metadata"),
              dict(tag="upload_cv_k3"), dict(direction="down", kind="student_download")):
        assert full.total(**q) == compact.total(**q) == ref.total(**q)


def test_compact_ledger_refuses_event_queries():
    compact = CommLedger(compact=True)
    compact.record("up", "metadata", 18)
    with pytest.raises(RuntimeError, match="aggregates"):
        list(compact)
    with pytest.raises(RuntimeError, match="aggregates"):
        compact.filter(direction="up")


@pytest.mark.parametrize("args", [("sideways", "metadata", 18, 2), ("up", "metadata", 18, -1),
                                  ("up", "gossip", 18, 2), ("up", "metadata", -3, 2)])
def test_record_batch_validates_as_the_reference_does(args):
    for led in (CommLedger(compact=True), CommLedger(), RefLedger(compact=True)):
        with pytest.raises(ValueError):
            led.record_batch(*args)


# ----------------------------------------------------------------------
# the streamed engine
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _skew_stream():
    return pt_scenarios.device_stream("quantity_skew", **SKEW_KW)


@functools.lru_cache(maxsize=None)
def _bucketed():
    return pt_engine.train_population(_skew_stream().materialize().dataset,
                                      mode="bucketed", seed=3, device="cpu").outcomes


def _assert_outcomes_bitwise(a, b):
    assert [o.device_id for o in a] == [o.device_id for o in b]
    for x, y in zip(a, b):
        assert x.report == y.report
        assert x.val_scores.tobytes() == y.val_scores.tobytes()
        assert x.local_test_scores.tobytes() == y.local_test_scores.tobytes()
        assert type(x.model) is type(y.model)
        if hasattr(x.model, "coef"):
            assert x.model.coef.tobytes() == y.model.coef.tobytes()
            assert x.model.support_x.tobytes() == y.model.support_x.tobytes()
            assert x.model.gamma == y.model.gamma


def test_quantity_skew_population_spans_several_buckets():
    """The case the streamed tier is held on: chunk-local groups differ
    from the population-wide ones in bucket, g and q."""
    outs = _bucketed()
    assert len({o.report.n_train for o in outs if o.report.eligible}) > 5
    assert sum(o.report.eligible for o in outs) >= 8
    assert sum(not o.report.eligible for o in outs) >= 2
    buckets = {-(-o.report.n_train // 64) * 64 for o in outs if o.report.eligible}
    assert len(buckets) >= 2


@pytest.mark.parametrize("chunk", (1, 3, 7, 64))
def test_streamed_tier_is_bitwise_the_bucketed_tier(chunk):
    got = pt_engine.train_population(_skew_stream(), mode="streamed", seed=3,
                                     chunk_devices=chunk, device="cpu")
    _assert_outcomes_bitwise(_bucketed(), got.outcomes)


def test_streamed_tier_takes_an_available_mask():
    mask = np.arange(SKEW_KW["n_devices"]) % 3 != 1
    got = pt_engine.train_population(_skew_stream(), mode="streamed", seed=3,
                                     chunk_devices=5, available=mask, device="cpu")
    want = [o for o in _bucketed() if mask[o.device_id]]
    _assert_outcomes_bitwise(want, got.outcomes)
    bucketed = pt_engine.train_population(_skew_stream(), mode="bucketed", seed=3,
                                          available=mask, device="cpu")
    _assert_outcomes_bitwise(want, bucketed.outcomes)


def test_train_selected_matches_the_full_pass():
    by_id = {o.device_id: o for o in _bucketed()}
    ids = [1, 4, 9, 11, 17, 23]
    sel = pt_engine.train_selected(_skew_stream(), ids, seed=3, device="cpu")
    assert sorted(sel) == ids
    _assert_outcomes_bitwise([by_id[i] for i in ids], [sel[i] for i in ids])


def test_streamed_engine_rejects_a_bad_chunk_and_the_sharded_tier():
    """A chunk of 0 devices raises; the sharded tier (once a raise; a
    one-rank gloo world here) takes a stream and equals the bucketed tier."""
    with pytest.raises(ValueError, match="chunk_devices"):
        list(pt_engine.iter_population(_skew_stream(), mode="streamed", chunk_devices=0,
                                       device="cpu"))
    sharded = pt_engine.train_population(_skew_stream(), mode="sharded", seed=3, device="cpu")
    _assert_outcomes_bitwise(_bucketed(), sharded.outcomes)


def test_streamed_tier_counts_chunks_and_opens_a_span_a_chunk():
    from repro_torch.obs.registry import default_registry
    from repro_torch.obs.trace import Tracer, use_tracer

    counter = default_registry().counter("engine.chunks")
    before = counter.value
    tracer = Tracer()
    with use_tracer(tracer):
        list(pt_engine.iter_population(_skew_stream(), mode="streamed", seed=3,
                                       chunk_devices=10, device="cpu"))
    chunks = [ev for ev in tracer.events if ev["name"] == "engine.chunk" and ev["ph"] == "B"]
    assert [(ev["args"]["lo"], ev["args"]["hi"]) for ev in chunks] == [(0, 10), (10, 20),
                                                                     (20, 24)]
    assert counter.value - before == 3


def test_streamed_tier_matches_the_references():
    """Reports and eligibility exactly; scores, test AUCs and
    coefficients within the engine tolerance."""
    ref = ref_engine.train_population(
        ref_scenarios.device_stream("quantity_skew", **SKEW_KW), mode="streamed", seed=3,
        chunk_devices=7).outcomes
    pt = pt_engine.train_population(_skew_stream(), mode="streamed", seed=3,
                                    chunk_devices=7, device="cpu").outcomes
    assert [o.device_id for o in pt] == [o.device_id for o in ref]
    for a, b in zip(pt, ref):
        assert (a.report.device_id, a.report.n_train, a.report.eligible) == \
            (b.report.device_id, b.report.n_train, b.report.eligible)
        assert abs(a.report.val_auc - b.report.val_auc) <= TOL
        assert abs(a.local_test_auc - b.local_test_auc) <= TOL
        np.testing.assert_allclose(a.val_scores, b.val_scores, atol=TOL, rtol=0)
        np.testing.assert_allclose(a.local_test_scores, b.local_test_scores, atol=TOL, rtol=0)
        if a.report.eligible:
            np.testing.assert_allclose(a.model.coef, b.model.coef, atol=1e-5, rtol=0)


def test_score_contraction_sums_in_an_order_fixed_by_the_bucket():
    """``_row_dot`` gives a row the same bits in any group shape, where
    the batched product (the reference's einsum) need not."""
    import torch

    rng = _rng("row-dot")
    for b in (64, 128, 192):
        kq = torch.from_numpy(rng.random((8, 40, b)).astype(np.float32))
        coef = torch.from_numpy(rng.normal(size=(8, b)).astype(np.float32))
        full = pt_engine._row_dot(kq, coef)
        alone = pt_engine._row_dot(kq[3:4, 5:13].contiguous(), coef[3:4].contiguous())
        assert full[3, 5:13].numpy().tobytes() == alone[0].numpy().tobytes()
        np.testing.assert_allclose(full.numpy(), np.einsum("gqb,gb->gq", kq.numpy().astype(
            np.float64), coef.numpy().astype(np.float64)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("codec,budget", [("fp32", None), ("int8", 9_000),
                                          ("topk:0.5", 20_000)])
def test_stream_exchange_equals_the_model_exchange(codec, budget):
    """Shape-priced picks, uploads, decoded models and ledger totals of the
    streamed round's exchange equal the materialised exchange's; only
    picked devices are ever regenerated."""
    from repro_torch.comm import ModelExchange, StreamExchange

    outs = _bucketed()
    reports = [o.report for o in outs]
    fetched = []

    def provider(ids):
        fetched.extend(ids)
        return {i: outs[i].model for i in ids}

    mat = ModelExchange({o.device_id: o.model for o in outs}, reports, codec=codec,
                        budget_bytes=budget, device="cpu")
    strm = StreamExchange(ReportColumns.from_reports(reports), provider, dim=SKEW_KW["dim"],
                          codec=codec, budget_bytes=budget, device="cpu")
    led_m, led_s = CommLedger(), CommLedger(compact=True)
    mat.record_metadata(led_m)
    strm.record_metadata(led_s)
    picked = set()
    for strategy in ("cv", "data", "random"):
        for k in (2, 5, 30):
            ids = strm.pick(strategy, k, seed=4)
            picked.update(ids)
            assert ids == mat.pick(strategy, k, seed=4)
            mat.record_uploads(led_m, ids, f"upload_{strategy}_k{k}")
            strm.record_uploads(led_s, ids, f"upload_{strategy}_k{k}")
            for i in ids:
                assert strm.upload_nbytes(i) == len(strm.upload(i)) == len(mat.upload(i))
                assert strm.upload(i) == mat.upload(i)
                assert strm.received(i).predict(outs[0].splits["test"].x).tobytes() == \
                    mat.received(i).predict(outs[0].splits["test"].x).tobytes()
    assert led_s.summary() == led_m.summary()
    assert sorted(set(fetched)) == sorted(fetched) and set(fetched) == picked


# ----------------------------------------------------------------------
# the lazy proxy pools
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lazy_hooks():
    outs = _bucketed()
    counts = {split: np.array([o.splits[split].n for o in outs], np.int64)
              for split in ("train", "val")}
    fetched = []

    def fetch_split(split, positions):
        fetched.append(sorted(int(p) for p in positions))
        return {int(p): outs[int(p)].splits[split].x for p in positions}

    return outs, counts, fetch_split, fetched


@pytest.mark.parametrize("name,n", [("validation", 40), ("validation", 10**6),
                                    ("public", 90), ("public", 7)])
def test_lazy_pool_draws_are_the_pooled_draws(name, n):
    outs, counts, fetch_split, fetched = _lazy_hooks()
    seed = derive_stream_seed(20, name, n)
    pooled = pt_proxy.make_proxy(name, n=n, rng=np.random.default_rng(seed), devices=outs)
    lazy = pt_proxy.make_proxy(name, n=n, rng=np.random.default_rng(seed),
                               split_counts=counts, fetch_split=fetch_split)
    ref = ref_proxy.make_proxy(name, n=n, rng=np.random.default_rng(seed),
                               split_counts=counts, fetch_split=fetch_split)
    assert lazy.shape == pooled.shape and lazy.tobytes() == pooled.tobytes()
    assert lazy.tobytes() == ref.tobytes()
    assert fetched[-1] == sorted(set(fetched[-1]))


def test_gaussian_proxy_refuses_a_stream():
    _, counts, fetch_split, _ = _lazy_hooks()
    with pytest.raises(ValueError, match="cannot run from a stream"):
        pt_proxy.make_proxy("gaussian", n=10, rng=np.random.default_rng(0),
                            split_counts=counts, fetch_split=fetch_split)


# ----------------------------------------------------------------------
# memory: the streamed pass's traced host peak is flat in the population
# ----------------------------------------------------------------------

def _streamed_peak_bytes(n_devices, chunk=2048):
    stream = pt_scenarios.device_stream("dirichlet", n_devices=n_devices, seed=1,
                                        mean_samples=24, min_samples=40, dim=16)
    tracemalloc.start()
    count = 0
    for update in pt_engine.iter_population(stream, mode="streamed", seed=1,
                                            chunk_devices=chunk, device="cpu"):
        count += len(update.outcomes)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert count == n_devices
    return peak


def test_streamed_pass_memory_is_flat_in_the_population():
    """25,000 -> 100,000 fallback-dominated dirichlet devices, the
    reference's sizes (``tests/test_stream.py``): the traced peak stays
    under a chunk-sized 64 MiB and does not grow with the population."""
    small = _streamed_peak_bytes(25_000)
    large = _streamed_peak_bytes(100_000)
    assert large < 64 * 2**20, f"peak {large / 2**20:.1f} MiB"
    assert large < max(1.5 * small, small + 8 * 2**20), (
        f"peak grew with the population: {small / 2**20:.1f} -> {large / 2**20:.1f} MiB")


# ----------------------------------------------------------------------
# the aggregator zoo on every tier
# ----------------------------------------------------------------------

AGG_POP = dict(scenario="dirichlet", n_devices=24, seed=0, ks=(4, 10),
               strategies=("cv", "data", "random"))
AGG_CHUNK = 7
AGGREGATORS = ("mean", "fisher", "reweight", "feature_stats")


@functools.lru_cache(maxsize=None)
def _agg_rounds(agg, codec="fp32"):
    """The reference's bucketed round and the port's three tiers (the
    streamed one in 7-device chunks) of one aggregator and codec."""
    from repro.sim import PopulationConfig as RefConfig
    from repro.sim import run_population as ref_run
    from repro_torch.sim import PopulationConfig, run_population

    ref = ref_run(RefConfig(aggregator=agg, codec=codec, engine="bucketed", **AGG_POP))
    pt = {engine: run_population(PopulationConfig(aggregator=agg, codec=codec, engine=engine,
                                                  chunk_devices=AGG_CHUNK, **AGG_POP),
                                 device="cpu")
          for engine in ("loop", "bucketed", "streamed")}
    return ref, pt


def _events(rep, kind):
    return [(e.tag, e.device_id, e.nbytes)  # repro: allow[wire-cost-honesty] reason=asserts on recorded ledger fields, as tests/test_comm.py does
            for e in rep.ledger.events if e.kind == kind]


@pytest.mark.parametrize("agg", AGGREGATORS)
def test_aggregator_rounds_equal_the_reference_on_every_tier(agg):
    """Ledgers (``total_agg_extra`` included) and picked ids exactly the
    reference's on the loop, bucketed and streamed tiers; AUCs within the
    engine tolerance; the streamed shape price equal to the encoded one."""
    ref, pt = _agg_rounds(agg)
    assert (ref.comm["total_agg_extra"] > 0) == (agg != "mean")
    for engine, rep in pt.items():
        assert rep.comm == ref.comm, engine
        assert rep.aggregator == ref.aggregator
        assert rep.ensemble_auc.keys() == ref.ensemble_auc.keys()
        for s in ref.ensemble_auc:
            assert rep.ensemble_auc[s].keys() == ref.ensemble_auc[s].keys()
            for k in ref.ensemble_auc[s]:
                assert abs(rep.ensemble_auc[s][k] - ref.ensemble_auc[s][k]) <= TOL
        assert type(rep.server_scorer).__name__ == type(ref.server_scorer).__name__
    for engine in ("loop", "bucketed"):
        for kind in ("model_upload", "agg_extra"):
            assert _events(pt[engine], kind) == _events(ref, kind), (engine, kind)


@pytest.mark.parametrize("agg", AGGREGATORS)
def test_streamed_aggregator_round_is_bitwise_the_bucketed(agg):
    _, pt = _agg_rounds(agg)
    a, b = pt["streamed"], pt["bucketed"]
    assert (a.ensemble_auc, a.comm, a.n_eligible, a.n_available, a.mean_val_auc,
            a.mean_local_auc, a.time_to_aggregate) == \
        (b.ensemble_auc, b.comm, b.n_eligible, b.n_available, b.mean_val_auc,
         b.mean_local_auc, b.time_to_aggregate)
    if hasattr(b.server_scorer, "weights"):
        assert a.server_scorer.weights.tobytes() == b.server_scorer.weights.tobytes()


@pytest.mark.parametrize("agg", ["fisher", "reweight", "feature_stats"])
def test_streamed_extras_reuse_the_regenerated_outcomes(agg, monkeypatch):
    """The extras read the streamed round's regeneration cache: every
    picked device is rebuilt once, for its upload and its extra alike, and
    its rebuilt outcome carries the val and train splits the extras read."""
    from repro_torch.sim import PopulationConfig, population, run_population

    rebuilt = []
    real = population.train_selected

    def counting(stream, ids, **kw):
        out = real(stream, ids, **kw)
        rebuilt.extend(ids)
        assert all({"train", "val"} <= set(o.splits) for o in out.values())
        return out

    monkeypatch.setattr(population, "train_selected", counting)
    rep = run_population(PopulationConfig(aggregator=agg, engine="streamed",
                                          chunk_devices=AGG_CHUNK, **AGG_POP), device="cpu")
    assert len(rebuilt) == len(set(rebuilt)) > 0
    assert rep.comm["total_agg_extra"] == _agg_rounds(agg)[1]["bucketed"].comm[
        "total_agg_extra"] > 0
