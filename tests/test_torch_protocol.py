"""The port's one-shot round against the reference's, on the CPU: equal
ledgers and picked ids, AUCs within 1e-4 (the distilled student's
included), the same best k, for the fp32 round and for the int8, fp16,
topk, budgeted and distilled rounds, and for every aggregator on gleam in
fp32 and on emnist in int8 with a CG student (the extras' ledger tags
included); the sharded engine equals the bucketed one."""
import functools

import numpy as np
import pytest
import torch

from repro.core.protocol import run_protocol as ref_run
from repro.data import make_dataset as ref_make
from repro.distill import DistillConfig as RefDistill
from repro_torch.core.protocol import run_protocol as pt_run
from repro_torch.data import make_dataset as pt_make
from repro_torch.distill import DistillConfig as PtDistill

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

GLEAM = dict(data="gleam", scale=0.4, ks=(1, 3, 10), random_trials=2)
EMNIST = dict(data="emnist", scale=0.02, ks=(1, 10, 50), random_trials=2)
CASES = {
    "gleam": GLEAM,
    "emnist": EMNIST,
    "gleam-int8-cg": dict(GLEAM, codec="int8", distill=dict(proxy_size=4096, solver="cg")),
    "emnist-int8-nystrom": dict(EMNIST, codec="int8",
                                distill=dict(proxy_size=4096, solver="nystrom")),
    "gleam-fp16-dense": dict(GLEAM, codec="fp16", distill=dict(proxy_size=200, solver="dense")),
    "gleam-topk": dict(GLEAM, codec="topk"),
    "gleam-budget": dict(GLEAM, budget_bytes=12000),   # 10 uploads need ~26 kB
}
AGGREGATORS = ("mean", "fisher", "reweight", "feature_stats")
# ks (1, 10) and one random trial: the reference's int8 reweight round
# compiles its scorer once per (pool, member) shape, ~50 s at EMNIST's ks
EMNIST_AGG = dict(EMNIST, ks=(1, 10), random_trials=1, codec="int8",
                  distill=dict(proxy_size=4096, solver="cg"))
for _agg in AGGREGATORS:
    if _agg != "mean":   # "gleam" is the fp32 mean round
        CASES[f"gleam-{_agg}"] = dict(GLEAM, aggregator=_agg)
    CASES[f"emnist-int8-cg-{_agg}"] = dict(EMNIST_AGG, aggregator=_agg)


@functools.lru_cache(maxsize=None)
def _rounds(name: str):
    c = dict(CASES[name])
    data, scale, distill = c.pop("data"), c.pop("scale"), c.pop("distill", None)
    ref = ref_run(ref_make(data, seed=0, scale=scale),
                  distill=RefDistill(**distill) if distill else None, **c)
    pt = pt_run(pt_make(data, seed=0, scale=scale),
                distill=PtDistill(**distill) if distill else None, device="cpu", **c)
    return ref, pt


def _ids(res):
    return [(e.tag, e.device_id, e.nbytes)  # repro: allow[wire-cost-honesty] reason=asserts on recorded ledger fields, as tests/test_comm.py does
            for e in res.ledger.events]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ledger_and_picked_ids_are_equal(name):
    ref, pt = _rounds(name)
    assert pt.ledger.as_dict() == ref.ledger.as_dict()
    assert pt.comm_bytes == ref.comm_bytes
    assert _ids(pt) == _ids(ref)
    assert pt.ledger.summary() == ref.ledger.summary()
    assert (pt.codec, pt.aggregator) == (ref.codec, ref.aggregator)


@pytest.mark.parametrize("name", sorted(CASES))
def test_aucs_agree_and_best_k_is_the_same(name):
    ref, pt = _rounds(name)
    for attr in ("local_mean_auc", "ideal_mean_auc", "full_ensemble_auc"):
        assert abs(getattr(pt, attr) - getattr(ref, attr)) <= 1e-4, attr
    assert pt.ensemble_auc.keys() == ref.ensemble_auc.keys()
    for s in ref.ensemble_auc:
        assert pt.ensemble_auc[s].keys() == ref.ensemble_auc[s].keys()
        for k in ref.ensemble_auc[s]:
            assert abs(pt.ensemble_auc[s][k] - ref.ensemble_auc[s][k]) <= 1e-4
        assert (max(pt.ensemble_auc[s], key=pt.ensemble_auc[s].get)
                == max(ref.ensemble_auc[s], key=ref.ensemble_auc[s].get))
    assert pt.best.keys() == ref.best.keys()
    for key in ref.per_device:
        np.testing.assert_allclose(pt.per_device[key], ref.per_device[key], atol=1e-4)
    assert abs(pt.relative_gain_over_local() - ref.relative_gain_over_local()) <= 1e-3


@pytest.mark.parametrize("name", sorted(CASES))
def test_server_scorer_is_the_best_cells_ensemble(name):
    """The best cell's server scorer: the mean round's plain ``Ensemble``,
    the other aggregators' weighted ensemble or linear scorer, of the
    reference's type and size, scoring as the reference's does (fisher's
    weights follow each device's own kernel scores, so they are held
    through the scores)."""
    ref, pt = _rounds(name)
    assert type(pt.server_scorer).__name__ == type(ref.server_scorer).__name__
    if CASES[name].get("aggregator", "mean") == "mean":
        assert type(pt.server_scorer).__name__ == "Ensemble"
    if hasattr(ref.server_scorer, "k"):
        assert pt.server_scorer.k == ref.server_scorer.k
    q = pt_make(CASES[name]["data"], seed=5, scale=CASES[name]["scale"]).devices[0].x
    np.testing.assert_allclose(pt.server_scorer.predict(q), ref.server_scorer.predict(q),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(n for n in CASES if "aggregator" in CASES[n]))
def test_aggregator_extras_ride_the_ledger_once_a_canonical_cell(name):
    """Extras are priced under ``agg_extra_{strat}_k{k}``, one per device
    of each canonical cell (the random trials and the teacher rebuild
    without recording), and the ledger's extra total is the reference's."""
    ref, pt = _rounds(name)
    assert pt.aggregator == ref.aggregator == CASES[name]["aggregator"]
    extra = pt.ledger.summary()["total_agg_extra"]
    assert extra == ref.ledger.summary()["total_agg_extra"]
    assert (extra > 0) == (CASES[name]["aggregator"] != "mean")
    for e in pt.ledger.filter(kind="agg_extra"):
        strat, k = e.tag[len("agg_extra_"):].rsplit("_k", 1)
        uploads = {u.device_id for u in pt.ledger.filter(tag=f"upload_{strat}_k{k}")}
        assert e.device_id in uploads
    for tag in {e.tag for e in pt.ledger.filter(kind="agg_extra")}:
        assert len(pt.ledger.filter(tag=tag)) == \
            len(pt.ledger.filter(tag=tag.replace("agg_extra_", "upload_")))


@pytest.mark.parametrize("name", sorted(n for n in CASES if "distill" in CASES[n]))
def test_distilled_student_matches(name):
    ref, pt = _rounds(name)
    assert pt.student_codec == ref.student_codec == CASES[name]["codec"]
    assert type(pt.student).__name__ == type(ref.student).__name__
    if CASES[name]["codec"] == "int8":
        assert type(pt.student).__name__ == "QuantizedSVM"
        for attr in ("q", "scale", "zero"):
            got, want = getattr(pt.student, attr), np.asarray(getattr(ref.student, attr))
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), attr
    else:
        assert pt.student.support_x.tobytes() == np.asarray(ref.student.support_x).tobytes()
    assert pt.student.gamma == ref.student.gamma
    for tag in ("download_distilled", "download_ensemble"):
        assert len(pt.ledger.filter(tag=tag)) == 1
        assert pt.ledger.total(tag=tag) == ref.ledger.total(tag=tag) > 0
    assert abs(pt.ensemble_auc["distilled"][max(pt.ensemble_auc["distilled"])]
               - ref.ensemble_auc["distilled"][max(ref.ensemble_auc["distilled"])]) <= 1e-4


def test_budget_binds_and_packs_like_the_reference():
    ref, pt = _rounds("gleam-budget")
    for k in CASES["gleam-budget"]["ks"]:
        for strat in ("cv", "data"):
            tag = f"upload_{strat}_k{k}"
            assert pt.ledger.total(tag=tag) <= 12000
            assert pt.ledger.total(tag=tag) == ref.ledger.total(tag=tag)
    assert len(pt.ledger.filter(tag="upload_cv_k10")) < 10


def test_round_spans_cover_every_phase():
    from repro_torch.obs.trace import Tracer, use_tracer

    tracer = Tracer()
    with use_tracer(tracer):
        pt_run(pt_make("gleam", seed=0, scale=0.3), ks=(1, 3), random_trials=1,
               device="cpu")
    spans = tracer.span_seconds()
    assert {"round.train", "round.encode", "round.ideal", "round.select",
            "round.eval", "round.score", "round.auc", "engine.group"} <= set(spans)
    assert all(v >= 0 for v in spans.values())
    assert spans["round.score"] <= spans["round.select"] + spans["round.eval"] \
        + spans["round.ideal"]
    assert any(ev["name"] == "comm.metadata" for ev in tracer.events)


def test_loop_tier_round_equals_bucketed():
    c = CASES["gleam"]
    ds = pt_make(c["data"], seed=0, scale=c["scale"])
    _, bucketed = _rounds("gleam")
    loop = pt_run(ds, ks=c["ks"], random_trials=c["random_trials"], engine="loop",
                  device="cpu")
    assert _ids(loop) == _ids(bucketed)
    for key in bucketed.per_device:
        np.testing.assert_allclose(loop.per_device[key], bucketed.per_device[key], atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(engine="sharded", aggregator="reweight"),
    dict(engine="sharded", aggregator="feature_stats"),
    dict(engine="sharded", codec="int8"),
    dict(engine="sharded", aggregator="fisher"),
    dict(engine="sharded"),
])
def test_options_outside_the_slice_raise(kw):
    """The sharded engine, once a raise, now runs whatever the aggregator
    or codec (a one-rank gloo world in this process): the bucketed
    round's ledger, picked ids and AUCs, bit for bit."""
    ds = pt_make("gleam", seed=0, scale=0.2)
    got = pt_run(ds, ks=(1,), device="cpu", **kw)
    want = pt_run(ds, ks=(1,), device="cpu", **dict(kw, engine="bucketed"))
    assert got.ledger.as_dict() == want.ledger.as_dict()
    assert _ids(got) == _ids(want)
    assert (got.local_mean_auc, got.ideal_mean_auc, got.ensemble_auc) == \
        (want.local_mean_auc, want.ideal_mean_auc, want.ensemble_auc)
    for key in want.per_device:
        assert got.per_device[key].tobytes() == want.per_device[key].tobytes()


def test_scenario_proxy_without_a_scenario_raises_as_the_reference_does():
    """``run_protocol`` gives the proxy source no ``params['scenario']``
    (only ``run_population`` defaults it to its own federation): both
    packages refuse with a ValueError before any solve."""
    kw = dict(ks=(1,), random_trials=1)
    with pytest.raises(ValueError, match="params\\['scenario'\\]"):
        ref_run(ref_make("gleam", seed=0, scale=0.2),
                distill=RefDistill(proxy_size=30, proxy="scenario"), **kw)
    with pytest.raises(ValueError, match="params\\['scenario'\\]"):
        pt_run(pt_make("gleam", seed=0, scale=0.2),
               distill=PtDistill(proxy_size=30, proxy="scenario"), device="cpu", **kw)


def test_streamed_engine_round_equals_bucketed():
    """``engine="streamed"`` trains the materialised dataset through the
    streamed tier: the round is the bucketed round, field for field."""
    c = CASES["gleam"]
    ds = pt_make(c["data"], seed=0, scale=0.2)
    kw = dict(ks=c["ks"], random_trials=c["random_trials"], device="cpu")
    bucketed = pt_run(ds, **kw)
    streamed = pt_run(ds, engine="streamed", **kw)
    assert _ids(streamed) == _ids(bucketed)
    assert streamed.ensemble_auc == bucketed.ensemble_auc
    assert streamed.best == bucketed.best
    assert (streamed.local_mean_auc, streamed.ideal_mean_auc, streamed.full_ensemble_auc) \
        == (bucketed.local_mean_auc, bucketed.ideal_mean_auc, bucketed.full_ensemble_auc)
    for key in bucketed.per_device:
        np.testing.assert_array_equal(streamed.per_device[key], bucketed.per_device[key])
