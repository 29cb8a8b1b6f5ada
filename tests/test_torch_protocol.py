"""The port's one-shot round against the reference's, on the CPU: equal
ledgers and picked ids, AUCs within 1e-4, the same best k; options
outside the ported slice raise."""
import functools

import numpy as np
import pytest

from repro.core.protocol import run_protocol as ref_run
from repro.data import make_dataset as ref_make
from repro_torch.core.protocol import run_protocol as pt_run
from repro_torch.data import make_dataset as pt_make

CASES = {
    "gleam": dict(scale=0.4, ks=(1, 3, 10), random_trials=2),
    "emnist": dict(scale=0.02, ks=(1, 10, 50), random_trials=2),
}


@functools.lru_cache(maxsize=None)
def _rounds(name: str):
    c = CASES[name]
    kw = dict(ks=c["ks"], random_trials=c["random_trials"])
    ref = ref_run(ref_make(name, seed=0, scale=c["scale"]), **kw)
    pt = pt_run(pt_make(name, seed=0, scale=c["scale"]), device="cpu", **kw)
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
    ref, pt = _rounds(name)
    assert type(pt.server_scorer).__name__ == type(ref.server_scorer).__name__ == "Ensemble"
    assert pt.server_scorer.k == ref.server_scorer.k
    q = pt_make(name, seed=5, scale=CASES[name]["scale"]).devices[0].x
    np.testing.assert_allclose(pt.server_scorer.predict(q), ref.server_scorer.predict(q),
                               atol=1e-4, rtol=0)


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
    ds = pt_make("gleam", seed=0, scale=c["scale"])
    _, bucketed = _rounds("gleam")
    loop = pt_run(ds, ks=c["ks"], random_trials=c["random_trials"], engine="loop",
                  device="cpu")
    assert _ids(loop) == _ids(bucketed)
    for key in bucketed.per_device:
        np.testing.assert_allclose(loop.per_device[key], bucketed.per_device[key], atol=1e-4)


@pytest.mark.parametrize("kw,item", [
    (dict(codec="int8"), "item 8"),
    (dict(budget_bytes=4096), "item 8"),
    (dict(distill_proxy=30), "item 7"),
    (dict(distill=object()), "item 7"),
    (dict(aggregator="fisher"), "item 10"),
    (dict(engine="streamed"), "item 9"),
    (dict(engine="sharded"), "item 15"),
])
def test_options_outside_the_slice_raise(kw, item):
    ds = pt_make("gleam", seed=0, scale=0.2)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {item}"):
        pt_run(ds, ks=(1,), device="cpu", **kw)
