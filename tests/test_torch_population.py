"""The port's ``run_population`` against the reference's, on the CPU.

The port's streamed round equals its bucketed round in every report
field (the student's coefficients bit for bit); against the reference,
``comm``, the picked ids, the headcounts and ``time_to_aggregate`` are
exactly equal and the AUCs agree within the engine tolerance of 1e-4.
Three rounds: the reference's own streamed-round test (availability, 30
devices, fp16, a 60,000-byte budget, dense distillation on the
validation proxy), an int8 round with CG distillation on the
``scenario`` proxy, and a quantity-skew fp32 round distilled on the
``public`` pool.
"""
import functools

import numpy as np
import pytest
import torch

from repro.distill import DistillConfig as RefDistill
from repro.sim import PopulationConfig as RefConfig
from repro.sim import run_population as ref_run
from repro_torch.distill import DistillConfig as PtDistill
from repro_torch.sim import PopulationConfig as PtConfig
from repro_torch.sim import run_population as pt_run

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

TOL = 1e-4   # the reference's engine-tier tolerance
CASES = {
    # tests/test_stream.py's streamed-round test
    "availability-fp16-budget-dense": dict(
        scenario="availability", n_devices=30, seed=3, mean_samples=55, min_samples=40,
        ks=(3,), strategies=("cv", "data", "random"), codec="fp16", budget_bytes=60_000,
        eval_device_cap=12, distill=dict(proxy_size=32, solver="dense", proxy="validation")),
    "dirichlet-int8-cg-scenario": dict(
        scenario="dirichlet", n_devices=40, seed=1, mean_samples=60, min_samples=40, dim=8,
        ks=(2, 5), codec="int8", eval_device_cap=16,
        distill=dict(proxy_size=120, solver="cg", proxy="scenario")),
    "quantity_skew-fp32-public": dict(
        scenario="quantity_skew", n_devices=36, seed=2, mean_samples=70, min_samples=40,
        dim=8, scenario_params={"sigma": 1.2}, ks=(4,), eval_device_cap=10,
        distill=dict(proxy_size=64, solver="dense", proxy="public")),
}


def _config(cls, distill_cls, name, **kw):
    c = dict(CASES[name], **kw)
    return cls(distill=distill_cls(**c.pop("distill")), **c)


@functools.lru_cache(maxsize=None)
def _rounds(name):
    ref = ref_run(_config(RefConfig, RefDistill, name, engine="bucketed"))
    bucketed = pt_run(_config(PtConfig, PtDistill, name, engine="bucketed"), device="cpu")
    streamed = pt_run(_config(PtConfig, PtDistill, name, engine="streamed", chunk_devices=7),
                      device="cpu")
    return ref, bucketed, streamed


def _upload_ids(rep):
    return [(e.tag, e.device_id) for e in rep.ledger.events if e.kind == "model_upload"]


def _aucs(rep):
    vals = [rep.mean_val_auc, rep.mean_local_auc]
    for s in sorted(rep.ensemble_auc):
        vals += [rep.ensemble_auc[s][k] for k in sorted(rep.ensemble_auc[s])]
    return np.asarray(vals)


@pytest.mark.parametrize("name", sorted(CASES))
def test_streamed_round_equals_bucketed_round(name):
    _, bucketed, streamed = _rounds(name)
    for field in ("n_devices", "n_available", "n_eligible", "mean_val_auc", "mean_local_auc",
                  "ensemble_auc", "comm", "time_to_aggregate", "eval_devices", "codec",
                  "student_codec", "aggregator"):
        assert getattr(streamed, field) == getattr(bucketed, field), field
    assert np.asarray(streamed.student.coef).tobytes() == \
        np.asarray(bucketed.student.coef).tobytes()
    assert streamed.ledger.compact and not bucketed.ledger.compact
    assert len(streamed.ledger) == len(bucketed.ledger)


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_matches_the_reference(name):
    ref, bucketed, _ = _rounds(name)
    assert bucketed.comm == ref.comm
    assert _upload_ids(bucketed) == _upload_ids(ref)
    assert (bucketed.n_devices, bucketed.n_available, bucketed.n_eligible, bucketed.eval_devices) \
        == (ref.n_devices, ref.n_available, ref.n_eligible, ref.eval_devices)
    assert bucketed.time_to_aggregate == ref.time_to_aggregate
    assert (bucketed.codec, bucketed.student_codec, bucketed.aggregator) == \
        (ref.codec, ref.student_codec, ref.aggregator)
    assert sorted(bucketed.ensemble_auc) == sorted(ref.ensemble_auc)
    assert {s: sorted(v) for s, v in bucketed.ensemble_auc.items()} == \
        {s: sorted(v) for s, v in ref.ensemble_auc.items()}
    np.testing.assert_allclose(_aucs(bucketed), _aucs(ref), atol=TOL, rtol=0)
    assert bucketed.best.keys() == ref.best.keys()


def test_the_budget_and_the_channel_bind():
    """The availability round prices each cell's uploads in seconds, and
    every cell's uploads stay within the byte budget."""
    ref, bucketed, _ = _rounds("availability-fp16-budget-dense")
    assert bucketed.time_to_aggregate and all(
        v > 0 for d in bucketed.time_to_aggregate.values() for v in d.values())
    assert bucketed.n_available < bucketed.n_devices
    for tag, total in bucketed.comm.items():
        if tag.startswith("upload_"):
            assert total <= 60_000


def test_unported_options_raise():
    """``engine="sharded"`` (once a raise; a one-rank gloo world here) is
    the bucketed round for every aggregator; an unknown engine raises."""
    base = dict(scenario="iid", n_devices=12, ks=(2,))
    fields = ("n_eligible", "mean_val_auc", "mean_local_auc", "ensemble_auc", "comm",
              "aggregator")
    for agg in ("mean", "fisher", "reweight", "feature_stats"):
        want = pt_run(PtConfig(engine="bucketed", aggregator=agg, **base), device="cpu")
        got = pt_run(PtConfig(engine="sharded", aggregator=agg, **base), device="cpu")
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
        assert _upload_ids(got) == _upload_ids(want)
    with pytest.raises(ValueError, match="unknown engine"):
        pt_run(PtConfig(engine="warp", **base), device="cpu")


def test_a_prebuilt_federation_or_stream_runs_on_either_engine():
    from repro_torch.sim import device_stream, make_federation

    kw = dict(n_devices=20, seed=4, mean_samples=50, min_samples=30, dim=6)
    cfg = dict(scenario="feature_shift", ks=(3,), eval_device_cap=8, **kw)
    want = pt_run(PtConfig(engine="bucketed", **cfg), device="cpu")
    for fed in (device_stream("feature_shift", **kw), make_federation("feature_shift", **kw)):
        for engine in ("bucketed", "streamed"):
            got = pt_run(PtConfig(engine=engine, chunk_devices=6, **cfg), federation=fed,
                         device="cpu")
            assert (got.ensemble_auc, got.comm, got.n_eligible) == \
                (want.ensemble_auc, want.comm, want.n_eligible)
