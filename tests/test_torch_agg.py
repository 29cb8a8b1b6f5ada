"""The port's aggregator zoo against the reference's, on the CPU.

  * registry — the same names, classes, specs and refusals;
  * wire — ``AggExtra`` and ``LinearSVM`` blobs byte-equal to the
    reference's in every codec, decoding in either package; the shape
    price ``agg_extra_wire_nbytes`` equal to ``len(encode())``;
  * strategies — each ``build`` on the same decoded members and extras:
    weights within 1e-12, scores within 1e-5, and the uniform and
    degenerate fallbacks bitwise the port's plain mean;
  * ``build_cell`` — exact ledgers, equal to the reference's;
  * the ``agg_bench.py --smoke`` cells through the port's
    ``run_population``, read against the committed
    ``benchmarks/agg_bench.json``: bytes exact, AUCs within 1e-4.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import agg as ref_agg
from repro.comm import wire as ref_wire
from repro.comm.exchange import ModelExchange as RefExchange
from repro.comm.ledger import CommLedger as RefLedger
from repro.core.averaging import LinearSVM as RefLinear
from repro.core.svm import ConstantModel as RefConstant
from repro.core.svm import SVMModel as RefSVM
from repro.data.federated import DeviceData as RefData
from repro.sim import make_federation as ref_make_federation
from repro.sim import train_population as ref_train
from repro.sim.engine import DeviceOutcome as RefOutcome
from repro.utils.seeds import derive_stream_seed
from repro_torch import agg as pt_agg
from repro_torch import convert
from repro_torch.comm import wire as pt_wire
from repro_torch.comm.exchange import ModelExchange
from repro_torch.comm.ledger import CommLedger
from repro_torch.core.ensemble import Ensemble
from repro_torch.core.svm import ConstantModel
from repro_torch.data.federated import DeviceData
from repro_torch.sim import PopulationConfig, make_federation, run_population, train_population
from repro_torch.sim.engine import DeviceOutcome

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DIM = 5
CODECS = ("fp32", "fp16", "int8", "topk", "topk:0.5")
EXTRA_AGGS = ("feature_stats", "fisher", "reweight")
SCORE_TOL = 1e-5
WEIGHT_TOL = 1e-12
AUC_TOL = 1e-4


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(41, purpose, index))


# ----------------------------------------------------------------------
# the same members and outcomes in both packages
# ----------------------------------------------------------------------

def _members(kind, seed, k=3, n=11, dim=DIM):
    """(reference members, port members) of one kind from the same arrays;
    int8 members are the int8 wire payloads of fp32 SVMs, decoded."""
    rng = _rng(f"members-{kind}", seed)
    if kind == "linear":
        arrays = [(rng.normal(size=dim).astype(np.float32), float(rng.normal()))
                  for _ in range(k)]
        return ([RefLinear(w=w, b=b) for w, b in arrays],
                [convert.linear_from_arrays(w, b, device="cpu") for w, b in arrays])
    arrays = [(rng.normal(size=(n + 3 * i, dim)).astype(np.float32),
               (rng.normal(size=n + 3 * i) * 0.1).astype(np.float32), 0.3 + 0.05 * i)
              for i in range(k)]
    ref = [RefSVM(support_x=s, coef=c, gamma=g) for s, c, g in arrays]
    if kind == "svm":
        return ref, [convert.svm_from_arrays(s, c, g, device="cpu") for s, c, g in arrays]
    blobs = [ref_wire.encode(m, "int8") for m in ref]
    return [ref_wire.decode(b) for b in blobs], [pt_wire.decode(b, device="cpu") for b in blobs]


def _split_arrays(rng, n, dim=DIM):
    return (rng.normal(size=(n, dim)).astype(np.float32),
            np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))


def _outcomes(seed, device_id=0, n_train=12, n_val=9, dim=DIM):
    """(reference, port) ``DeviceOutcome``s on the same splits and scores,
    shaped like the engines' without training."""
    rng = _rng("outcome", 1000 * seed + device_id)
    arrays = {k: _split_arrays(rng, n, dim)
              for k, n in (("train", n_train), ("val", n_val), ("test", 7))}
    w = rng.normal(size=dim).astype(np.float32)
    val_scores = arrays["val"][0] @ w + 0.1
    test_scores = arrays["test"][0] @ w + 0.1
    ref = RefOutcome(device_id=device_id, splits={k: RefData(*v) for k, v in arrays.items()},
                     model=RefLinear(w=w, b=0.1), report=None,
                     val_scores=val_scores, local_test_scores=test_scores)
    pt = DeviceOutcome(device_id=device_id, splits={k: DeviceData(*v) for k, v in arrays.items()},
                       model=convert.linear_from_arrays(w, 0.1, device="cpu"), report=None,
                       val_scores=val_scores, local_test_scores=test_scores)
    return ref, pt


def _extras(name, seed, k=3, codec="fp32", **kw):
    """Each member's extra, computed by each package on the same outcome,
    encoded (byte-equal) and decoded by each package."""
    ref_a, pt_a = ref_agg.get_aggregator(name), pt_agg.get_aggregator(name)
    ref_out, pt_out = [], []
    for i in range(k):
        r, p = _outcomes(seed, device_id=i, **kw)
        blob = ref_wire.encode(ref_a.device_extra(r, seed), codec)
        assert pt_wire.encode(pt_a.device_extra(p, seed), codec) == blob
        ref_out.append(ref_wire.decode(blob))
        pt_out.append(pt_wire.decode(blob, device="cpu"))
    return ref_out, pt_out


def _probe(n=37, dim=DIM):
    return _rng("probe").normal(size=(n, dim)).astype(np.float32)


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

def test_the_registries_agree():
    assert list(pt_agg.AGGREGATOR_REGISTRY) == list(ref_agg.AGGREGATOR_REGISTRY)
    for name, cls in pt_agg.AGGREGATOR_REGISTRY.items():
        ref = ref_agg.AGGREGATOR_REGISTRY[name]
        assert (cls.__name__, cls.needs_extra, cls.has_param) == \
            (ref.__name__, ref.needs_extra, ref.has_param)


@pytest.mark.parametrize("spec", ["mean", "fisher", "reweight", "reweight:10", "reweight:7.5",
                                  "feature_stats"])
def test_specs_resolve_and_round_trip(spec):
    a = pt_agg.get_aggregator(spec)
    assert a.spec == ref_agg.get_aggregator(spec).spec
    assert pt_agg.get_aggregator(a.spec).spec == a.spec
    assert pt_agg.get_aggregator(a) is a
    if a.name == "reweight":
        assert a.temperature == ref_agg.get_aggregator(spec).temperature


def test_registry_refusals():
    with pytest.raises(KeyError, match="unknown aggregator"):
        pt_agg.get_aggregator("federated_dreaming")
    with pytest.raises(ValueError, match="takes no parameter"):
        pt_agg.get_aggregator("mean:2")
    with pytest.raises(ValueError, match="duplicate aggregator"):
        @pt_agg.aggregator("mean")
        class Impostor(pt_agg.MeanAggregator):  # pragma: no cover - rejected
            pass


# ----------------------------------------------------------------------
# the wire: AggExtra and LinearSVM blobs, the shape price
# ----------------------------------------------------------------------

def _random_extra(seed):
    rng = _rng("extra-shapes", seed)
    arrays = {}
    for i in range(int(rng.integers(1, 5))):
        shape = tuple(int(s) for s in rng.integers(0, 7, int(rng.integers(1, 4))))
        arrays[f"arr{i}"] = rng.normal(size=shape).astype(np.float32)
    return arrays


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("seed", range(6))
def test_agg_extra_blobs_are_the_references_and_priced_exactly(codec, seed):
    """Random shapes (empty arrays, 1-D int8 columns included): byte-equal
    blobs, the same decoded values in either package, and the shape price
    equal to the encoded length in both."""
    arrays = _random_extra(seed)
    blob = ref_wire.encode(ref_wire.AggExtra(arrays), codec)
    pt_extra = convert.agg_extra_from_arrays(arrays)
    assert pt_wire.encode(pt_extra, codec) == blob
    shapes = {k: v.shape for k, v in arrays.items()}
    assert pt_wire.agg_extra_wire_nbytes(shapes, codec) == len(blob) == \
        ref_wire.agg_extra_wire_nbytes(shapes, codec)
    got, want = pt_wire.decode(blob, device="cpu"), ref_wire.decode(blob)
    assert list(got.arrays) == list(want.arrays)
    for name in want.arrays:
        assert got.arrays[name].dtype == np.float32
        assert got.arrays[name].shape == want.arrays[name].shape
        assert got.arrays[name].tobytes() == np.asarray(want.arrays[name]).tobytes()
    back = ref_wire.decode(pt_wire.encode(pt_extra, codec))
    assert all(back.arrays[n].tobytes() == want.arrays[n].tobytes() for n in want.arrays)


@pytest.mark.parametrize("codec", CODECS)
def test_linear_blobs_are_the_references(codec):
    rng = _rng("linear-blob", len(codec))
    for d in (1, 7, 32):
        w, b = rng.normal(size=d).astype(np.float32), float(rng.normal())
        blob = ref_wire.encode(RefLinear(w=w, b=b), codec)
        pt_model = convert.linear_from_arrays(w, b, device="cpu")
        assert pt_wire.encode(pt_model, codec) == blob
        got, want = pt_wire.decode(blob, device="cpu"), ref_wire.decode(blob)
        assert (got.w.tobytes(), got.b, got.device) == (np.asarray(want.w).tobytes(), want.b, "cpu")
        assert ref_wire.decode(pt_wire.encode(got, codec)).w.tobytes() == \
            np.asarray(ref_wire.decode(ref_wire.encode(want, codec)).w).tobytes()


def test_agg_extra_validation():
    ok = np.zeros(2, np.float32)
    for bad in ({"": ok}, {"x" * 256: ok}, {"fishér": ok}, {"s": np.float32(1.0)}):
        with pytest.raises(ValueError):
            pt_wire.AggExtra(bad)


@functools.lru_cache(maxsize=None)
def _trained():
    """Real engine outcomes of both packages on one federation."""
    kw = dict(n_devices=6, seed=5, mean_samples=50, min_samples=40)
    ref = ref_train(ref_make_federation("dirichlet", **kw).dataset, mode="loop", seed=2)
    pt = train_population(make_federation("dirichlet", **kw).dataset, mode="loop", seed=2,
                          device="cpu")
    return ref.outcomes, pt.outcomes


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", EXTRA_AGGS)
def test_real_device_extras_are_priced_by_their_shapes(name, codec):
    """What the materialised round records (len of the encoded extra)
    equals what the streamed round records (the pricer on n_train, n_val,
    dim), and equals the reference's price of the same device."""
    ref_out, pt_out = _trained()
    agg, ref = pt_agg.get_aggregator(name), ref_agg.get_aggregator(name)
    for o, r in zip(pt_out, ref_out):
        extra = agg.device_extra(o, seed=2)
        shapes = agg.extra_shapes(o.splits["train"].n, o.splits["val"].n,
                                  o.splits["train"].x.shape[1])
        assert {k: v.shape for k, v in extra.arrays.items()} == shapes
        assert len(pt_wire.encode(extra, codec)) == pt_wire.agg_extra_wire_nbytes(shapes, codec)
        assert len(pt_wire.encode(extra, codec)) == len(ref_wire.encode(ref.device_extra(r, 2),
                                                                         codec))


# ----------------------------------------------------------------------
# the strategies' builds on the same members and extras
# ----------------------------------------------------------------------

def _assert_same_scorer(ref, pt, probe, weights=True):
    assert type(pt).__name__ == type(ref).__name__
    if hasattr(ref, "weights"):
        np.testing.assert_allclose(pt.weights, ref.weights, atol=WEIGHT_TOL, rtol=0)
        assert pt.uniform == ref.uniform
    if isinstance(ref, RefLinear):
        assert (pt.w.tobytes(), pt.b) == (np.asarray(ref.w).tobytes(), ref.b)
    np.testing.assert_allclose(pt.predict(probe), np.asarray(ref.predict(probe)),
                               atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["svm", "q8"])
@pytest.mark.parametrize("spec", ["mean", "fisher", "reweight", "reweight:3", "feature_stats"])
def test_builds_on_kernel_members_match(spec, kind):
    ref_a, pt_a = ref_agg.get_aggregator(spec), pt_agg.get_aggregator(spec)
    ref_m, pt_m = _members(kind, seed=len(spec))
    if ref_a.needs_extra:
        ref_x, pt_x = _extras(ref_a.name, seed=7, n_val=40)
    else:
        ref_x = pt_x = [None] * len(ref_m)
    ref = ref_a.build(ref_m, ref_x, seed=7)
    pt = pt_a.build(pt_m, pt_x, seed=7, device="cpu")
    _assert_same_scorer(ref, pt, _probe())
    if spec.startswith("reweight"):
        assert not pt.uniform   # the pool tells these members apart


@pytest.mark.parametrize("spec", ["fisher", "reweight", "feature_stats"])
def test_builds_on_linear_members_match(spec):
    """Linear members: fisher fuses parameters; reweight weighs (and, as
    the reference, cannot score a weighted linear ensemble); feature_stats
    ignores the members."""
    ref_a, pt_a = ref_agg.get_aggregator(spec), pt_agg.get_aggregator(spec)
    ref_m, pt_m = _members("linear", seed=2)
    ref_x, pt_x = _extras(ref_a.name, seed=3)
    ref = ref_a.build(ref_m, ref_x, seed=3)
    pt = pt_a.build(pt_m, pt_x, seed=3, device="cpu")
    if spec == "reweight":
        np.testing.assert_allclose(pt.weights, ref.weights, atol=WEIGHT_TOL, rtol=0)
        for scorer in (ref, pt):
            with pytest.raises(TypeError, match="cannot weight"):
                scorer.predict(_probe())
    else:
        _assert_same_scorer(ref, pt, _probe())
        assert pt.device == "cpu"


def test_weighted_int8_members_score_their_scaled_coefficients():
    """Non-uniform weights scale each int8 member's host coef before the
    ensemble packs; the packed int8 scorer reads the scaled coef."""
    ref_m, pt_m = _members("q8", seed=5)
    w = np.array([0.6, 0.3, 0.1])
    ref = ref_agg.WeightedEnsemble(ref_m, w)
    pt = pt_agg.WeightedEnsemble(pt_m, w)
    probe = _probe()
    got = pt.predict(probe)
    _assert_same_scorer(ref, pt, probe)
    manual = sum(wi * np.asarray(m.predict(probe), np.float64) for wi, m in zip(w, pt_m))
    np.testing.assert_allclose(got, manual, atol=SCORE_TOL)
    assert pt.as_ensemble() is pt.as_ensemble()   # packed once, kept
    for m, s in zip(pt_m, pt.as_ensemble().members):
        np.testing.assert_array_equal(m.q, s.q)
        assert s.coef.tobytes() != m.coef.tobytes()


def _bitwise_mean(built, members, probe):
    assert built.uniform
    np.testing.assert_array_equal(built.predict(probe), Ensemble(members).predict(probe))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_uniform_weights_are_bitwise_the_mean(k):
    _, members = _members("svm", seed=k, k=k)
    we = pt_agg.WeightedEnsemble(members, np.full(k, 1.0 / k))
    _bitwise_mean(we, members, _probe())
    built = pt_agg.get_aggregator("mean").build(members, [None] * k, seed=0, device="cpu")
    assert type(built) is Ensemble


def test_degenerate_inputs_fall_back_to_the_mean():
    """Zero Fisher mass, identical members under reweight and a
    single-class pool fall back to the bitwise mean; a missing class in
    feature_stats gives the zero scorer — as in the reference."""
    probe = _probe()
    _, members = _members("svm", seed=12)
    zero = [pt_wire.AggExtra({"fisher": np.zeros(DIM, np.float32)}) for _ in members]
    _bitwise_mean(pt_agg.FisherAggregator().build(members, zero, 0, device="cpu"),
                  members, probe)

    same = [members[0]] * 3
    _, extras = _extras("reweight", seed=2)
    _bitwise_mean(pt_agg.ReweightAggregator().build(same, extras, 2, device="cpu"),
                  same, probe)

    for e in extras:
        e.arrays["vy"] = np.ones_like(e.arrays["vy"])
    _bitwise_mean(pt_agg.ReweightAggregator().build(members, extras, 3, device="cpu"),
                  members, probe)

    r, o = _outcomes(73)
    o.splits["train"].y[:] = 1.0
    r.splits["train"].y[:] = 1.0
    pt = pt_agg.FeatureStatsAggregator()
    built = pt.build([], [pt.device_extra(o, 0)], 0, device="cpu")
    ref = ref_agg.FeatureStatsAggregator().build(
        [], [ref_agg.FeatureStatsAggregator().device_extra(r, 0)], 0)
    assert built.w.tobytes() == np.zeros(DIM, np.float32).tobytes() and built.b == ref.b == 0.0
    np.testing.assert_array_equal(built.predict(probe), np.zeros(len(probe), np.float32))

    consts = pt_agg.WeightedEnsemble([ConstantModel(1.0), ConstantModel(3.0)],
                                     np.array([0.75, 0.25]))
    want = ref_agg.WeightedEnsemble([RefConstant(1.0), RefConstant(3.0)], np.array([0.75, 0.25]))
    np.testing.assert_array_equal(consts.predict(probe), want.predict(probe))


def test_weighted_ensembles_refuse_bad_weights_and_members():
    _, members = _members("svm", seed=6, k=2)
    for w in ([0.5, -0.5], [0.0, 0.0], [0.5]):
        with pytest.raises(ValueError):
            pt_agg.WeightedEnsemble(members, np.array(w))

    class Opaque:
        def predict(self, x):  # pragma: no cover - never reached
            return np.zeros(len(x))

    with pytest.raises(TypeError, match="cannot weight"):
        pt_agg.WeightedEnsemble([Opaque(), Opaque()], np.array([0.7, 0.3])).as_ensemble()


def test_fisher_fuse_linear_matches():
    ref_m, pt_m = _members("linear", seed=9, k=3)
    rng = _rng("fishers")
    fishers = [np.abs(rng.normal(size=DIM)) for _ in range(3)]
    fishers[1][2] = 0.0
    for f in (fishers, [np.zeros(DIM)] * 3):
        ref = ref_agg.fisher_fuse_linear(ref_m, f)
        pt = pt_agg.fisher_fuse_linear(pt_m, f)
        assert (pt.w.tobytes(), pt.b) == (np.asarray(ref.w).tobytes(), ref.b)
    with pytest.raises(ValueError, match="shape mismatch"):
        pt_agg.fisher_fuse_linear(pt_m[:2], [np.ones(DIM + 1)] * 2)


# ----------------------------------------------------------------------
# build_cell: decoded extras, exact ledgers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("name", ("mean",) + EXTRA_AGGS)
def test_build_cell_ledgers_equal_the_references(name, codec):
    ref_out, pt_out = _trained()
    ids = sorted(o.device_id for o in pt_out if o.report.eligible)[:3]
    rows = []
    for out, exchange, ledger_cls, mod, kw in (
            (ref_out, RefExchange, RefLedger, ref_agg, {}),
            (pt_out, ModelExchange, CommLedger, pt_agg, {"device": "cpu"})):
        by_id = {o.device_id: o for o in out}
        ex = exchange({o.device_id: o.model for o in out}, [o.report for o in out],
                      codec=codec, **kw)
        ledger = ledger_cls()
        built = mod.build_cell(mod.get_aggregator(name), ex, ids,
                               lambda want, by_id=by_id: {i: by_id[i] for i in want},
                               ledger, tag="agg_extra_test", seed=2)
        mod.build_cell(mod.get_aggregator(name), ex, ids, lambda want: by_id,
                       ledger, tag="agg_extra_test", seed=2, record=False)
        rows.append((ledger.as_dict(), ledger.summary(), type(built).__name__))
    assert rows[1] == rows[0]
    agg = pt_agg.get_aggregator(name)
    want = sum(len(pt_wire.encode(agg.device_extra(o, 2), codec))
               for o in pt_out if o.device_id in ids) if agg.needs_extra else 0
    assert rows[1][0].get("agg_extra_test", 0) == want
    assert (want > 0) == agg.needs_extra


# ----------------------------------------------------------------------
# the aggregator leaderboard's smoke cells (benchmarks/agg_bench.py)
# ----------------------------------------------------------------------

BENCH = json.loads((ROOT / "benchmarks" / "agg_bench.json").read_text())


@functools.lru_cache(maxsize=None)
def _bench_federation():
    c = BENCH["config"]
    return make_federation(c["scenarios"][0], n_devices=c["n_devices"], seed=c["seed"],
                           mean_samples=c["mean_samples"], min_samples=40)


@pytest.mark.parametrize("cell", range(len(BENCH["cells"])),
                         ids=[f"{c['codec']}-{c['aggregator']}" for c in BENCH["cells"]])
def test_agg_bench_smoke_cells_match_the_committed_leaderboard(cell):
    c, want = BENCH["config"], BENCH["cells"][cell]
    rep = run_population(PopulationConfig(
        scenario=want["scenario"], n_devices=c["n_devices"], seed=c["seed"],
        mean_samples=c["mean_samples"], min_samples=40, engine=c["engine"],
        codec=want["codec"], ks=tuple(c["ks"]), strategies=tuple(c["strategies"]),
        aggregator=want["aggregator"]), federation=_bench_federation(), device="cpu")
    total_up = int(rep.comm["total_up"])
    auc = max(rep.best.values())
    assert total_up == want["total_up_bytes"]
    assert int(rep.comm["total_agg_extra"]) == want["agg_extra_bytes"]
    assert abs(auc - want["auc"]) <= AUC_TOL
    assert abs(auc / (total_up / 1024.0) - want["auc_per_kib"]) <= AUC_TOL
    assert rep.aggregator == want["aggregator"]
