"""The port's multi-tenant fleet (``repro_torch.fleet``) against the
reference's on the CPU: the simulated clock, seeded traffic (bit for
bit), admission control, EDF batching, cache sharding, metrics
conservation and the wire-blob deployment path; the fleet's summaries
byte for byte the reference's, and the committed load curve
(``benchmarks/serve_load_bench.json``) and trace baseline
(``benchmarks/fleet_trace_baseline.json``) rebuilt byte for byte by
``chip_smoke.py``'s cell builders with the scorers on the CPU. Also the
tracer's and the registry's fleet-facing parts (``obs``)."""
import importlib.util
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from repro import fleet as ref_fleet
from repro.agg import WeightedEnsemble as RefWeighted
from repro.checkpoint import manager as ref_ckpt
from repro.comm import wire as ref_wire
from repro.core import Ensemble as RefEnsemble
from repro.core.svm import SVMModel as RefSVM
from repro.obs import registry as ref_registry
from repro.obs import trace as ref_trace
from repro.serve import EnsembleScorer as RefScorer
from repro.serve import ServeConfig as RefServeConfig
from repro.utils.seeds import derive_stream_seed
from repro_torch import fleet as pt_fleet
from repro_torch.agg import WeightedEnsemble as PtWeighted
from repro_torch.checkpoint import manager as pt_ckpt
from repro_torch.comm import wire as pt_wire
from repro_torch.core import Ensemble as PtEnsemble
from repro_torch.core.svm import SVMModel as PtSVM
from repro_torch.obs import registry as pt_registry
from repro_torch.obs import trace as pt_trace
from repro_torch.serve import EnsembleScorer, ServeConfig
from repro_torch.serve.cache import query_key

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-4   # the scorers' registry tol
SERVE = ServeConfig(max_batch=8, max_queue=256, buckets=(4, 8), cache_size=64)
REF_SERVE = RefServeConfig(max_batch=8, max_queue=256, buckets=(4, 8), cache_size=64)


def _chip_smoke():
    """chip_smoke.py's fleet cell builders (it imports the port only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _arrays(k=3, n=20, d=4, seed=0):
    rg = np.random.default_rng(derive_stream_seed(23, "members", seed))
    return [(rg.normal(0, 1, (n, d)).astype(np.float32),
             rg.normal(0, 0.1, n).astype(np.float32)) for _ in range(k)]


def _ensemble(k=3, n=20, d=4, seed=0):
    return PtEnsemble([PtSVM(sx, c, 0.2, device="cpu") for sx, c in _arrays(k, n, d, seed)])


def _ref_ensemble(k=3, n=20, d=4, seed=0):
    return RefEnsemble([RefSVM(sx, c, 0.2) for sx, c in _arrays(k, n, d, seed)])


def _registry(n_tenants=2, n_shards=2, quota=64, deadline_ms=50.0, ref=False):
    mod = ref_fleet if ref else pt_fleet
    reg = mod.TenantRegistry() if ref else mod.TenantRegistry(device="cpu")
    for i in range(n_tenants):
        reg.register(f"t{i}", (_ref_ensemble if ref else _ensemble)(seed=i),
                     serve=REF_SERVE if ref else SERVE, n_shards=n_shards,
                     slo=mod.TenantSLO(deadline_ms=deadline_ms, quota=quota))
    return reg


def _run(load, *, n_tenants=2, horizon_ms=60.0, seed=3, pool_size=64, ref=False, **reg_kw):
    mod = ref_fleet if ref else pt_fleet
    config = mod.FleetConfig(n_servers=2, max_global_queue=128)
    capacity = mod.nominal_capacity_qps(config.n_servers, REF_SERVE if ref else SERVE,
                                        config.cost)
    reg = _registry(n_tenants, ref=ref, **reg_kw)
    trace = mod.open_loop_trace(
        {name: load * capacity / n_tenants for name in reg.names()},
        horizon_ms=horizon_ms, dim=4, seed=seed, pool_size=pool_size,
    )
    return mod.ServeFleet(reg, config).run(trace, horizon_ms=horizon_ms)


def _dumps(summary) -> str:
    return json.dumps(summary, sort_keys=True)


# ----------------------------------------------------------------------
# clock / events / cost
# ----------------------------------------------------------------------

def test_clock_is_monotone():
    c = pt_fleet.SimClock()
    c.advance_to(5.0)
    c.advance_to(5.0)  # equal is fine
    assert c.now_ms == 5.0
    with pytest.raises(ValueError, match="backward"):
        c.advance_to(4.0)


def test_event_queue_orders_by_time_then_schedule():
    q = pt_fleet.EventQueue()
    q.push(2.0, "late")
    q.push(1.0, "a")
    q.push(1.0, "b")  # same time: pops in schedule order
    assert q.peek_time() == 1.0
    assert [q.pop() for _ in range(3)] == [(1.0, "a"), (1.0, "b"), (2.0, "late")]
    assert not q


def test_cost_model_is_deterministic_monotone_and_the_references():
    c, r = pt_fleet.CostModel(), ref_fleet.CostModel()
    one = c.service_ms(1, 8, 0, 1.0)
    assert one == c.service_ms(1, 8, 0, 1.0)
    assert c.service_ms(1, 32, 0, 1.0) > one
    assert c.service_ms(2, 8, 0, 1.0) > one
    assert c.service_ms(1, 8, 0, 2.0) > one
    assert c.min_service_ms(4, 1.0) <= one
    for args in [(1, 8, 0, 1.0), (3, 96, 7, 1.5), (2, 40, 13, 0.25)]:
        assert c.service_ms(*args) == r.service_ms(*args)
    assert c.min_service_ms(8, 2.0) == r.min_service_ms(8, 2.0)


def test_nearest_rank_percentiles_match_the_reference():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert pt_fleet.nearest_rank(xs, 50) == 2.0
    assert pt_fleet.nearest_rank(xs, 99) == 4.0  # always an observed value
    assert pt_fleet.nearest_rank([], 50) == 0.0
    ys = sorted(np.random.default_rng(derive_stream_seed(23, "ranks")).exponential(3.0, 37))
    for q in (1, 50, 95, 99, 100):
        assert pt_fleet.nearest_rank(ys, q) == ref_fleet.nearest_rank(ys, q)


# ----------------------------------------------------------------------
# traffic
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rates,horizon_ms,dim,seed,pool",
                         [({"a": 4000.0, "b": 2000.0}, 50.0, 4, 5, 256),
                          ({"t00": 28070.0, "t01": 28070.0, "t02": 100.0}, 30.0, 8, 7, 64),
                          ({"x": 0.0, "y": 900.0}, 80.0, 32, 0, 16)])
def test_traffic_is_the_references_bit_for_bit(rates, horizon_ms, dim, seed, pool):
    got = pt_fleet.open_loop_trace(rates, horizon_ms=horizon_ms, dim=dim, seed=seed,
                                   pool_size=pool)
    want = ref_fleet.open_loop_trace(rates, horizon_ms=horizon_ms, dim=dim, seed=seed,
                                     pool_size=pool)
    assert [(a.t_ms, a.tenant, a.row.tobytes()) for a in got] == \
        [(a.t_ms, a.tenant, a.row.tobytes()) for a in want]
    assert pt_fleet.offered_qps(got, horizon_ms) == ref_fleet.offered_qps(want, horizon_ms)
    for idx, rate in enumerate(rates.values()):
        assert pt_fleet.poisson_arrival_times(rate, horizon_ms, seed, idx).tobytes() == \
            ref_fleet.poisson_arrival_times(rate, horizon_ms, seed, idx).tobytes()
        assert pt_fleet.query_pool(pool, dim, seed, idx).tobytes() == \
            ref_fleet.query_pool(pool, dim, seed, idx).tobytes()


def test_traffic_is_seeded_and_time_sorted():
    rates = {"a": 4000.0, "b": 2000.0}
    t1 = pt_fleet.open_loop_trace(rates, horizon_ms=50.0, dim=4, seed=5)
    t2 = pt_fleet.open_loop_trace(rates, horizon_ms=50.0, dim=4, seed=5)
    assert len(t1) == len(t2) > 0
    assert all(x.t_ms == y.t_ms and x.tenant == y.tenant and
               np.array_equal(x.row, y.row) for x, y in zip(t1, t2))
    assert all(a.t_ms <= b.t_ms for a, b in zip(t1, t1[1:]))
    t3 = pt_fleet.open_loop_trace(rates, horizon_ms=50.0, dim=4, seed=6)
    assert [a.t_ms for a in t1] != [a.t_ms for a in t3]
    q = pt_fleet.offered_qps(t1, 50.0)
    assert q["a"] == pytest.approx(4000.0, rel=0.35)
    assert q["a"] > q["b"]


def test_traffic_streams_are_independent_of_registration_order():
    a_alone = [x.t_ms for x in
               pt_fleet.open_loop_trace({"a": 3000.0}, horizon_ms=30.0, dim=4, seed=1)]
    merged = pt_fleet.open_loop_trace({"b": 1000.0, "a": 3000.0}, horizon_ms=30.0,
                                      dim=4, seed=1)
    assert [x.t_ms for x in merged if x.tenant == "a"] == a_alone
    times = pt_fleet.poisson_arrival_times(3000.0, 30.0, seed=1, tenant_index=0)
    assert np.all(np.diff(times) >= 0) and times[-1] < 30.0
    pool = pt_fleet.query_pool(16, 4, seed=1)
    assert pool.shape == (16, 4) and pool.dtype == np.float32


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------

def test_registry_validation():
    with pytest.raises(ValueError, match="deadline_ms"):
        pt_fleet.TenantSLO(deadline_ms=0.0)
    with pytest.raises(ValueError, match="quota"):
        pt_fleet.TenantSLO(quota=0)
    with pytest.raises(ValueError, match="n_shards"):
        _registry(1, n_shards=0)
    with pytest.raises(ValueError, match="n_servers"):
        pt_fleet.FleetConfig(n_servers=0)
    reg = _registry(1)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("t0", _ensemble())
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.get("nope")
    with pytest.raises(ValueError, match="at least one"):
        pt_fleet.ServeFleet(pt_fleet.TenantRegistry(device="cpu"))
    assert "t0" in reg and len(reg) == 1 and reg.names() == ["t0"]
    assert reg.get("t0").scorer.device.type == "cpu"
    assert pt_fleet.FLEET_SERVE_CONFIG == ServeConfig(**vars(ref_fleet.FLEET_SERVE_CONFIG))


def test_register_wire_from_bytes_and_checkpoints_of_both_packages(tmp_path):
    """The deployment path: raw encode() bytes and save_payload
    checkpoints, written by the port or by the reference, all serve the
    live model's scores, and the reference's within SCORE_TOL."""
    model = _ensemble(seed=9)
    blob = pt_wire.encode(model, "fp32")
    assert blob == ref_wire.encode(_ref_ensemble(seed=9), "fp32")
    reg = pt_fleet.TenantRegistry(device="cpu")
    reg.register_wire("raw", blob, serve=SERVE)
    reg.register_wire("ckpt", pt_ckpt.save_payload(str(tmp_path / "pt"), blob), serve=SERVE)
    reg.register_wire("ref_ckpt", ref_ckpt.save_payload(str(tmp_path / "ref"), blob),
                      serve=SERVE)

    x = np.random.default_rng(derive_stream_seed(23, "wire")).normal(0, 1, (6, 4))
    x = x.astype(np.float32)
    want = EnsembleScorer(pt_wire.decode(blob, device="cpu"), device="cpu")(x)
    for name in ("raw", "ckpt", "ref_ckpt"):
        np.testing.assert_array_equal(reg.get(name).scorer(x), want)
    np.testing.assert_allclose(want, np.asarray(RefScorer(ref_wire.decode(blob))(x)),
                               atol=SCORE_TOL, rtol=0)


def test_shard_for_is_stable_crc32():
    key = query_key(np.arange(4, dtype=np.float32))
    assert pt_fleet.shard_for(key[2], 1) == 0
    assert pt_fleet.shard_for(key[2], 4) == zlib.crc32(key[2]) % 4
    for n in (1, 2, 3, 7):
        assert pt_fleet.shard_for(key[2], n) == ref_fleet.shard_for(key[2], n)


# ----------------------------------------------------------------------
# fleet: determinism, conservation, degradation, EDF, sharding
# ----------------------------------------------------------------------

@pytest.mark.parametrize("load,kw", [(1.5, {}), (3.0, {"quota": 16}), (0.5, {"n_tenants": 3})])
def test_summary_is_byte_identical_across_runs_and_to_the_reference(load, kw):
    a = _run(load, **kw)
    assert _dumps(a) == _dumps(_run(load, **kw))
    assert _dumps(a) == _dumps(_run(load, ref=True, **kw))


def test_conservation_under_overload():
    s = _run(3.0, quota=16)  # hard overload: queue_full + quota sheds
    for block in [s["global"], *s["tenants"].values()]:
        assert block["conserved"]
        assert block["submitted"] == block["completed"] + block["shed"]
        assert block["shed"] == (block["shed_queue_full"] + block["shed_quota"]
                                 + block["shed_hopeless"])
        assert block["completed"] == block["deadline_met"] + block["deadline_missed"]
    g = s["global"]
    assert g["shed"] > 0 and g["shed_quota"] > 0
    assert g["submitted"] == sum(t["submitted"] for t in s["tenants"].values())


def test_goodput_degrades_gracefully_under_overload():
    curve = {load: _run(load)["global"]["goodput_qps"] for load in (0.5, 1.0, 2.0)}
    assert curve[2.0] >= 0.8 * max(curve.values())
    assert curve[1.0] > curve[0.5]


def test_hopeless_requests_are_shed_not_scored():
    reg = pt_fleet.TenantRegistry(device="cpu")
    cheap = pt_fleet.CostModel().min_service_ms(min(SERVE.buckets), 1.0)
    reg.register("doomed", _ensemble(), serve=SERVE,
                 slo=pt_fleet.TenantSLO(deadline_ms=cheap / 2))
    fleet = pt_fleet.ServeFleet(reg, pt_fleet.FleetConfig(n_servers=1))
    rg = np.random.default_rng(0)
    for i in range(5):
        fleet.offer("doomed", rg.normal(0, 1, 4).astype(np.float32), float(i))
    fleet.drain()
    t = fleet.summary()["tenants"]["doomed"]
    assert t["shed_hopeless"] == 5 and t["completed"] == 0 and t["conserved"]
    assert all(st.scored_rows == 0 for st in fleet.shard_stats()["doomed"])


def _contend(first, second, slos):
    """One server: ``first`` takes it, then ``first`` and ``second`` each
    queue one request at t 0; the latencies of those two."""
    reg = pt_fleet.TenantRegistry(device="cpu")
    for i, (name, slo) in enumerate(slos.items()):
        reg.register(name, _ensemble(seed=i), serve=SERVE, slo=slo)
    fleet = pt_fleet.ServeFleet(reg, pt_fleet.FleetConfig(n_servers=1))
    rg = np.random.default_rng(0)
    for name in (first, first, second):
        fleet.offer(name, rg.normal(0, 1, 4).astype(np.float32), 0.0)
    fleet.drain()
    m = fleet.metrics.tenants
    return m[second].latencies_ms[0], m[first].latencies_ms[1]


def test_edf_scores_most_urgent_queue_first():
    tight, loose = _contend("loose", "tight", {
        "loose": pt_fleet.TenantSLO(deadline_ms=100.0),
        "tight": pt_fleet.TenantSLO(deadline_ms=10.0)})
    assert tight < loose


def test_priority_breaks_exact_deadline_ties():
    hi, lo = _contend("lo", "hi", {
        "lo": pt_fleet.TenantSLO(deadline_ms=50.0, priority=0),
        "hi": pt_fleet.TenantSLO(deadline_ms=50.0, priority=1)})
    assert hi < lo


def test_cache_shards_partition_the_key_space():
    s = _run(1.0, n_tenants=1, pool_size=48, horizon_ms=40.0)
    assert s["global"]["cache_hit_rate"] > 0
    config = pt_fleet.FleetConfig(n_servers=2, max_global_queue=128)
    capacity = pt_fleet.nominal_capacity_qps(config.n_servers, SERVE, config.cost)
    trace = pt_fleet.open_loop_trace({"t0": capacity}, horizon_ms=40.0, dim=4, seed=3,
                                     pool_size=48)
    fleet = pt_fleet.ServeFleet(_registry(1), config)
    fleet.run(trace, horizon_ms=40.0)
    caches = fleet.shard_caches()["t0"]
    keysets = [set(c._d) for c in caches]
    for i in range(len(keysets)):
        for j in range(i + 1, len(keysets)):
            assert not keysets[i] & keysets[j], "key duplicated across shards"
    for shard, keys in enumerate(keysets):
        assert all(pt_fleet.shard_for(k[2], len(caches)) == shard for k in keys)
    assert sum(map(len, keysets)) == len({query_key(a.row) for a in trace})


def test_results_match_direct_scoring_and_the_reference():
    """Under light load every admitted request's kept result equals the
    tenant scorer applied to its row alone (the plain scorer's rows do
    not depend on the bucket), and the reference's score within
    SCORE_TOL."""
    reg = _registry(1, quota=256)
    fleet = pt_fleet.ServeFleet(reg, pt_fleet.FleetConfig(n_servers=2), keep_results=True)
    trace = pt_fleet.open_loop_trace({"t0": 2000.0}, horizon_ms=30.0, dim=4, seed=11,
                                     pool_size=16)
    s = fleet.run(trace, horizon_ms=30.0)
    assert s["global"]["shed"] == 0
    assert len(fleet.results) == len(trace)
    scorer = reg.get("t0").scorer
    ref_scorer = RefScorer(_ref_ensemble(seed=0))
    rows = np.stack([a.row for a in trace])
    kept = np.array([fleet.results[rid] for rid in range(len(trace))])
    for rid, arrival in enumerate(trace):
        np.testing.assert_allclose(kept[rid], scorer(arrival.row[None])[0], atol=1e-5)
    np.testing.assert_allclose(kept, np.asarray(ref_scorer(rows)), atol=SCORE_TOL, rtol=0)


def test_offer_rejects_time_travel():
    fleet = pt_fleet.ServeFleet(_registry(1), pt_fleet.FleetConfig(n_servers=1))
    row = np.zeros(4, np.float32)
    fleet.offer("t0", row, 5.0)
    with pytest.raises(ValueError, match="backward"):
        fleet.offer("t0", row, 4.0)


def test_metrics_reject_unknown_shed_reason():
    m = pt_fleet.FleetMetrics(["t"])
    with pytest.raises(ValueError, match="shed reason"):
        m.record_shed("t", "cosmic_rays")


# ----------------------------------------------------------------------
# serve_load_bench.py's cells: the smoke grid against the live
# reference, the full sweep and the trace against the committed JSON
# ----------------------------------------------------------------------

def _ref_load_cell(n_tenants, load, *, horizon_ms, seed, pool_size, quota):
    """serve_load_bench.py's ``_run_cell`` on the reference, from the
    tenants' arrays of ``chip_smoke.load_tenants``."""
    serve = RefServeConfig(max_batch=32, max_queue=4096, buckets=(8, 32), cache_size=256)
    config = ref_fleet.FleetConfig(n_servers=2, max_global_queue=1024,
                                   cost=ref_fleet.CostModel())
    registry = ref_fleet.TenantRegistry()
    for name, cls, members in CS.load_tenants(n_tenants, seed):
        registry.register(name, RefEnsemble([RefSVM(sx, c, 0.2) for sx, c in members]),
                          slo=ref_fleet.TenantSLO(quota=quota, **CS.LOAD_CLASS_SLOS[cls]),
                          serve=serve, n_shards=2)
    capacity = ref_fleet.nominal_capacity_qps(config.n_servers, serve, config.cost)
    trace = ref_fleet.open_loop_trace(
        {name: load * capacity / n_tenants for name in registry.names()},
        horizon_ms=horizon_ms, dim=CS.LOAD_DIM, seed=seed, pool_size=pool_size)
    return ref_fleet.ServeFleet(registry, config).run(trace, horizon_ms=horizon_ms)


@pytest.mark.parametrize("load", CS.LOAD_SMOKE["loads"])
@pytest.mark.parametrize("n_tenants", CS.LOAD_SMOKE["tenant_counts"])
def test_smoke_grid_summaries_are_the_references_bytes(n_tenants, load):
    cell = {k: CS.LOAD_SMOKE[k] for k in ("horizon_ms", "seed", "pool_size", "quota")}
    got, requests, batches = CS.load_cell(n_tenants, load, device="cpu", **cell)
    assert got["global"]["conserved"] and requests == got["global"]["submitted"] > 0
    assert batches > 0
    assert _dumps(got) == _dumps(_ref_load_cell(n_tenants, load, **cell))


def test_full_load_curve_is_the_committed_json():
    """serve_load_bench.py's full sweep (3 tenant counts x 6 loads) and
    its determinism replay, rebuilt on the port: the bench's JSON, byte
    for byte, from 14,367 scorer calls."""
    text, calls = CS.load_curve("cpu", **CS.LOAD_FULL)
    assert text == (ROOT / "benchmarks" / "serve_load_bench.json").read_text()
    assert calls == 14367


def test_fleet_trace_is_the_committed_baseline():
    text, calls = CS.load_trace("cpu")
    assert text == (ROOT / "benchmarks" / "fleet_trace_baseline.json").read_text()
    events = json.loads(text)["traceEvents"]
    assert calls == 2 * sum(e["args"]["calls"] for e in events if e["name"] == "fleet.execute")
    assert {e["name"] for e in events} >= {"process_name", "fleet.execute", "fleet.shed"}


# ----------------------------------------------------------------------
# deployment: the round -> fleet handoff
# ----------------------------------------------------------------------

def _q8_pair(k=1, seed=5):
    """An int8 payload decoded by each package: (reference, port)."""
    blobs = [ref_wire.encode(RefSVM(sx, c, 0.2), "int8") for sx, c in _arrays(k, seed=seed)]
    ref = [ref_wire.decode(b) for b in blobs]
    pt = [pt_wire.decode(b, device="cpu") for b in blobs]
    return (ref[0], pt[0]) if k == 1 else (ref, pt)


def _artifacts(name):
    if name == "fp32":
        return _ref_ensemble(seed=4), _ensemble(seed=4)
    if name == "int8_student":
        return _q8_pair()
    w = np.array([0.6, 0.3, 0.1])
    if name == "weighted_fp32":
        return (RefWeighted(_ref_ensemble(seed=6).members, w),
                PtWeighted(_ensemble(seed=6).members, w))
    ref, pt = _q8_pair(k=3, seed=6)
    return RefWeighted(ref, w), PtWeighted(pt, w)


@pytest.mark.parametrize("name", ["fp32", "int8_student", "weighted_fp32", "weighted_int8"])
def test_serve_round_artifact_is_the_references(name, tmp_path):
    """The port's handoff summary (the handoff block included: codec,
    wire bytes, requests) is the reference's dict, and the scores behind
    it agree within SCORE_TOL."""
    ref_model, pt_model = _artifacts(name)
    want = ref_fleet.serve_round_artifact(ref_model, seed=1, horizon_ms=30.0,
                                          checkpoint_dir=str(tmp_path / "ref"))
    fleet, trace, handoff = pt_fleet.deploy_round_artifact(
        pt_model, seed=1, horizon_ms=30.0, keep_results=True, device="cpu",
        checkpoint_dir=str(tmp_path / "pt"))
    got = fleet.run(trace, horizon_ms=30.0)
    got["handoff"] = handoff
    assert _dumps(got) == _dumps(want)
    assert _dumps(pt_fleet.serve_round_artifact(pt_model, seed=1, horizon_ms=30.0,
                                                device="cpu")) == _dumps(want)
    assert handoff["codec"] == ("int8" if "int8" in name else "fp32")
    assert got["global"]["conserved"] and got["global"]["completed"] > 0
    assert pt_ckpt.restore_payload(str(tmp_path / "pt")) == \
        ref_ckpt.restore_payload(str(tmp_path / "ref"))
    rids = sorted(fleet.results)
    rows = np.stack([trace[rid].row for rid in rids])
    kept = np.array([fleet.results[rid] for rid in rids])
    deployed = ref_wire.decode(ref_ckpt.restore_payload(str(tmp_path / "ref")))
    np.testing.assert_allclose(kept, np.asarray(RefScorer(deployed)(rows)), atol=SCORE_TOL,
                               rtol=0)


def test_serve_round_artifact_roundtrip(tmp_path):
    out = pt_fleet.serve_round_artifact(_ensemble(seed=4), seed=1, horizon_ms=40.0,
                                        load=1.0, checkpoint_dir=str(tmp_path / "round"),
                                        device="cpu")
    h = out["handoff"]
    assert h["codec"] == "fp32" and h["wire_nbytes"] > 0 and h["requests"] > 0
    assert set(out["tenants"]) == {"premium", "batch"}
    assert out["global"]["conserved"] and out["global"]["completed"] > 0
    assert len(pt_ckpt.restore_payload(str(tmp_path / "round"))) == h["wire_nbytes"]
    again = pt_fleet.serve_round_artifact(_ensemble(seed=4), seed=1, horizon_ms=40.0,
                                          load=1.0, device="cpu")
    assert _dumps(again) == _dumps(out)


def test_server_scorer_fleet_roundtrip(tmp_path):
    """An aggregation round's scorer (fisher: a linear model) deploys
    through its wire blob to a model with the live scorer's exact scores,
    and the handoff summary is the reference's for the reference's round."""
    from repro.sim import PopulationConfig as RefConfig
    from repro.sim import run_population as ref_run
    from repro_torch.sim import PopulationConfig, run_population

    kw = dict(scenario="iid", n_devices=10, seed=1, mean_samples=50, min_samples=40,
              ks=(3,), strategies=("cv",), aggregator="fisher")
    rep = run_population(PopulationConfig(**kw), device="cpu")
    assert rep.server_scorer is not None and rep.student is None
    out = pt_fleet.serve_round_artifact(rep.server_scorer, seed=0, horizon_ms=30.0,
                                        checkpoint_dir=str(tmp_path / "round"), device="cpu")
    blob = pt_ckpt.restore_payload(str(tmp_path / "round"))
    assert len(blob) == out["handoff"]["wire_nbytes"]
    probe = np.random.default_rng(7).standard_normal((24, 16)).astype(np.float32)
    np.testing.assert_array_equal(pt_wire.decode(blob, device="cpu").predict(probe),
                                  rep.server_scorer.predict(probe))
    want = ref_fleet.serve_round_artifact(ref_run(RefConfig(**kw)).server_scorer, seed=0,
                                          horizon_ms=30.0)
    assert _dumps(out) == _dumps(want)


# ----------------------------------------------------------------------
# obs: the tracer's fleet-facing events and the registry's sections
# ----------------------------------------------------------------------

def _traced_events(mod, fleet_mod):
    """The same events through either package's tracer on a sim clock: a
    metadata event, spans, instants, complete events, a merged
    sub-tracer and a ``traced`` call."""
    clock = fleet_mod.SimClock()
    tracer = mod.Tracer(clock=mod.sim_clock(clock), process_name="fleet (simulated ms)")
    other = mod.Tracer(clock=mod.sim_clock(clock), pid=2, process_name="engine")

    @mod.traced("scored", cat="serve")
    def scored(x):
        return x + 1

    with mod.use_tracer(tracer):
        with tracer.span("outer", cat="fleet", tenant="t0", batch=np.int64(3)):
            clock.advance_to(1.25)
            tracer.instant("fleet.shed", cat="fleet", reason="quota")
            tracer.complete("fleet.execute", ts_us=1250.0, dur_us=660.0, cat="fleet",
                            calls=1, bucket_rows=8, occupancy=np.float64(0.5))
            assert scored(2) == 3
        clock.advance_to(2.5)
        other.instant("comm.upload", ts_us=7.0, nbytes=18)
        other.complete("engine.group", ts_us=0.0, dur_us=2.0)
        tracer.merge(other)
    assert scored(1) == 2   # no tracer installed: no events
    mod.NULL_TRACER.complete("x", ts_us=0.0, dur_us=1.0)
    return tracer


def test_tracer_json_is_the_references():
    got = _traced_events(pt_trace, pt_fleet)
    want = _traced_events(ref_trace, ref_fleet)
    assert got.to_json() == want.to_json()
    names = [(e["ph"], e["name"]) for e in got.events]
    assert names[0] == ("M", "process_name")
    assert ("B", "scored") in names and ("E", "scored") in names
    assert sum(ph == "X" for ph, _ in names) == 2 and len(got.events) == 10
    with pytest.raises(TypeError, match="typed attribute"):
        got.complete("bad", ts_us=0.0, dur_us=1.0, rows=[1, 2])


def test_registry_sections_and_envelope_are_the_references():
    from repro.comm.ledger import CommLedger as RefLedger
    from repro_torch.comm.ledger import CommLedger

    summary = _run(1.5)
    fleet = pt_fleet.ServeFleet(_registry(1), pt_fleet.FleetConfig(n_servers=1))
    fleet.offer("t0", np.zeros(4, np.float32), 0.0)
    fleet.drain()
    stats = fleet.shard_stats()["t0"]
    out = []
    for reg_mod, ledger in ((pt_registry, CommLedger(compact=True)),
                            (ref_registry, RefLedger(compact=True))):
        ledger.record("up", "model_upload", 120, tag="upload", device_id=3)
        ledger.record("down", "ensemble_download", 480, tag="download_ensemble")
        reg = reg_mod.MetricsRegistry()
        reg.counter("engine.devices_trained").inc(512)
        reg.gauge("fleet.load").set(np.float64(1.5))
        reg.histogram("fleet.p99_ms").observe(3.0)
        with pytest.raises(TypeError, match="is a gauge"):
            reg.counter("fleet.load")
        out.append(reg_mod.envelope(reg, comm=ledger, fleet=summary, scheduler=stats,
                                    extra={"note": "x"}))
    assert _dumps(out[0]) == _dumps(out[1])
    assert out[0]["sections"]["scheduler"]["shards"] == 2
    assert out[0]["sections"]["metrics"]["fleet"]["load"] == {"type": "gauge", "value": 1.5}
