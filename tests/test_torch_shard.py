"""The port's sharded tier on ``torch.distributed``, on the CPU.

The sharding rules equal the reference's, case for case with
``tests/test_sharding.py``. ``make_sim_mesh`` builds a one-rank gloo world
in this process; spawned gloo worlds of 2 and 4 ranks run the sharded
tier across processes. Held on every rank and at every shard count:

* against the port's bucketed tier, bit for bit: outcomes, ledgers,
  picked ids, AUCs, students and ``fed_run``'s JSON (its timings, the
  process's metrics registry and the ``engine`` / ``mesh`` keys aside);
* against the reference's bucketed tier (its sharded tier fails on this
  tree): ledger bytes and picked ids exactly, AUCs within 1e-4.
"""
import contextlib
import dataclasses
import datetime
import functools
import io
import json
import pickle
import tempfile
import traceback
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.core.protocol import run_protocol as ref_protocol
from repro.data import make_dataset as ref_make
from repro.distill import DistillConfig as RefDistill
from repro.sharding import rules as ref_rules
from repro.sim import PopulationConfig as RefConfig
from repro.sim import engine as ref_engine
from repro.sim import run_population as ref_population
from repro_torch.core.protocol import run_protocol as pt_protocol
from repro_torch.data import make_dataset as pt_make
from repro_torch.distill import DistillConfig as PtDistill
from repro_torch.launch import fed_run, make_sim_mesh, mesh_chips
from repro_torch.obs.trace import Tracer, use_tracer
from repro_torch.sharding import rules as pt_rules
from repro_torch.sim import PopulationConfig as PtConfig
from repro_torch.sim import engine as pt_engine
from repro_torch.sim import list_scenarios, make_federation, make_shard_ctx
from repro_torch.sim import run_population as pt_population

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

TOL = 1e-4   # the reference's engine-tier tolerance


# ----------------------------------------------------------------------
# the rules, case for case with tests/test_sharding.py
# ----------------------------------------------------------------------

class FakeMesh:
    """Stand-in with the attributes the rules read (no real devices)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESH = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))
SIM4 = FakeMesh((4,), ("devices",))
MESHES = {"16x16": MESH, "2x16x16": MESH3, "devices4": SIM4}


def _both(fn_name, *args, rules=None):
    """(reference's answer as a tuple, port's answer): the spec rules get
    the same table on both sides."""
    ref_args = args + ((ref_rules.ShardingRules(**rules or {}),) if rules is not None else ())
    pt_args = args + ((pt_rules.ShardingRules(**rules or {}),) if rules is not None else ())
    want = getattr(ref_rules, fn_name)(*ref_args)
    got = getattr(pt_rules, fn_name)(*pt_args)
    return (tuple(want) if isinstance(want, P) else want), got


@pytest.mark.parametrize("size,mesh,axis,want", [
    (64, "16x16", "model", "model"),
    (10, "16x16", "model", None),
    (8, "16x16", None, None),
    (32, "2x16x16", ("pod", "data"), ("pod", "data")),
    (33, "2x16x16", ("pod", "data"), None),
    (8, "devices4", "devices", "devices"),
    (6, "devices4", "devices", None),
    (8, "devices4", "model", None),
])
def test_shard_if_divisible(size, mesh, axis, want):
    ref, pt = _both("shard_if_divisible", size, MESHES[mesh], axis)
    assert pt == ref == want


SPEC_CASES = [
    # test_logical_to_spec_basic
    ((152064, 5120), ("vocab", "embed"), "16x16", {}, ("model", None)),
    ((5120, 2, 128), ("embed", "kv_heads", "head_dim"), "16x16", {}, (None, None, None)),
    ((5120, 8, 128), ("embed", "kv_heads", "head_dim"), "16x16", {}, (None, None, None)),
    ((5120, 32, 128), ("embed", "heads", "head_dim"), "16x16", {}, (None, "model", None)),
    # test_logical_to_spec_batch_folds_pod
    ((256, 4096), ("batch", "seq"), "2x16x16", {}, (("pod", "data"), None)),
    ((256, 4096), ("batch", "seq"), "16x16", {}, ("data", None)),
    ((1, 524288, 8, 128), ("batch", "kv_seq", "kv_heads", "head_dim"), "16x16", {},
     (None, None, None, None)),
    ((1, 524288, 8, 128), ("batch", "kv_seq", "kv_heads", "head_dim"), "16x16",
     {"kv_seq": "data"}, (None, "data", None, None)),
    ((128, 32768, 8, 128), ("batch", "kv_seq", "kv_heads", "head_dim"), "16x16",
     {"kv_seq": "data"}, ("data", None, None, None)),
    # test_no_axis_used_twice
    ((128, 524288), ("batch", "kv_seq"), "16x16", {}, ("data", None)),
    # the sim mesh: groups on "devices", LM axes replicated
    ((8, 64, 32), ("group", None, None), "devices4", {}, ("devices", None, None)),
    ((6, 64), ("group", None), "devices4", {}, (None, None)),
    ((8, 4096), ("batch", "mlp"), "devices4", {}, (None, None)),
    ((8,), ("group",), "16x16", {}, (None,)),
]


@pytest.mark.parametrize("shape,logical,mesh,updates,want", SPEC_CASES)
def test_logical_to_spec(shape, logical, mesh, updates, want):
    table = {"table_updates": updates} if updates else {}
    want_ref = ref_rules.logical_to_spec(shape, logical, MESHES[mesh],
                                         ref_rules.ShardingRules().replace(**table))
    got = pt_rules.logical_to_spec(shape, logical, MESHES[mesh],
                                   pt_rules.ShardingRules().replace(**table))
    assert got == tuple(want_ref) == want


def test_fsdp_rules_shard_embed_dim():
    for fsdp, want in ((False, (None, "model")), (True, ("data", "model"))):
        ref, pt = _both("logical_to_spec", (4096, 14336), ("embed", "mlp"), MESH,
                        rules={"fsdp": fsdp})
        assert pt == ref == want
    assert pt_rules.ShardingRules(fsdp=True).lookup("embed") == "data"
    assert pt_rules.ShardingRules().lookup("group") == "devices"


def test_rules_table_and_replace_match_the_reference():
    assert pt_rules.DEFAULT_RULES == ref_rules.DEFAULT_RULES
    assert pt_rules.ShardingRules().table == ref_rules.ShardingRules().table
    for name in ("table", "fsdp", "fsdp_axis", "fsdp_logical"):
        got = getattr(pt_rules.ShardingRules().replace(table_updates={"kv_seq": "data"},
                                                       fsdp=True), name)
        want = getattr(ref_rules.ShardingRules().replace(table_updates={"kv_seq": "data"},
                                                         fsdp=True), name)
        assert got == want, name
    with pytest.raises(ValueError, match="rank"):
        pt_rules.logical_to_spec((4, 4), ("embed",), MESH, pt_rules.ShardingRules())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes(mesh):
    ref, pt = _both("batch_axes", MESHES[mesh])
    assert pt == ref


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_shard_specs(mesh):
    """The sharded engine's argument specs for ranks (3, 2, 1, 1, 0): the
    fit's (xp, yp, n_real, gammas, lam)."""
    ranks = (3, 2, 1, 1, 0)
    want = ref_rules.group_shard_specs(MESHES[mesh], ranks)
    got = pt_rules.group_shard_specs(MESHES[mesh], ranks)
    assert got == tuple(tuple(p) for p in want)
    if mesh == "devices4":
        assert got == (("devices", None, None), ("devices", None), ("devices",),
                       ("devices",), ())
    else:
        assert got == ((),) * 5


# ----------------------------------------------------------------------
# the mesh in this process: a one-rank gloo world
# ----------------------------------------------------------------------

def test_make_sim_mesh_in_a_one_rank_world():
    mesh = make_sim_mesh(device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert "gloo" in dist.get_backend()
    assert mesh.axis_names == ("devices",) and mesh.devices.shape == (1,)
    assert mesh.n_shards == mesh_chips(mesh) == 1
    assert (mesh.rank, mesh.device) == (0, torch.device("cpu"))
    assert make_sim_mesh(4, device="cpu") is mesh   # capped at the world, cached
    assert make_shard_ctx(4, device="cpu").n_shards == 1
    part = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(mesh.gather(part, (2, 3)), part)


@pytest.mark.parametrize("bucket", [64, 128, 192, 256, 2048, 8192])
@pytest.mark.parametrize("shards", [1, 4])
def test_bucket_group_caps_follow_the_reference(bucket, shards):
    shard = types.SimpleNamespace(n_shards=shards)
    for group_cap in (2, 256):
        assert (pt_engine._bucket_group_caps(bucket, group_cap, shard)
                == ref_engine._bucket_group_caps(bucket, group_cap, shard))
    if shards == 4 and bucket == 8192:
        assert pt_engine._bucket_group_caps(bucket, 256, shard) == 2   # 4x the one-card cap


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


FED_KW = dict(n_devices=14, seed=2, mean_samples=55, min_samples=40)
SEED = 3
SKEW_KW = dict(n_devices=24, seed=3, mean_samples=60, min_samples=40, dim=8, sigma=1.2)


@functools.lru_cache(maxsize=None)
def _federation(scenario):
    return make_federation(scenario, **FED_KW)


@functools.lru_cache(maxsize=None)
def _bucketed(scenario):
    return pt_engine.train_population(_federation(scenario).dataset, mode="bucketed",
                                      seed=SEED, device="cpu").outcomes


@pytest.mark.parametrize("scenario", sorted(list_scenarios()))
def test_sharded_population_is_bitwise_the_bucketed_one(scenario):
    fed = _federation(scenario)
    sharded = pt_engine.train_population(fed.dataset, mode="sharded", seed=SEED,
                                         available=fed.available, device="cpu")
    bucketed = pt_engine.train_population(fed.dataset, mode="bucketed", seed=SEED,
                                          available=fed.available, device="cpu")
    assert sum(o.report.eligible for o in bucketed.outcomes) >= 1
    _assert_outcomes_bitwise(bucketed.outcomes, sharded.outcomes)


def _skew_stream():
    from repro_torch.sim import device_stream

    return device_stream("quantity_skew", **SKEW_KW)


def test_streamed_tier_with_shards_and_train_selected():
    """``iter_population(mode="streamed", shards=)`` and
    ``train_selected(shards=)`` on a population spanning several buckets."""
    want = pt_engine.train_population(_skew_stream().materialize().dataset, mode="bucketed",
                                      seed=SEED, device="cpu").outcomes
    assert len({-(-o.report.n_train // 64) for o in want if o.report.eligible}) >= 2
    for chunk in (5, 64):
        got = pt_engine.train_population(_skew_stream(), mode="streamed", seed=SEED,
                                         chunk_devices=chunk, shards=1, device="cpu")
        _assert_outcomes_bitwise(want, got.outcomes)
    ids = [1, 4, 9, 11, 17, 23]
    sel = pt_engine.train_selected(_skew_stream(), ids, seed=SEED, shards=4, device="cpu")
    by_id = {o.device_id: o for o in want}
    _assert_outcomes_bitwise([by_id[i] for i in ids], [sel[i] for i in ids])


# ----------------------------------------------------------------------
# rounds: run_protocol and run_population, fp32 and int8, every aggregator
# ----------------------------------------------------------------------

CODECS = ("fp32", "int8")
AGGREGATORS = ("mean", "fisher", "reweight", "feature_stats")
PROTOCOL = dict(ks=(1, 3), random_trials=1)
GLEAM_SCALE = 0.4


@functools.lru_cache(maxsize=None)
def _protocol(codec, aggregator, engine):
    return pt_protocol(pt_make("gleam", seed=0, scale=GLEAM_SCALE), codec=codec,
                       aggregator=aggregator, engine=engine, device="cpu", **PROTOCOL)


@functools.lru_cache(maxsize=None)
def _ref_protocol(codec, aggregator):
    return ref_protocol(ref_make("gleam", seed=0, scale=GLEAM_SCALE), codec=codec,
                        aggregator=aggregator, **PROTOCOL)


def _ids(res):
    return [(e.tag, e.device_id, e.nbytes)  # repro: allow[wire-cost-honesty] reason=asserts on recorded ledger fields, as tests/test_comm.py does
            for e in res.ledger.events]


def _protocol_aucs(res):
    vals = [res.local_mean_auc, res.ideal_mean_auc, res.full_ensemble_auc]
    for s in sorted(res.ensemble_auc):
        vals += [res.ensemble_auc[s][k] for k in sorted(res.ensemble_auc[s])]
    for key in sorted(res.per_device):
        vals += list(res.per_device[key])
    return np.asarray(vals, np.float64)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sharded_protocol_round_is_bitwise_the_bucketed_round(codec, aggregator):
    sharded, bucketed = (_protocol(codec, aggregator, e) for e in ("sharded", "bucketed"))
    assert sharded.ledger.as_dict() == bucketed.ledger.as_dict()
    assert _ids(sharded) == _ids(bucketed)
    assert sharded.ensemble_auc == bucketed.ensemble_auc and sharded.best == bucketed.best
    assert _protocol_aucs(sharded).tobytes() == _protocol_aucs(bucketed).tobytes()
    assert (sharded.codec, sharded.aggregator) == (codec, aggregator)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sharded_protocol_round_matches_the_reference_bucketed_round(codec, aggregator):
    sharded, ref = _protocol(codec, aggregator, "sharded"), _ref_protocol(codec, aggregator)
    assert sharded.ledger.as_dict() == ref.ledger.as_dict()
    assert _ids(sharded) == _ids(ref)
    assert {s: sorted(v) for s, v in sharded.ensemble_auc.items()} == \
        {s: sorted(v) for s, v in ref.ensemble_auc.items()}
    np.testing.assert_allclose(_protocol_aucs(sharded), _protocol_aucs(ref), atol=TOL, rtol=0)


def _population_config(cls, distill_cls, **kw):
    return cls(scenario="dirichlet", n_devices=FED_KW["n_devices"], seed=SEED,
               mean_samples=FED_KW["mean_samples"], min_samples=FED_KW["min_samples"],
               ks=(3,), strategies=("cv", "random"), chunk_devices=5,
               distill=distill_cls(proxy_size=48, solver="dense", proxy="validation"), **kw)


@functools.lru_cache(maxsize=None)
def _population(codec, aggregator, engine, mesh_shards=None):
    return pt_population(_population_config(PtConfig, PtDistill, codec=codec,
                                            aggregator=aggregator, engine=engine,
                                            mesh_shards=mesh_shards), device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_population_round(codec, aggregator):
    return ref_population(_population_config(RefConfig, RefDistill, codec=codec,
                                             aggregator=aggregator, engine="bucketed"))


REPORT_FIELDS = ("n_devices", "n_available", "n_eligible", "mean_val_auc", "mean_local_auc",
                 "ensemble_auc", "comm", "time_to_aggregate", "eval_devices", "codec",
                 "student_codec", "aggregator")


def _upload_ids(rep):
    return [(e.tag, e.device_id) for e in rep.ledger.events if e.kind == "model_upload"]


def _report_bits(rep):
    """Everything a population round reports but its timings, and the
    picked ids where the ledger keeps its events (the streamed round's
    compact ledger keeps totals only)."""
    return ({f: getattr(rep, f) for f in REPORT_FIELDS},
            None if rep.ledger.compact else _upload_ids(rep),
            np.asarray(rep.student.coef).tobytes())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sharded_population_round_is_bitwise_the_bucketed_round(codec, aggregator):
    bucketed = _report_bits(_population(codec, aggregator, "bucketed"))
    assert _report_bits(_population(codec, aggregator, "sharded")) == bucketed
    # the streamed round with a mesh: its passes and train_selected sharded
    streamed = _report_bits(_population(codec, aggregator, "streamed", mesh_shards=1))
    assert (streamed[0], streamed[2]) == (bucketed[0], bucketed[2])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_sharded_population_round_matches_the_reference_bucketed_round(codec, aggregator):
    pt, ref = _population(codec, aggregator, "sharded"), _ref_population_round(codec, aggregator)
    assert pt.comm == ref.comm
    assert _upload_ids(pt) == _upload_ids(ref)
    assert (pt.n_devices, pt.n_available, pt.n_eligible, pt.eval_devices) == \
        (ref.n_devices, ref.n_available, ref.n_eligible, ref.eval_devices)
    assert (pt.codec, pt.student_codec, pt.aggregator) == \
        (ref.codec, ref.student_codec, ref.aggregator)
    assert {s: sorted(v) for s, v in pt.ensemble_auc.items()} == \
        {s: sorted(v) for s, v in ref.ensemble_auc.items()}
    for s in ref.ensemble_auc:
        for k in ref.ensemble_auc[s]:
            assert abs(pt.ensemble_auc[s][k] - ref.ensemble_auc[s][k]) <= TOL
    for attr in ("mean_val_auc", "mean_local_auc"):
        assert abs(getattr(pt, attr) - getattr(ref, attr)) <= TOL


# ----------------------------------------------------------------------
# spawned gloo worlds of 2 and 4 ranks
# ----------------------------------------------------------------------

GROUP_TIMEOUT = datetime.timedelta(seconds=60)     # a collective waiting longer fails
WORLD_DEADLINE = datetime.timedelta(seconds=150)   # a world running longer is killed
WORLD_SCENARIOS = ("iid", "dirichlet", "quantity_skew")
FED_RUN_ARGV = ["--mode", "sim", "--scenario", "dirichlet", "--devices", "24", "--k", "3",
                "--mean-samples", "55", "--codec", "int8", "--aggregator", "fisher",
                "--distill-proxy", "48", "--distill-solver", "dense"]
# the seeds' independence from grouping and shard count: (label, engine kwargs)
SEED_VARIANTS = (
    ("sharded-cap256", dict(mode="sharded", group_cap=256)),
    ("sharded-cap8", dict(mode="sharded", group_cap=8)),
    ("sharded-cap2", dict(mode="sharded", group_cap=2)),
    ("sharded-2-cap8", dict(mode="sharded", group_cap=8, shards=2)),
    ("sharded-1", dict(mode="sharded", shards=1)),
    ("streamed-3", dict(mode="streamed", chunk_devices=3, shards=4)),
    ("streamed-100-2", dict(mode="streamed", chunk_devices=100, shards=2)),
)
TIMING_KEYS = ("train_seconds", "devices_per_second")


def _outcome_bits(outcomes):
    return [(o.device_id, dataclasses.astuple(o.report), o.val_scores.tobytes(),
             o.local_test_scores.tobytes(),
             *(o.splits[s].x.tobytes() for s in ("train", "val", "test")),
             o.model.coef.tobytes() if hasattr(o.model, "coef") else None,
             getattr(o.model, "gamma", None))
            for o in outcomes]


def _kernel_spans(tracer, names=("batched_rbf_gram", "sdca")):
    return {n: sum(1 for e in tracer.events if e["name"] == f"kernel.{n}") for n in names}


def _comparable(report):
    """``fed_run``'s JSON without the keys a sharded run may change: its
    timings, the process's metrics registry, ``engine`` and the mesh."""
    out = {k: v for k, v in report.items()
           if k not in TIMING_KEYS + ("engine", "mesh", "mesh_requested", "obs")}
    out["obs"] = {k: v for k, v in report["obs"]["sections"].items() if k != "metrics"}
    return json.loads(json.dumps(out))


def _fed_run(argv):
    """(JSON, printed to stdout, kernel spans) of ``fed_run.main`` on the CPU."""
    buf, tracer = io.StringIO(), Tracer()
    with contextlib.redirect_stdout(buf), use_tracer(tracer):
        report = fed_run.main(argv, device="cpu")
    return report, bool(buf.getvalue().strip()), _kernel_spans(tracer)


def _world_job(rank, world, out_path):
    """What every rank of a spawned world runs (the same on every rank)."""
    res = {"rank": rank, "world": world}
    if world == 2:
        res["populations"] = {}
        for scenario in WORLD_SCENARIOS:
            tracer = Tracer()
            with use_tracer(tracer):
                pop = pt_engine.train_population(_federation(scenario).dataset,
                                                 mode="sharded", seed=SEED, device="cpu")
            res["populations"][scenario] = (_outcome_bits(pop.outcomes), _kernel_spans(tracer))
        res["rounds"] = {
            (engine, shards): _report_bits(pt_population(_population_config(
                PtConfig, PtDistill, codec="int8", aggregator="fisher", engine=engine,
                mesh_shards=shards), device="cpu"))
            for engine, shards in (("sharded", None), ("streamed", 2))}
        res["fed_run"] = _fed_run(FED_RUN_ARGV + ["--engine", "sharded", "--mesh", "2",
                                                  "--out", out_path])
    else:
        res["fed_run"] = _fed_run(FED_RUN_ARGV + ["--engine", "sharded", "--mesh", "2"])
        fed = make_federation("quantity_skew", **FED_KW)
        res["seeds"] = {
            label: _outcome_bits(pt_engine.train_population(fed.dataset, seed=SEED,
                                                            device="cpu", **kw).outcomes)
            for label, kw in SEED_VARIANTS}
    res["world_mesh"] = make_sim_mesh(device="cpu").n_shards
    return res


def _rank_main(tmp, rank, world):
    """A spawned rank: join the gloo world, run ``_world_job``, write the
    result (or the traceback) under ``tmp``."""
    tmp = Path(tmp)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        res = _world_job(rank, world, str(tmp / "fed_run.json"))
        (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
        dist.barrier()   # no rank tears the world down under another's feet
        dist.destroy_process_group()
    except Exception:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


@functools.lru_cache(maxsize=None)
def _world(size):
    """Every rank's result of a spawned gloo world of ``size`` ranks, and
    rank 0's ``--out`` file (or None). A rank that hangs past the deadline
    is killed and fails the test that asked for the world."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="shard_world_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(tmp, rank, size), daemon=True)
                 for rank in range(size)]
        for p in procs:
            p.start()
        timeout = WORLD_DEADLINE.total_seconds()
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                timeout = 0.0   # one rank hung: the others are checked, not waited for
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = {r: (Path(tmp) / f"rank{r}.err").read_text() for r in range(size)
                  if (Path(tmp) / f"rank{r}.err").exists()}
        codes = [p.exitcode for p in procs]
        assert not hung and codes == [0] * size, \
            f"world of {size}: hung ranks {hung}, exit codes {codes}, errors {errors}"
        out = Path(tmp) / "fed_run.json"
        return ([pickle.loads((Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(size)],
                json.loads(out.read_text()) if out.exists() else None)


@pytest.mark.parametrize("scenario", WORLD_SCENARIOS)
def test_two_rank_world_trains_the_bucketed_population(scenario):
    ranks, _ = _world(2)
    want = _outcome_bits(_bucketed(scenario))
    for res in ranks:
        bits, spans = res["populations"][scenario]
        assert res["world_mesh"] == 2
        assert bits == want, f"rank {res['rank']}"
        assert spans["batched_rbf_gram"] > 0 and spans["sdca"] > 0   # both ranks train


def test_two_rank_world_round_is_the_bucketed_round():
    """``run_population`` sharded, and streamed with ``mesh_shards=2``
    (its ``train_selected`` rebuild too), on both ranks."""
    ranks, _ = _world(2)
    want = _report_bits(_population("int8", "fisher", "bucketed"))
    for res in ranks:
        assert res["rounds"][("sharded", None)] == want, res["rank"]
        streamed = res["rounds"][("streamed", 2)]
        assert (streamed[0], streamed[2]) == (want[0], want[2]), res["rank"]


def test_two_rank_world_fed_run_prints_once_and_equals_bucketed():
    ranks, written = _world(2)
    want, printed, _ = _fed_run(FED_RUN_ARGV)
    assert printed and want["mesh"] is None
    for res in ranks:
        report, printed, spans = res["fed_run"]
        assert (report["engine"], report["mesh"], report["mesh_requested"]) == ("sharded", 2, 2)
        assert _comparable(report) == _comparable(want), f"rank {res['rank']}"
        assert printed == (res["rank"] == 0)
        assert spans["batched_rbf_gram"] > 0 and spans["sdca"] > 0
    assert written is not None and written == json.loads(json.dumps(ranks[0]["fed_run"][0]))


def test_four_rank_world_with_mesh_2_leaves_ranks_2_and_3_idle():
    ranks, _ = _world(4)
    want, _, _ = _fed_run(FED_RUN_ARGV)
    assert [res["world_mesh"] for res in ranks] == [4] * 4
    for res in ranks:
        report, printed, spans = res["fed_run"]
        assert report["mesh"] == 2 and printed == (res["rank"] == 0)
        assert _comparable(report) == _comparable(want), f"rank {res['rank']}"
        trains = spans["batched_rbf_gram"] > 0 and spans["sdca"] > 0
        idle = spans == {"batched_rbf_gram": 0, "sdca": 0}
        assert (trains if res["rank"] < 2 else idle), (res["rank"], spans)


def test_seeds_independent_of_grouping_and_shard_count():
    """Per-device splits and models, bit for bit, whatever the group cap,
    the shard count (4, 2, 1 of a world of 4) or the streamed chunk."""
    ranks, _ = _world(4)
    fed = make_federation("quantity_skew", **FED_KW)
    want = _outcome_bits(pt_engine.train_population(fed.dataset, mode="bucketed", seed=SEED,
                                                    group_cap=256, device="cpu").outcomes)
    assert want == _outcome_bits(pt_engine.train_population(
        fed.dataset, mode="bucketed", seed=SEED, group_cap=8, device="cpu").outcomes)
    for res in ranks:
        assert set(res["seeds"]) == {label for label, _ in SEED_VARIANTS}
        for label, bits in res["seeds"].items():
            assert bits == want, (res["rank"], label)
