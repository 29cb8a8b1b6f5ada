"""The port's ``launch/fed_run.py`` against the reference's CLI, on the CPU.

Twins of the reference's CLI tests (``tests/test_sim.py``,
``test_comm.py``, ``test_distill.py``, ``test_fleet.py``, ``test_obs.py``):
each argv goes through ``repro.launch.fed_run.main`` and
``repro_torch.launch.fed_run.main(argv, device="cpu")``, and the two JSON
reports are held to each other: the same keys, the ``comm`` block and the
ledger's envelope section exactly equal, headcounts equal, every AUC
within the reference's engine-tier 1e-4, the fleet summary byte for byte.
``--mode lm`` runs at a reduced size with the reference's inits injected
into ``repro_torch.core.deepfed`` (``test_torch_deepfed.py``): the
members' NLLs within 1e-4, byte counts equal, and the student's NLL within
1e-3. The student's first AdamW step is ``lr * sign(g)`` wherever |g| is
well above eps, so a gradient element smaller than the rounding the
members carry in from local training flips sign (32 of 426,624 elements
after one distill step here, each moved by ~2 lr): from the same members
the student's 2 steps stay within 1e-4 of the reference's elementwise,
from members trained apart its NLL moves by up to 2.5e-4.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.core import deepfed as ref_deepfed
from repro.launch import fed_run as ref_fed_run
from repro_torch.comm.wire import REPORT_NBYTES
from repro_torch.convert import lm_params_from_arrays, lm_stacked_from_arrays
from repro_torch.core import deepfed
from repro_torch.launch import fed_run
from repro_torch.obs.trace import SCHEMA

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

AUC_TOL = 1e-4   # docs/ARCHITECTURE.md:375
NLL_TOL = 1e-4
STUDENT_NLL_TOL = 1e-3
EQUAL_KEYS = ("mode", "scenario", "engine", "mesh", "mesh_requested", "devices", "available",
              "eligible", "codec", "budget_bytes", "aggregator", "comm", "student_codec",
              "distill_solver", "proxy_source")


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    else:
        assert abs(got - want) <= AUC_TOL, (path, got, want)


def _both(argv, tmp_path=None):
    """(reference report, port report) for ``argv``; with ``tmp_path``
    each also writes ``--out``, read back and checked against its return."""
    reports = []
    for name, main in (("ref", ref_fed_run.main),
                       ("pt", lambda a: fed_run.main(a, device="cpu"))):
        args = list(argv)
        if tmp_path is not None:
            args += ["--out", str(tmp_path / f"{name}.json")]
        out = main(args)
        if tmp_path is not None:
            assert json.loads((tmp_path / f"{name}.json").read_text()) == \
                json.loads(json.dumps(out))
        reports.append(out)
    want, got = reports
    assert set(got) == set(want)
    for key in EQUAL_KEYS:
        if key in want:
            assert got[key] == want[key], key
    for key in ("mean_local_auc", "mean_val_auc", "best", "ensemble_auc"):
        _close(got[key], want[key], key)
    assert got["obs"]["schema"] == want["obs"]["schema"] == SCHEMA
    assert set(got["obs"]["sections"]) == set(want["obs"]["sections"])
    assert got["obs"]["sections"]["comm"] == want["obs"]["sections"]["comm"]
    if "fleet" in want:
        assert _dumps(got["fleet"]) == _dumps(want["fleet"])
        assert got["obs"]["sections"]["fleet"] == want["obs"]["sections"]["fleet"]
    return want, got


def test_sim_mode(tmp_path):
    """Twin of ``tests/test_sim.py::test_fed_run_sim_mode``."""
    _, got = _both(["--mode", "sim", "--scenario", "iid", "--devices", "16",
                    "--mean-samples", "60", "--k", "3"], tmp_path)
    assert got["scenario"] == "iid" and got["devices"] == 16 and got["mesh"] is None
    assert 0.0 <= got["mean_local_auc"] <= 1.0


def test_scenario_list(capsys):
    """Twin of ``tests/test_sim.py::test_fed_run_sim_scenario_list``."""
    assert ref_fed_run.main(["--mode", "sim", "--scenario", "list"]) == {}
    want = capsys.readouterr().out
    assert fed_run.main(["--mode", "sim", "--scenario", "list"], device="cpu") == {}
    got = capsys.readouterr().out
    assert got == want and "dirichlet" in got


def test_codec_budget_ledger_exact():
    """Twin of ``tests/test_comm.py::test_fed_run_cli_codec_budget_ledger_exact``:
    the budgeted int8 round's totals are the reference's, byte for byte."""
    budget = 16_384
    _, got = _both(["--mode", "sim", "--scenario", "iid", "--devices", "16",
                    "--mean-samples", "60", "--k", "4", "--seed", "0", "--codec", "int8",
                    "--budget-bytes", str(budget)])
    assert got["codec"] == "int8" and got["budget_bytes"] == budget
    comm = got["comm"]
    assert 0 < comm["upload_cv_k4"] <= budget
    assert comm["metadata_upload"] == REPORT_NBYTES * 16
    uploads = sum(v for k, v in comm.items() if k.startswith("upload_"))
    assert comm["total_up"] == uploads + REPORT_NBYTES * 16


def test_distill():
    """Twin of ``tests/test_distill.py::test_fed_run_cli_distill``."""
    _, got = _both(["--mode", "sim", "--scenario", "iid", "--devices", "12", "--k", "4",
                    "--distill-proxy", "30", "--distill-solver", "auto",
                    "--proxy-source", "validation"])
    assert "distilled" in got["ensemble_auc"]
    assert got["comm"]["download_distilled"] > 0


def test_serve_fleet(tmp_path):
    """Twin of ``tests/test_fleet.py::test_fed_run_cli_serve_fleet``."""
    _, got = _both(["--mode", "sim", "--scenario", "iid", "--devices", "12", "--k", "4",
                    "--distill-proxy", "30", "--serve-fleet", "--fleet-horizon-ms", "40",
                    "--fleet-load", "1.5"], tmp_path)
    fleet = got["fleet"]
    assert fleet["global"]["conserved"]
    assert fleet["handoff"]["load_x_capacity"] == 1.5
    assert fleet["handoff"]["artifact"] == "student"
    assert set(fleet["tenants"]) == {"premium", "batch"}


def test_serve_fleet_deploys_server_scorer_without_distill():
    """Twin of ``tests/test_fleet.py::
    test_fed_run_serve_fleet_deploys_server_scorer_without_distill``."""
    _, got = _both(["--mode", "sim", "--scenario", "iid", "--devices", "12", "--k", "4",
                    "--serve-fleet", "--fleet-horizon-ms", "30", "--aggregator", "fisher"])
    assert got["aggregator"] == "fisher"
    assert got["fleet"]["handoff"]["artifact"] == "server_scorer"
    assert got["fleet"]["global"]["conserved"] and got["fleet"]["global"]["completed"] > 0


def test_trace_covers_subsystems(tmp_path, capsys):
    """Twin of ``tests/test_obs.py::test_fed_run_trace_covers_subsystems``:
    the port's trace has the reference's categories and every span name of
    the reference's (the port's own spans beside them: ``round.score``,
    ``round.auc``, ``kernel.sdca``), the fleet's events on pid 2."""
    argv = ["--mode", "sim", "--scenario", "iid", "--devices", "24", "--mean-samples", "80",
            "--k", "2", "--engine", "streamed", "--chunk-devices", "8", "--distill-proxy", "32",
            "--serve-fleet", "--fleet-horizon-ms", "30"]
    ref_fed_run.main(argv + ["--trace", str(tmp_path / "ref.json")])
    out = fed_run.main(argv + ["--trace", str(tmp_path / "pt.json")], device="cpu")
    capsys.readouterr()
    docs = {name: json.loads((tmp_path / f"{name}.json").read_text()) for name in ("ref", "pt")}
    cats = {name: {e.get("cat") for e in d["traceEvents"] if "cat" in e}
            for name, d in docs.items()}
    names = {name: {e["name"] for e in d["traceEvents"]} for name, d in docs.items()}
    assert {"engine", "comm", "distill", "fleet"} <= cats["pt"] == cats["ref"]
    assert names["ref"] <= names["pt"]
    assert all(e["pid"] == 2 for e in docs["pt"]["traceEvents"] if e.get("cat") == "fleet")
    assert out["obs"]["schema"] == SCHEMA
    assert {"comm", "fleet"} <= set(out["obs"]["sections"])


LM_ARGV = ["--clients", "2", "--local-steps", "3", "--distill-steps", "2", "--batch", "2",
           "--seq", "16", "--tokens-per-client", "1000"]


@pytest.mark.parametrize("loss", ["kl", "l2"])
def test_lm_mode_matches_reference(loss, monkeypatch, tmp_path):
    """``--mode lm`` on the reduced llama3.2-1b, the port started from
    the reference's draws."""
    _check_lm_mode("llama3.2-1b", loss, monkeypatch, tmp_path)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mamba2-2.7b"])
def test_lm_mode_runs_the_moe_and_ssm_families(arch, monkeypatch, tmp_path):
    """``--mode lm --arch`` of the MoE and SSM families, as llama's."""
    _check_lm_mode(arch, "kl", monkeypatch, tmp_path)


def test_lm_mode_runs_the_vlm_family(monkeypatch, tmp_path):
    """``--mode lm --arch llava-next-mistral-7b``: tokens alone, no patch
    prefix, in both packages."""
    _check_lm_mode("llava-next-mistral-7b", "kl", monkeypatch, tmp_path)


def _check_lm_mode(arch, loss, monkeypatch, tmp_path):
    ref_cfg = ref_configs.get_config(arch).reduced()
    tree = lambda t: jax.tree.map(np.asarray, t)
    monkeypatch.setattr(deepfed, "stacked_init", lambda cfg, n, seed=0, device="cuda":
                        lm_stacked_from_arrays(tree(ref_deepfed.stacked_init(
                            ref_cfg, n, jax.random.PRNGKey(seed))), cfg, device, trainable=True))
    monkeypatch.setattr(deepfed, "init_params", lambda cfg, seed=0, device="cuda",
                        trainable=False: lm_params_from_arrays(tree(ref_models.init_params(
                            ref_cfg, jax.random.PRNGKey(seed))), cfg, device, trainable))
    argv = LM_ARGV + ["--arch", arch, "--distill-loss", loss]
    want = ref_fed_run.main(argv)
    got = fed_run.main(argv + ["--trace", str(tmp_path / "lm.json")], device="cpu")
    assert set(got) == set(want)
    for key, tol in (("single_member_nll", NLL_TOL), ("ensemble_nll", NLL_TOL),
                     ("student_nll", STUDENT_NLL_TOL)):
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) <= tol, key
    for key in ("arch", "clients", "one_shot_comm_bytes", "fedavg10_comm_bytes",
                "comm_reduction_vs_fedavg10"):
        assert got[key] == want[key], key
    spans = {e["name"] for e in json.loads((tmp_path / "lm.json").read_text())["traceEvents"]}
    assert {"lm.local_train", "lm.distill"} <= spans


@pytest.mark.parametrize("argv,mesh", [(["--engine", "sharded"], 1), (["--mesh", "4"], None)],
                         ids=["engine_sharded", "mesh"])
def test_sharded_tier_is_not_ported(argv, mesh):
    """Once raises, now the sharded tier (a one-rank gloo world in this
    process): ``--engine sharded`` builds a mesh of 1 shard and ``--mesh 4``
    alone caps nothing on the bucketed engine, and the JSON equals the
    bucketed run's but for the mesh keys, the engine and the timings."""
    base = ["--mode", "sim", "--scenario", "iid", "--devices", "16", "--k", "3"]
    want = fed_run.main(base, device="cpu")
    got = fed_run.main(base + argv, device="cpu")
    assert (got["mesh"], got["mesh_requested"]) == (mesh, 4 if mesh is None else None)
    skip = ("engine", "mesh", "mesh_requested", "train_seconds", "devices_per_second", "obs")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert got["obs"]["sections"]["comm"] == want["obs"]["sections"]["comm"]
    assert got["engine"] == ("sharded" if mesh else "bucketed")


def test_lm_mode_refuses_audio_without_frames():
    """``--mode lm`` feeds tokens alone; whisper's encoder needs frames, and
    both packages raise ``KeyError`` naming them."""
    with pytest.raises(KeyError, match="frames"):
        ref_fed_run.main(["--mode", "lm", "--arch", "whisper-base"] + LM_ARGV)
    with pytest.raises(KeyError, match="frames"):
        fed_run.main(["--mode", "lm", "--arch", "whisper-base"] + LM_ARGV, device="cpu")
