"""The port's distillation against the reference's, on the CPU: each
solver's student (same support rows, scores within 1e-4 on held-out
rows), the proxy sources (bit-identical draws), the batched sweep and
``distill_svm``, all from one teacher carried across by ``convert.py``."""
import functools

import numpy as np
import pytest
import torch

from repro.core import distill as ref_core_distill
from repro.core import ensemble as ref_ens
from repro.core import svm as ref_svm
from repro.data import make_dataset as ref_make
from repro.distill import proxy as ref_proxy
from repro.distill import solvers as ref_solvers
from repro.distill import sweep as ref_sweep
from repro.distill.config import DistillConfig as RefConfig
from repro.sim.engine import train_population as ref_train
from repro.utils.seeds import derive_stream_seed
from repro_torch import convert
from repro_torch.core import distill as pt_core_distill
from repro_torch.data import make_dataset as pt_make
from repro_torch.distill import proxy as pt_proxy
from repro_torch.distill import solvers as pt_solvers
from repro_torch.distill import sweep as pt_sweep
from repro_torch.distill.config import DistillConfig as PtConfig
from repro_torch.sim.engine import train_population as pt_train

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

D = 16
TOL = 1e-4


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(11, purpose, index))


@functools.lru_cache(maxsize=None)
def _teachers():
    """One trained reference ensemble, and the port's copy of it."""
    rng = _rng("teacher")
    members = []
    for t in range(3):
        x = rng.normal(size=(50 + 7 * t, D)).astype(np.float32)
        y = np.where(x[:, t] + 0.3 * x[:, t + 1] > 0, 1.0, -1.0).astype(np.float32)
        members.append(ref_svm.train_svm(x, y))
    ref = ref_ens.StackedEnsemble.from_members(members)
    pt = convert.stacked_from_arrays(np.asarray(ref.sup), np.asarray(ref.coef),
                                     np.asarray(ref.gammas), device="cpu")
    return ref, pt


def _proxy(l: int, index: int = 0) -> np.ndarray:
    return _rng("proxy", index).normal(size=(l, D)).astype(np.float32)


def _held_out() -> np.ndarray:
    return _rng("held-out").normal(size=(200, D)).astype(np.float32)


@pytest.mark.parametrize("solver,l,extra", [
    ("dense", 300, {}),
    ("cg", 300, {}),
    ("nystrom", 300, {"landmarks": 64}),
    ("auto", 300, {"dense_max": 100, "nystrom_min": 1000}),   # routes to cg
])
def test_solver_student_matches_reference(solver, l, extra):
    ref_t, pt_t = _teachers()
    xp = _proxy(l)
    ref = ref_solvers.distill_teacher(ref_t.predict, xp, cfg=RefConfig(solver=solver, **extra),
                                      seed=3)
    pt = pt_solvers.distill_teacher(pt_t.predict, xp, cfg=PtConfig(solver=solver, **extra),
                                    seed=3, device="cpu")
    assert pt.support_x.tobytes() == np.asarray(ref.support_x, np.float32).tobytes()
    assert pt.gamma == ref.gamma
    q = _held_out()
    np.testing.assert_allclose(pt.predict(q), ref.predict(q), atol=TOL, rtol=0)


def test_dedupe_and_gamma_are_the_references():
    xp = np.concatenate([_proxy(40), _proxy(40)[:7]])
    got = pt_solvers.dedupe_proxy(xp)
    assert got.tobytes() == ref_solvers.dedupe_proxy(xp).tobytes() and len(got) == 40


def test_distill_streams_are_the_references():
    for seed in (0, 7):
        assert (pt_solvers.distill_rng(seed).random(6).tobytes()
                == ref_solvers.distill_rng(seed).random(6).tobytes())
        assert (pt_solvers._landmark_rng(seed).random(6).tobytes()
                == ref_solvers._landmark_rng(seed).random(6).tobytes())


@functools.lru_cache(maxsize=None)
def _outcomes():
    ref = ref_train(ref_make("gleam", seed=0, scale=0.3)).outcomes
    pt = pt_train(pt_make("gleam", seed=0, scale=0.3), device="cpu").outcomes
    return ref, pt


@pytest.mark.parametrize("name,n", [("validation", 60), ("validation", 10**6),
                                    ("public", 80), ("gaussian", 50)])
def test_proxy_draws_are_bit_identical(name, n):
    ref_dev, pt_dev = _outcomes()
    ref = ref_proxy.make_proxy(name, n=n, rng=ref_solvers.distill_rng(4), devices=ref_dev)
    pt = pt_proxy.make_proxy(name, n=n, rng=pt_solvers.distill_rng(4), devices=pt_dev)
    assert pt.dtype == np.float32 and pt.shape == ref.shape
    assert pt.tobytes() == ref.tobytes()


@pytest.mark.parametrize("scenario,params", [
    ("dirichlet", {}), ("quantity_skew", {"sigma": 1.2}),
    ("availability", {"base": "feature_shift"}), ("temporal_drift", {"n_devices": 5}),
])
def test_scenario_proxy_draws_are_bit_identical(scenario, params):
    """The ``scenario`` source redraws a federation from the scenario
    registry under a seed from the distillation stream: all numpy, so the
    port's rows are the reference's bits."""
    assert set(pt_proxy.PROXIES) == set(ref_proxy.PROXIES)
    assert pt_proxy.list_proxies() == ref_proxy.list_proxies()
    kw = dict(n=150, dim=6, scenario=scenario, mean_samples=30, **params)
    ref = ref_proxy.make_proxy("scenario", rng=ref_solvers.distill_rng(2), **kw)
    pt = pt_proxy.make_proxy("scenario", rng=pt_solvers.distill_rng(2), **kw)
    assert pt.dtype == np.float32 and pt.shape == ref.shape
    assert pt.tobytes() == ref.tobytes()
    with pytest.raises(ValueError, match="params\\['scenario'\\]"):
        pt_proxy.make_proxy("scenario", n=10, rng=pt_solvers.distill_rng(0), dim=4)


def test_sweep_matches_reference():
    ref_t, pt_t = _teachers()
    proxies = np.stack([_proxy(48, t) for t in range(2)])
    ls = (12, 30, 48)
    ref = ref_sweep.distill_sweep(ref_t.predict, proxies, ls)
    pt = pt_sweep.distill_sweep(pt_t.predict, proxies, ls, device="cpu")
    q = _held_out()
    for t in range(2):
        for i, l in enumerate(ls):
            assert pt[t][i].support_x.tobytes() == np.asarray(ref[t][i].support_x).tobytes()
            assert pt[t][i].gamma == ref[t][i].gamma
            np.testing.assert_allclose(pt[t][i].predict(q), ref[t][i].predict(q),
                                       atol=TOL, rtol=0)


def test_distill_svm_matches_reference():
    ref_t, pt_t = _teachers()
    xp = _proxy(120, 5)
    ref = ref_core_distill.distill_svm(ref_t.predict, xp, gamma=0.2)
    pt = pt_core_distill.distill_svm(pt_t.predict, xp, gamma=0.2, device="cpu")
    q = _held_out()
    np.testing.assert_allclose(pt.predict(q), ref.predict(q), atol=TOL, rtol=0)


def test_round_records_the_distill_span():
    from repro_torch.core.protocol import run_protocol
    from repro_torch.obs.trace import Tracer, use_tracer

    tracer = Tracer()
    with use_tracer(tracer):
        res = run_protocol(pt_make("gleam", seed=0, scale=0.3), ks=(1, 3), random_trials=1,
                           distill=PtConfig(proxy_size=64, solver="cg"), device="cpu")
    assert "distill.round" in tracer.span_seconds()
    assert any(ev["name"] == "comm.student_download" for ev in tracer.events)
    assert res.student_codec == "fp32" and "distilled" in res.per_device
