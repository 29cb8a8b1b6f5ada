"""The port's local model and engine against the reference, on the CPU.

``train_svm`` coefficients agree within 1e-5; the port's bucketed and
loop tiers give the reference bucketed tier's reports (val AUC included)
and eligibility exactly, with val/test scores and test AUCs within 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import svm as ref_svm
from repro.data import make_dataset as ref_make
from repro.sim import engine as ref_engine
from repro.utils.seeds import derive_stream_seed
from repro_torch.core import svm as pt_svm
from repro_torch.data import make_dataset as pt_make
from repro_torch.sim import engine as pt_engine


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(9, purpose, index))


@pytest.mark.parametrize("n", [7, 64, 65, 150])
def test_train_svm_matches_reference(n):
    rng = _rng("svm", n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.where(x[:, 0] + 0.3 * rng.normal(size=n) > 0, 1.0, -1.0).astype(np.float32)
    ref = ref_svm.train_svm(x, y, lam=0.01)
    pt = pt_svm.train_svm(x, y, lam=0.01, device="cpu")
    assert pt.gamma == ref.gamma and isinstance(pt.gamma, float)
    assert pt.support_x.tobytes() == ref.support_x.tobytes()
    assert pt.coef.dtype == np.float32
    np.testing.assert_allclose(pt.coef, ref.coef, atol=1e-5, rtol=0)
    q = rng.normal(size=(33, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q), ref.predict(q), atol=1e-4, rtol=0)


def test_default_gamma_runs_in_float64_on_the_host():
    x = _rng("gamma").normal(size=(40, 5)).astype(np.float32)
    assert pt_svm.default_gamma(x) == ref_svm.default_gamma(x)
    assert pt_svm.default_gamma(np.zeros((3, 4), np.float32)) == 1.0 / (4 * 1e-8)


@functools.lru_cache(maxsize=None)
def _reference_population(name: str, scale: float):
    return ref_engine.train_population(ref_make(name, seed=2, scale=scale),
                                       mode="bucketed").outcomes


@pytest.mark.parametrize("mode", ["bucketed", "loop"])
@pytest.mark.parametrize("name,scale", [("gleam", 0.6), ("emnist", 0.01)])
def test_train_population_matches_reference(name, scale, mode):
    ref = _reference_population(name, scale)
    pt = pt_engine.train_population(pt_make(name, seed=2, scale=scale), mode=mode,
                                    device="cpu").outcomes
    assert [o.device_id for o in pt] == [o.device_id for o in ref]
    assert sum(o.report.eligible for o in pt) >= 1
    for a, b in zip(pt, ref):
        assert dataclasses.astuple(a.report) == dataclasses.astuple(b.report)
        assert abs(a.local_test_auc - b.local_test_auc) <= 1e-4
        np.testing.assert_allclose(a.val_scores, b.val_scores, atol=1e-4, rtol=0)
        np.testing.assert_allclose(a.local_test_scores, b.local_test_scores,
                                   atol=1e-4, rtol=0)
        assert type(a.model).__name__ == type(b.model).__name__
        if a.report.eligible:
            np.testing.assert_allclose(a.model.coef, b.model.coef, atol=1e-5, rtol=0)
            assert a.model.gamma == b.model.gamma


def test_bucketed_groups_follow_the_reference_caps():
    for bucket in (64, 128, 192, 256, 2048, 8192):
        assert (pt_engine._bucket_group_caps(bucket, 256)
                == ref_engine._bucket_group_caps(bucket, 256, None))
    assert pt_engine.QUERY_PAD == ref_engine.QUERY_PAD
    assert pt_engine.GRAM_ELEM_BUDGET == ref_engine.GRAM_ELEM_BUDGET


@pytest.mark.parametrize("mode", ["sharded", "streamed"])
def test_unported_engine_tiers_raise(mode):
    ds = pt_make("gleam", seed=0, scale=0.2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_engine.train_population(ds, mode=mode, device="cpu")
