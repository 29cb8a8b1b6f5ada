"""The SVM path at feature dims past the CUDA kernels' staged limits, on the CPU.

The reference's Pallas kernels block over the full feature dim and its
SDCA takes any bucket; the port's kernels switch to chunked (and, for
SDCA, global-memory) instantiations past d 64 (``gram_matvec``), d 128
(``rbf_gram_q8``), d 220 (the scorers) and bucket 12,384 (``sdca``). The
kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here each plain version is held to the reference's dispatcher at d 129,
221 and 784 (gamma 1/d, the registry's tolerances), and the round on
the emnist federation at d 784 (fp32) and d 256 (int8 with CG
distillation), the port's on the CPU against the reference's: equal
ledgers and picked ids, AUCs within 1e-4, the same best k.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core.protocol import run_protocol as ref_run
from repro.data.federated import make_emnist_like as ref_emnist
from repro.distill import DistillConfig as RefDistill
from repro.kernels import ops as ref_ops
from repro.utils.seeds import derive_stream_seed
from repro_torch.comm.wire import _quantize_columns
from repro_torch.core.protocol import run_protocol as pt_run
from repro_torch.data.federated import make_emnist_like as pt_emnist
from repro_torch.distill import DistillConfig as PtDistill
from repro_torch.kernels import ops

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

WIDE_DS = [129, 221, 784]   # past gram_matvec's 64 and q8's 128, past the scorers' 220, emnist's pixels


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(13, purpose, index))


def _wide_args(name, d):
    """Seeded numpy inputs at feature dim d, gamma 1/d: small counts,
    ragged against every tile (37 queries, 77 supports)."""
    rng = _rng(name, d)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    gam = np.float32(1.0 / d)
    if name == "batched_rbf_gram":
        return normal(3, 37, d), normal(3, 77, d), np.full(3, gam, np.float32)
    if name == "gram_matvec":
        return normal(37, d), normal(77, d), normal(77), float(gam)
    if name == "rbf_gram_q8":
        return (normal(37, d), *_quantize_columns(normal(77, d)), float(gam))
    coef = (normal(3, 77) / 77).astype(np.float32)
    gammas = np.full(3, gam, np.float32)
    sup = normal(3, 77, d)
    if name == "ensemble_score":
        return normal(37, d), sup, coef, gammas
    packed = [_quantize_columns(s) for s in sup]
    q, scale, zero = (np.stack([p[i] for p in packed]) for i in range(3))
    return normal(37, d), q, scale, zero, coef, gammas


PLAIN = {
    "batched_rbf_gram": ref_ops.batched_rbf_gram,
    "ensemble_score": ref_ops.ensemble_score,
    "ensemble_score_q8": ref_ops.ensemble_score_q8,
    "gram_matvec": ref_ops.gram_matvec,
    "rbf_gram_q8": ref_ops.rbf_gram_q8,
}


@pytest.mark.parametrize("d", WIDE_DS)
@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_versions_match_the_reference_past_the_staged_dims(name, d):
    spec = ops.KERNEL_REGISTRY[name]
    args = _wide_args(name, d)
    want = np.asarray(PLAIN[name](*args))
    got = spec.plain(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                       for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=spec.tol, rtol=0)


ROUNDS = {
    # the d 784 round: the fp32 path's scorers past d 220
    "emnist-d784": dict(dim=784, ks=(1, 10, 50), random_trials=2),
    # the d 256 int8 round with CG distillation: gram_matvec past d 64, the
    # int8 scorer and the student's rbf_gram_q8 past d 128
    "emnist-d256-int8-cg": dict(dim=256, ks=(1, 10, 50), random_trials=2, codec="int8",
                                distill=dict(proxy_size=1024, solver="cg")),
}


@functools.lru_cache(maxsize=None)
def _rounds(name):
    c = dict(ROUNDS[name])
    dim, distill = c.pop("dim"), c.pop("distill", None)
    ref = ref_run(ref_emnist(seed=0, scale=0.02, dim=dim),
                  distill=RefDistill(**distill) if distill else None, **c)
    pt = pt_run(pt_emnist(seed=0, scale=0.02, dim=dim),
                distill=PtDistill(**distill) if distill else None, device="cpu", **c)
    return ref, pt


def _ids(res):
    return [(e.tag, e.device_id, e.nbytes)  # repro: allow[wire-cost-honesty] reason=asserts on recorded ledger fields, as tests/test_comm.py does
            for e in res.ledger.events]


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_wide_round_ledgers_and_picked_ids_are_equal(name):
    ref, pt = _rounds(name)
    assert pt.ledger.as_dict() == ref.ledger.as_dict()
    assert _ids(pt) == _ids(ref)


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_wide_round_aucs_agree_and_best_k_is_the_same(name):
    ref, pt = _rounds(name)
    for attr in ("local_mean_auc", "ideal_mean_auc", "full_ensemble_auc"):
        assert abs(getattr(pt, attr) - getattr(ref, attr)) <= 1e-4, attr
    assert pt.ensemble_auc.keys() == ref.ensemble_auc.keys()
    for s in ref.ensemble_auc:
        assert pt.ensemble_auc[s].keys() == ref.ensemble_auc[s].keys()
        for k in ref.ensemble_auc[s]:
            assert abs(pt.ensemble_auc[s][k] - ref.ensemble_auc[s][k]) <= 1e-4, (s, k)
        assert (max(pt.ensemble_auc[s], key=pt.ensemble_auc[s].get)
                == max(ref.ensemble_auc[s], key=ref.ensemble_auc[s].get))
    for key in ref.per_device:
        np.testing.assert_allclose(pt.per_device[key], ref.per_device[key], atol=1e-4)
    if ROUNDS[name].get("distill"):
        assert type(pt.student).__name__ == type(ref.student).__name__ == "QuantizedSVM"
        assert pt.student.q.tobytes() == np.asarray(ref.student.q).tobytes()


def test_chip_smoke_draws_the_ideal_rows_as_ops_does():
    """``chip_smoke.py``'s wide phase draws the pooled ideal's rows from one
    pooled federation shared by its checks: the rows ``ops.ideal_rows``
    draws, bit for bit."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for cap in (300, 10**6):
        x, y, xt, yt = smoke.wide_ideal_rows(0.02, cap)
        want_x, want_y = ops.ideal_rows(seed=0, scale=0.02, cap=cap)
        assert x.dtype == want_x.dtype and np.array_equal(x, want_x) and np.array_equal(y, want_y)
        assert len(xt) == len(yt) > 0 and xt.shape[1] == x.shape[1]
