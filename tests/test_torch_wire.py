"""The fp32 wire format and the weight converters carry models between
the reference and the port unchanged, on the CPU."""
import numpy as np
import pytest

from repro.comm import wire as ref_wire
from repro.core import ensemble as ref_ens
from repro.core import selection as ref_sel
from repro.core import svm as ref_svm
from repro.utils.seeds import derive_stream_seed
from repro_torch import convert
from repro_torch.comm import wire as pt_wire
from repro_torch.core import ensemble as pt_ens
from repro_torch.core import selection as pt_sel
from repro_torch.core import svm as pt_svm


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(13, purpose, index))


def _arrays(rng, n=23, d=5):
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=n) / n).astype(np.float32), float(rng.uniform(0.05, 0.5)))


def _pairs(rng):
    """The same payloads as reference and port objects."""
    sx, c, g = _arrays(rng)
    sx2, c2, g2 = _arrays(rng, n=9)
    return [
        (ref_svm.SVMModel(sx, c, g), pt_svm.SVMModel(sx, c, g, device="cpu")),
        (ref_svm.ConstantModel(0.25), pt_svm.ConstantModel(0.25)),
        (ref_sel.DeviceReport(17, 123, 0.8125, True), pt_sel.DeviceReport(17, 123, 0.8125, True)),
        (ref_sel.DeviceReport(3, 4, 0.5, False), pt_sel.DeviceReport(3, 4, 0.5, False)),
        (ref_ens.Ensemble([ref_svm.SVMModel(sx, c, g), ref_svm.SVMModel(sx2, c2, g2)]),
         pt_ens.Ensemble([pt_svm.SVMModel(sx, c, g, device="cpu"),
                          pt_svm.SVMModel(sx2, c2, g2, device="cpu")])),
    ]


def _fields(obj):
    if hasattr(obj, "members"):
        return [_fields(m) for m in obj.members]
    if hasattr(obj, "support_x"):
        return (obj.support_x.tobytes(), obj.coef.tobytes(), obj.gamma)
    if hasattr(obj, "value"):
        return obj.value
    return (obj.device_id, obj.n_train, obj.val_auc, obj.eligible)


@pytest.mark.parametrize("i", range(5))
def test_identical_models_encode_to_identical_bytes(i):
    ref, pt = _pairs(_rng("pairs"))[i]
    assert pt_wire.encode(pt) == ref_wire.encode(ref, "fp32")
    assert pt_wire.encoded_nbytes(pt) == len(ref_wire.encode(ref))


@pytest.mark.parametrize("i", range(5))
def test_blobs_cross_decode_both_ways(i):
    ref, pt = _pairs(_rng("pairs"))[i]
    from_ref = pt_wire.decode(ref_wire.encode(ref), device="cpu")
    from_pt = ref_wire.decode(pt_wire.encode(pt))
    assert _fields(from_ref) == _fields(ref)
    assert _fields(from_pt) == _fields(pt)


def test_report_size_and_unported_codecs():
    assert pt_wire.REPORT_NBYTES == ref_wire.REPORT_NBYTES == 18
    sx, c, g = _arrays(_rng("codec"))
    blob = ref_wire.encode(ref_svm.SVMModel(sx, c, g), "int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_wire.decode(blob, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_wire.encode(pt_svm.ConstantModel(1.0), "fp16")


def test_svm_trained_by_jax_scores_the_same_in_the_port():
    rng = _rng("convert-svm")
    x = rng.normal(size=(90, 6)).astype(np.float32)
    y = np.where(x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    ref = ref_svm.train_svm(x, y)
    pt = convert.svm_from_arrays(ref.support_x, ref.coef, ref.gamma, device="cpu")
    q = rng.normal(size=(70, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q), ref.predict(q), atol=1e-4, rtol=0)


def test_stacked_ensemble_carried_across_scores_the_same():
    rng = _rng("convert-stacked")
    members = []
    for t in range(4):
        x = rng.normal(size=(40 + 9 * t, 6)).astype(np.float32)
        y = np.where(x[:, t] > 0, 1.0, -1.0).astype(np.float32)
        members.append(ref_svm.train_svm(x, y))
    ref = ref_ens.StackedEnsemble.from_members(members)
    pt = convert.stacked_from_arrays(np.asarray(ref.sup), np.asarray(ref.coef),
                                     np.asarray(ref.gammas), device="cpu")
    assert (pt.k, pt.n_max, pt.d) == (ref.k, ref.n_max, ref.d)
    assert set(dict(pt.named_buffers())) == {"sup", "coef", "gammas"}
    q = rng.normal(size=(100, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q, chunk=32), ref.predict(q, chunk=32),
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="disagree"):
        convert.stacked_from_arrays(np.zeros((2, 3, 4)), np.zeros((2, 4)), np.zeros(2),
                                    device="cpu")
