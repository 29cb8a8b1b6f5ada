"""The wire format (every codec) and the weight converters carry models
between the reference and the port unchanged, on the CPU."""
import numpy as np
import pytest
import torch

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

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)


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
    """Every codec and every kind is ported: the codec table and the
    report size are the reference's, and the linear and aggregator-extra
    kinds (once unported) decode in the port to the reference's values."""
    from repro.comm.wire import AggExtra
    from repro.core.averaging import LinearSVM

    assert pt_wire.REPORT_NBYTES == ref_wire.REPORT_NBYTES == 18
    assert {n: (c.codec_id, c.param) for n, c in pt_wire.CODECS.items()} == \
        {n: (c.codec_id, c.param) for n, c in ref_wire.CODECS.items()}
    w = _rng("codec").normal(size=7).astype(np.float32)
    for codec in ("fp32", "int8"):
        lin = pt_wire.decode(ref_wire.encode(LinearSVM(w=w, b=0.5), codec), device="cpu")
        want = ref_wire.decode(ref_wire.encode(LinearSVM(w=w, b=0.5), codec))
        assert (lin.w.tobytes(), lin.b) == (np.asarray(want.w).tobytes(), want.b)
        extra = pt_wire.decode(ref_wire.encode(AggExtra({"m": w[None, :]}), codec), device="cpu")
        assert extra.arrays["m"].tobytes() == ref_wire.decode(
            ref_wire.encode(AggExtra({"m": w[None, :]}), codec)).arrays["m"].tobytes()


CODECS = ["fp16", "int8", "topk", "topk:0.5"]


def _model_fields(obj):
    """Comparable fields of a decoded model of either package."""
    if hasattr(obj, "members"):
        return [_model_fields(m) for m in obj.members]
    if hasattr(obj, "q"):
        return ("q8", obj.q.tobytes(), obj.scale.tobytes(), obj.zero.tobytes(),
                obj.coef.tobytes(), obj.gamma)
    return _fields(obj)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("i", [0, 1, 4])
def test_lossy_codecs_encode_identically_and_cross_decode(codec, i):
    ref, pt = _pairs(_rng("pairs"))[i]
    blob = ref_wire.encode(ref, codec)
    assert pt_wire.encode(pt, codec) == blob
    assert pt_wire.get_codec(codec).spec == ref_wire.get_codec(codec).spec
    from_ref = pt_wire.decode(blob, device="cpu")
    from_pt = ref_wire.decode(pt_wire.encode(pt, codec))
    assert _model_fields(from_ref) == _model_fields(ref_wire.decode(blob))
    assert _model_fields(from_pt) == _model_fields(pt_wire.decode(blob, device="cpu"))


@pytest.mark.parametrize("codec", ["fp32"] + CODECS)
def test_svm_wire_nbytes_is_the_encoded_length(codec):
    rng = _rng("nbytes", len(codec))
    for n, d in ((1, 3), (23, 5), (64, 32), (230, 32)):
        sx, c, g = _arrays(rng, n=n, d=d)
        model = pt_svm.SVMModel(sx, c, g, device="cpu")
        got = pt_wire.svm_wire_nbytes(n, d, codec)
        assert got == len(pt_wire.encode(model, codec)) == ref_wire.svm_wire_nbytes(n, d, codec)


def test_quantized_svm_reencodes_bit_exactly_and_scores_like_the_reference():
    sx, c, g = _arrays(_rng("q8"), n=40, d=6)
    blob = ref_wire.encode(ref_svm.SVMModel(sx, c, g), "int8")
    pt = pt_wire.decode(blob, device="cpu")
    assert isinstance(pt, pt_wire.QuantizedSVM) and pt.q.dtype == np.int8
    assert pt_wire.encode(pt, "int8") == blob
    with pytest.raises(ValueError, match="re-encode only as int8"):
        pt_wire.encode(pt, "fp32")
    ref = ref_wire.decode(blob)
    q = _rng("q8-queries").normal(size=(50, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q, chunk=16), ref.predict(q), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(pt.dequantize().support_x, ref.dequantize().support_x)


def test_quantize_columns_is_the_references():
    x = _rng("qcols").normal(size=(37, 9)).astype(np.float32)
    x[:, 3] = 2.5   # a constant column: scale falls back to 1
    for got, want in zip(pt_wire._quantize_columns(x), ref_wire._quantize_columns(x)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


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


def _ref_quantized_members(rng, k=4, d=6):
    members = []
    for t in range(k):
        x = rng.normal(size=(30 + 11 * t, d)).astype(np.float32)
        y = np.where(x[:, t] > 0, 1.0, -1.0).astype(np.float32)
        members.append(ref_wire.decode(ref_wire.encode(ref_svm.train_svm(x, y), "int8")))
    return members


def test_quantized_svm_carried_across_scores_the_same():
    ref = _ref_quantized_members(_rng("convert-q8svm"), k=1)[0]
    pt = convert.quantized_svm_from_arrays(ref.q, ref.scale, ref.zero, ref.coef, ref.gamma,
                                           device="cpu")
    assert pt_wire.encode(pt, "int8") == ref_wire.encode(ref, "int8")
    q = _rng("convert-q8svm-queries").normal(size=(60, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q), ref.predict(q), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="disagree"):
        convert.quantized_svm_from_arrays(ref.q, ref.scale[:2], ref.zero, ref.coef, 0.1,
                                          device="cpu")


def test_quantized_stacked_ensemble_carried_across_scores_the_same():
    ref = ref_wire.QuantizedStackedEnsemble.from_members(
        _ref_quantized_members(_rng("convert-q8stacked")))
    pt = convert.quantized_stacked_from_arrays(ref.q, ref.scale, ref.zero, ref.coef,
                                               ref.gammas, device="cpu")
    assert (pt.k, pt.n_max, pt.d) == (ref.k, ref.n_max, ref.d)
    assert pt.q.dtype == convert.torch.int8
    assert set(dict(pt.named_buffers())) == {"q", "scale", "zero", "coef", "gammas"}
    q = _rng("convert-q8stacked-queries").normal(size=(100, 6)).astype(np.float32)
    np.testing.assert_allclose(pt.predict(q, chunk=32), ref.predict(q, chunk=32),
                               atol=1e-4, rtol=0)
    # the port's own packing of the same members agrees
    members = [pt_wire.decode(ref_wire.encode(m, "int8"), device="cpu")
               for m in _ref_quantized_members(_rng("convert-q8stacked"))]
    ens = pt_ens.Ensemble(members)
    np.testing.assert_allclose(ens.predict(q), ref.predict(q), atol=1e-4, rtol=0)
    assert isinstance(ens._qstacked, pt_wire.QuantizedStackedEnsemble)
    with pytest.raises(ValueError, match="disagree"):
        convert.quantized_stacked_from_arrays(ref.q, ref.scale, ref.zero, ref.coef[:, :3],
                                              ref.gammas, device="cpu")
