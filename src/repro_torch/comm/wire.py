"""Versioned wire format for the one-shot upload (and download) path.

Port of ``repro.comm.wire``, byte for byte: the same header, structs and
body layouts, so a blob from either package decodes in the other and
identical models encode to identical bytes.

    +-------+---------+------+----------+------------------------+
    | magic | version | kind | codec id | kind-specific body     |
    | "OS"  |  u8     | u8   | u8       | ...                    |
    +-------+---------+------+----------+------------------------+

``len(encode(obj, codec))`` IS the communication cost. Payload kinds:
``SVMModel``, ``LinearSVM`` (the averaging / FedAvg baseline model),
``ConstantModel``, ``Ensemble`` (length-prefixed member messages),
``DeviceReport`` (18 bytes) and ``AggExtra`` (an aggregator's named-array
side payload). All multi-byte fields are little-endian. Codecs (headers
and gamma are codec-independent):

    fp32       lossless float32 round-trip
    fp16       supports + coefs as float16
    int8       per-column affine int8 supports (scale/zero per feature
               column), fp32 coefs; decodes to a ``QuantizedSVM`` scored
               through the ``rbf_gram_q8`` kernel (no fp32 supports)
    topk       keep ceil(ratio * n) supports by |dual coefficient|, fp32;
               ``"topk:0.5"`` selects the ratio, default 0.25
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.averaging import LinearSVM
from repro_torch.core.ensemble import Ensemble, chunked_bucket_predict
from repro_torch.core.selection import DeviceReport
from repro_torch.core.svm import ConstantModel, SVMModel
from repro_torch.kernels import ops as kops
from repro_torch.utils.device import resolve_device

WIRE_MAGIC = b"OS"
WIRE_VERSION = 1

_HEADER = struct.Struct("<2sBBB")  # magic, version, kind, codec id

KIND_SVM = 1
KIND_LINEAR = 2
KIND_CONST = 3
KIND_ENSEMBLE = 4
KIND_REPORT = 5
KIND_AGG_EXTRA = 6

_SVM_PREFIX = struct.Struct("<IId")     # n, d, gamma
_LINEAR_PREFIX = struct.Struct("<Id")   # d, bias
_CONST_BODY = struct.Struct("<d")       # value
_COUNT = struct.Struct("<I")
_REPORT_BODY = struct.Struct("<IIfB")   # device_id, n_train, val_auc, eligible
_U8 = struct.Struct("<B")
_DIM = struct.Struct("<I")


@dataclasses.dataclass(frozen=True)
class Codec:
    """One entry of the codec registry; ``param`` is the topk keep ratio
    (unused by the other codecs)."""

    name: str
    codec_id: int
    param: float = 0.0

    @property
    def spec(self) -> str:
        """Round-trippable name (``get_codec(c.spec) == c``)."""
        if self.name == "topk":
            return f"topk:{self.param:g}"
        return self.name


CODECS: Dict[str, Codec] = {
    "fp32": Codec("fp32", 0),
    "fp16": Codec("fp16", 1),
    "int8": Codec("int8", 2),
    "topk": Codec("topk", 3, param=0.25),
}
_CODEC_BY_ID = {c.codec_id: c for c in CODECS.values()}


def get_codec(spec) -> Codec:
    """Resolve ``"fp16"`` / ``"topk:0.5"`` / a Codec instance."""
    if isinstance(spec, Codec):
        return spec
    name, _, param = str(spec).partition(":")
    if name not in CODECS:
        raise KeyError(f"unknown codec {spec!r}; options {sorted(CODECS)}")
    base = CODECS[name]
    if param:
        if name != "topk":
            raise ValueError(f"codec {name!r} takes no parameter, got {spec!r}")
        ratio = float(param)
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        return dataclasses.replace(base, param=ratio)
    return base


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class QuantizedSVM:
    """An int8-codec SVM payload kept in its wire representation.

    Scores through ``kernels.ops.rbf_gram_q8`` on ``device`` (the int8
    supports dequantised inside the kernel's tiles), then ``K @ coef``;
    ``dequantize()`` gives an explicit fp32 ``SVMModel``.
    """

    q: np.ndarray       # (n, d) int8 supports
    scale: np.ndarray   # (d,) fp32 per-column affine scale
    zero: np.ndarray    # (d,) fp32 per-column affine zero point
    coef: np.ndarray    # (n,) fp32 dual coefficients
    gamma: float
    device: str = dataclasses.field(default="cuda", compare=False)

    def predict(self, x: np.ndarray, chunk: int = 8192) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if len(x) == 0:
            return np.zeros(0, np.float32)
        dev = resolve_device(self.device)
        q, scale, zero, coef = (_tensor(a, dev) for a in (self.q, self.scale, self.zero,
                                                          self.coef))
        outs = []
        for start in range(0, len(x), chunk):
            K = kops.rbf_gram_q8(_tensor(x[start : start + chunk], dev), q, scale, zero,
                                 self.gamma)
            outs.append((K @ coef).cpu().numpy())
        return np.concatenate(outs)

    def dequantize(self) -> SVMModel:
        sup = self.q.astype(np.float32) * self.scale[None, :] + self.zero[None, :]
        return SVMModel(support_x=sup, coef=self.coef.copy(), gamma=self.gamma,
                        device=self.device)

    @property
    def nbytes(self) -> int:
        # repro: allow[wire-cost-honesty] reason=in-memory model footprint property, not a wire price
        return self.q.nbytes + self.scale.nbytes + self.zero.nbytes + self.coef.nbytes + 8


class QuantizedStackedEnsemble(nn.Module):
    """Packed homogeneous int8 ensemble, the quantized mirror of
    ``core.ensemble.StackedEnsemble``: registered buffers ``q``
    (k, n_max, d) int8 zero-padded supports, ``scale`` and ``zero``
    (k, d), ``coef`` (k, n_max) zero on padding, ``gammas`` (k,), all on
    the scoring device. Scores through ``kernels.ops.ensemble_score_q8``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                 coef: torch.Tensor, gammas: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.register_buffer("zero", zero)
        self.register_buffer("coef", coef)
        self.register_buffer("gammas", gammas)

    @property
    def k(self) -> int:
        return self.q.shape[0]

    @property
    def n_max(self) -> int:
        return self.q.shape[1]

    @property
    def d(self) -> int:
        return self.q.shape[2]

    @classmethod
    def from_members(cls, members: Sequence[QuantizedSVM],
                     device=None) -> "QuantizedStackedEnsemble":
        """Pack on the host (as the reference does), then move to
        ``device`` (default: the first member's)."""
        if not members:
            raise ValueError("empty ensemble")
        dev = resolve_device(members[0].device if device is None else device)
        n_max = max(len(m.coef) for m in members)
        k, d = len(members), members[0].q.shape[1]
        q = np.zeros((k, n_max, d), np.int8)
        scale = np.ones((k, d), np.float32)
        zero = np.zeros((k, d), np.float32)
        coef = np.zeros((k, n_max), np.float32)
        gammas = np.zeros((k,), np.float32)
        for i, m in enumerate(members):
            n = len(m.coef)
            q[i, :n] = m.q
            scale[i] = m.scale
            zero[i] = m.zero
            coef[i, :n] = m.coef
            gammas[i] = m.gamma
        return cls(*(_tensor(a, dev) for a in (q, scale, zero, coef, gammas)))

    def forward(self, x) -> torch.Tensor:
        """Fused mean member score for one query block. x: (b, d) -> (b,)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return kops.ensemble_score_q8(x.to(self.q.device), self.q, self.scale, self.zero,
                                      self.coef, self.gammas)

    def score(self, x) -> torch.Tensor:
        return self(x)

    def predict(self, x: np.ndarray, chunk: int = 4096) -> np.ndarray:
        """Chunked scoring with power-of-two bucket padding."""
        return chunked_bucket_predict(self.score, x, chunk)


@dataclasses.dataclass
class AggExtra:
    """Named-array side payload of an aggregator strategy (``repro_torch.agg``).

    Fisher diagonals, per-member validation columns, feature moments ride
    device -> server as one of these, encoded through the round's codec
    and priced at exactly ``len(encode())`` on the ledger under
    ``kind="agg_extra"``. Array names are ASCII, <= 255 bytes; arrays are
    host numpy with ndim >= 1. int8 quantizes per column over the LAST
    axis (a 1-D array is one column); topk has no sparse meaning for
    dense statistics and falls back to fp32.
    """

    arrays: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        for name, a in self.arrays.items():
            if not name or len(name.encode("ascii")) > 255:
                raise ValueError(f"agg-extra array name {name!r} must be 1..255 ASCII bytes")
            if np.asarray(a).ndim < 1:
                raise ValueError(f"agg-extra array {name!r} must have ndim >= 1")


def _quantize_columns(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column affine int8: q = round((x - zero) / scale) in [-127, 127]."""
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    scale = ((hi - lo) / 254.0).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1.0))
    zero = ((hi + lo) / 2.0).astype(np.float32)
    q = np.clip(np.round((x - zero) / scale), -127, 127).astype(np.int8)
    return q, scale, zero


def _arr(a: np.ndarray, dtype: str) -> bytes:
    return np.ascontiguousarray(a).astype(dtype).tobytes()


class WireReader:
    """Cursor over one wire message (validates magic/version up front)."""

    def __init__(self, blob: bytes):
        self.blob = blob
        self.off = 0
        magic, version, kind, codec_id = self.unpack(_HEADER)
        if magic != WIRE_MAGIC:
            raise ValueError(f"bad wire magic {magic!r}")
        if version != WIRE_VERSION:
            raise ValueError(f"unsupported wire version {version}")
        if codec_id not in _CODEC_BY_ID:
            raise ValueError(f"unknown codec id {codec_id}")
        self.kind = kind
        self.codec = _CODEC_BY_ID[codec_id]

    def unpack(self, st: struct.Struct):
        vals = st.unpack_from(self.blob, self.off)
        self.off += st.size
        return vals

    def array(self, count: int, dtype: str, shape=None) -> np.ndarray:
        nbytes = count * np.dtype(dtype).itemsize  # repro: allow[wire-cost-honesty] reason=decode cursor stride over an already-priced blob, not a wire price
        a = np.frombuffer(self.blob, dtype, count=count, offset=self.off).copy()
        self.off += nbytes
        return a if shape is None else a.reshape(shape)

    def take(self, n: int) -> bytes:
        out = self.blob[self.off : self.off + n]
        self.off += n
        return out


def _header(kind: int, codec: Codec) -> bytes:
    return _HEADER.pack(WIRE_MAGIC, WIRE_VERSION, kind, codec.codec_id)


def _encode_svm(model: SVMModel, codec: Codec) -> bytes:
    sup = np.asarray(model.support_x, np.float32)
    coef = np.asarray(model.coef, np.float32)
    n, d = sup.shape
    if codec.name == "topk":
        m = max(1, int(np.ceil(codec.param * n)))
        keep = np.sort(np.argsort(-np.abs(coef), kind="stable")[:m])
        sup, coef, n = sup[keep], coef[keep], m
    parts = [_header(KIND_SVM, codec), _SVM_PREFIX.pack(n, d, float(model.gamma))]
    if codec.name in ("fp32", "topk"):
        parts += [_arr(sup, "<f4"), _arr(coef, "<f4")]
    elif codec.name == "fp16":
        parts += [_arr(sup, "<f2"), _arr(coef, "<f2")]
    else:  # int8
        q, scale, zero = _quantize_columns(sup)
        parts += [_arr(scale, "<f4"), _arr(zero, "<f4"), q.tobytes(), _arr(coef, "<f4")]
    return b"".join(parts)


def _encode_quantized(model: QuantizedSVM) -> bytes:
    """Re-emit an int8 payload from its kept wire representation
    (bit-exact: no re-quantization)."""
    n, d = model.q.shape
    return b"".join([
        _header(KIND_SVM, CODECS["int8"]),
        _SVM_PREFIX.pack(n, d, float(model.gamma)),
        _arr(model.scale, "<f4"), _arr(model.zero, "<f4"),
        model.q.astype(np.int8).tobytes(), _arr(model.coef, "<f4"),
    ])


def _decode_svm(r: WireReader, device):
    n, d, gamma = r.unpack(_SVM_PREFIX)
    if r.codec.name in ("fp32", "topk"):
        sup = r.array(n * d, "<f4", (n, d))
        coef = r.array(n, "<f4")
        return SVMModel(support_x=sup, coef=coef, gamma=gamma, device=str(device))
    if r.codec.name == "fp16":
        sup = r.array(n * d, "<f2", (n, d)).astype(np.float32)
        coef = r.array(n, "<f2").astype(np.float32)
        return SVMModel(support_x=sup, coef=coef, gamma=gamma, device=str(device))
    scale = r.array(d, "<f4")
    zero = r.array(d, "<f4")
    q = r.array(n * d, "i1", (n, d))
    coef = r.array(n, "<f4")
    return QuantizedSVM(q=q, scale=scale, zero=zero, coef=coef, gamma=gamma,
                        device=str(device))


def _encode_linear(model: LinearSVM, codec: Codec) -> bytes:
    w = np.asarray(model.w, np.float32)
    d = len(w)
    parts = [_header(KIND_LINEAR, codec), _LINEAR_PREFIX.pack(d, float(model.b))]
    if codec.name == "fp32":
        parts.append(_arr(w, "<f4"))
    elif codec.name == "fp16":
        parts.append(_arr(w, "<f2"))
    elif codec.name == "int8":
        q, scale, zero = _quantize_columns(w[:, None])
        parts += [_arr(scale, "<f4"), _arr(zero, "<f4"), q.tobytes()]
    else:  # topk: keep top-|w| entries with their indices
        m = max(1, int(np.ceil(codec.param * d)))
        keep = np.sort(np.argsort(-np.abs(w), kind="stable")[:m])
        parts += [_COUNT.pack(m), _arr(keep, "<u4"), _arr(w[keep], "<f4")]
    return b"".join(parts)


def _decode_linear(r: WireReader, device) -> LinearSVM:
    d, b = r.unpack(_LINEAR_PREFIX)
    if r.codec.name == "fp32":
        w = r.array(d, "<f4")
    elif r.codec.name == "fp16":
        w = r.array(d, "<f2").astype(np.float32)
    elif r.codec.name == "int8":
        scale = r.array(1, "<f4")
        zero = r.array(1, "<f4")
        q = r.array(d, "i1")
        w = q.astype(np.float32) * scale[0] + zero[0]
    else:
        (m,) = r.unpack(_COUNT)
        idx = r.array(m, "<u4")
        vals = r.array(m, "<f4")
        w = np.zeros(d, np.float32)
        w[idx] = vals
    return LinearSVM(w=w, b=b, device=str(device))


def _encode_agg_extra(extra: AggExtra, codec: Codec) -> bytes:
    parts = [_header(KIND_AGG_EXTRA, codec), _U8.pack(len(extra.arrays))]
    for name, a in extra.arrays.items():
        a = np.asarray(a, np.float32)
        nb = name.encode("ascii")
        parts += [_U8.pack(len(nb)), nb, _U8.pack(a.ndim)]
        parts += [_DIM.pack(dim) for dim in a.shape]
        if codec.name == "fp16":
            parts.append(_arr(a, "<f2"))
        elif codec.name == "int8":
            cols = a.shape[-1] if a.ndim > 1 else 1
            if a.size == 0:  # zero rows OR zero cols: no quantizable body
                scale = np.ones(cols, np.float32)
                zero = np.zeros(cols, np.float32)
                q = np.zeros(0, np.int8)
            else:
                q, scale, zero = _quantize_columns(np.ascontiguousarray(a).reshape(-1, cols))
            parts += [_arr(scale, "<f4"), _arr(zero, "<f4"), q.tobytes()]
        else:  # fp32; topk has no sparse meaning for dense statistics
            parts.append(_arr(a, "<f4"))
    return b"".join(parts)


def _decode_agg_extra(r: WireReader) -> AggExtra:
    (count,) = r.unpack(_U8)
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(count):
        (name_len,) = r.unpack(_U8)
        name = r.take(name_len).decode("ascii")
        (ndim,) = r.unpack(_U8)
        shape = tuple(r.unpack(_DIM)[0] for _ in range(ndim))
        size = int(np.prod(shape, dtype=np.int64))
        if r.codec.name == "fp16":
            arrays[name] = r.array(size, "<f2", shape).astype(np.float32)
        elif r.codec.name == "int8":
            cols = shape[-1] if ndim > 1 else 1
            scale = r.array(cols, "<f4")
            zero = r.array(cols, "<f4")
            q = r.array(size, "i1", (-1, cols) if size else (0, cols))
            deq = q.astype(np.float32) * scale[None, :] + zero[None, :]
            arrays[name] = deq.reshape(shape)
        else:
            arrays[name] = r.array(size, "<f4", shape)
    return AggExtra(arrays)


def encode(obj, codec="fp32") -> bytes:
    """Encode a protocol payload; ``len(...)`` of the result is the
    exact number of bytes the message costs on the wire."""
    codec = get_codec(codec)
    if isinstance(obj, SVMModel):
        return _encode_svm(obj, codec)
    if isinstance(obj, QuantizedSVM):
        if codec.name != "int8":
            raise ValueError(
                f"QuantizedSVM payloads re-encode only as int8 (their kept "
                f"wire representation), not {codec.name!r}; dequantize() first"
            )
        return _encode_quantized(obj)
    if isinstance(obj, LinearSVM):
        return _encode_linear(obj, codec)
    if isinstance(obj, ConstantModel):
        return _header(KIND_CONST, codec) + _CONST_BODY.pack(float(obj.value))
    if isinstance(obj, Ensemble):
        blobs = [encode(m, codec) for m in obj.members]
        return b"".join(
            [_header(KIND_ENSEMBLE, codec), _COUNT.pack(len(blobs))]
            + [_COUNT.pack(len(b)) + b for b in blobs]
        )
    if isinstance(obj, DeviceReport):
        return _header(KIND_REPORT, codec) + _REPORT_BODY.pack(
            obj.device_id, obj.n_train, float(obj.val_auc), int(obj.eligible)
        )
    if isinstance(obj, AggExtra):
        return _encode_agg_extra(obj, codec)
    raise TypeError(f"cannot wire-encode {type(obj).__name__}")


def decode(blob: bytes, *, device="cuda"):
    """Decode one wire message; decoded models score on ``device``. int8
    SVM payloads decode to a ``QuantizedSVM``."""
    r = WireReader(blob)
    if r.kind == KIND_SVM:
        return _decode_svm(r, device)
    if r.kind == KIND_LINEAR:
        return _decode_linear(r, device)
    if r.kind == KIND_CONST:
        (value,) = r.unpack(_CONST_BODY)
        return ConstantModel(value)
    if r.kind == KIND_ENSEMBLE:
        (count,) = r.unpack(_COUNT)
        members = []
        for _ in range(count):
            (nbytes,) = r.unpack(_COUNT)
            members.append(decode(r.take(nbytes), device=device))
        return Ensemble(members)
    if r.kind == KIND_REPORT:
        device_id, n_train, val_auc, eligible = r.unpack(_REPORT_BODY)
        return DeviceReport(device_id, n_train, float(val_auc), bool(eligible))
    if r.kind == KIND_AGG_EXTRA:
        return _decode_agg_extra(r)
    raise ValueError(f"unknown wire kind {r.kind}")


def encoded_nbytes(obj, codec="fp32") -> int:
    """Exact encoded size; defined as ``len(encode(obj, codec))``."""
    return len(encode(obj, codec))


def svm_wire_nbytes(n: int, d: int, codec="fp32") -> int:
    """Exact ``len(encode(SVMModel, codec))`` from the model's shape
    alone: every codec's payload size is shape-deterministic."""
    codec = get_codec(codec)
    base = _HEADER.size + _SVM_PREFIX.size
    if codec.name == "fp32":
        return base + n * d * 4 + n * 4
    if codec.name == "fp16":
        return base + n * d * 2 + n * 2
    if codec.name == "int8":
        return base + d * 4 + d * 4 + n * d + n * 4
    m = max(1, int(np.ceil(codec.param * n)))  # topk
    return base + m * d * 4 + m * 4


def agg_extra_wire_nbytes(shapes: Dict[str, Tuple[int, ...]], codec="fp32") -> int:
    """Exact ``len(encode(AggExtra, codec))`` from array SHAPES alone, so
    the streamed round prices extras without regenerating device state."""
    codec = get_codec(codec)
    total = _HEADER.size + _U8.size
    for name, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        size = int(np.prod(shape, dtype=np.int64))
        total += _U8.size + len(name.encode("ascii")) + _U8.size + _DIM.size * len(shape)
        if codec.name == "fp16":
            total += size * 2
        elif codec.name == "int8":
            cols = shape[-1] if len(shape) > 1 else 1
            total += cols * 4 + cols * 4 + size
        else:  # fp32 / topk (dense-statistics fallback)
            total += size * 4
    return total


# the pre-round metadata exchange costs exactly this much per device
REPORT_NBYTES = len(encode(DeviceReport(0, 0, 0.5, True)))


def payload_to_tree(blob: bytes) -> Dict[str, np.ndarray]:
    """Wrap a wire payload as a one-leaf tree so it can ride through the
    npz checkpoint manager (``checkpoint.manager.save_payload``)."""
    return {"wire": np.frombuffer(blob, np.uint8).copy()}


def tree_to_payload(tree: Dict[str, np.ndarray]) -> bytes:
    return np.asarray(tree["wire"], np.uint8).tobytes()
