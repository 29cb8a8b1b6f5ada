"""Versioned wire format for the one-shot upload path (fp32 codec).

Port of ``repro.comm.wire``'s fp32 paths, byte for byte: the same
header, structs and body layouts, so a blob from either package decodes
in the other and identical models encode to identical bytes.

    +-------+---------+------+----------+------------------------+
    | magic | version | kind | codec id | kind-specific body     |
    | "OS"  |  u8     | u8   | u8       | ...                    |
    +-------+---------+------+----------+------------------------+

``len(encode(obj, codec))`` IS the communication cost. Payload kinds:
``SVMModel``, ``ConstantModel``, ``Ensemble`` (length-prefixed member
messages) and ``DeviceReport`` (18 bytes). All multi-byte fields are
little-endian. The other codecs (fp16, int8, topk) and the linear and
aggregator-extra kinds are not ported yet: encoding or decoding them
raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict

import numpy as np

from repro_torch.core.ensemble import Ensemble
from repro_torch.core.selection import DeviceReport
from repro_torch.core.svm import ConstantModel, SVMModel

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
_CONST_BODY = struct.Struct("<d")       # value
_COUNT = struct.Struct("<I")
_REPORT_BODY = struct.Struct("<IIfB")   # device_id, n_train, val_auc, eligible

# the reference's codec ids; only fp32 is ported
_UNPORTED_CODECS = {"fp16": 1, "int8": 2, "topk": 3}
_UNPORTED_KINDS = {KIND_LINEAR: "LinearSVM (ROADMAP queue 1 item 10)",
                   KIND_AGG_EXTRA: "AggExtra (ROADMAP queue 1 item 10)"}


@dataclasses.dataclass(frozen=True)
class Codec:
    """One entry of the codec registry."""

    name: str
    codec_id: int

    @property
    def spec(self) -> str:
        return self.name


CODECS: Dict[str, Codec] = {"fp32": Codec("fp32", 0)}
_CODEC_BY_ID = {c.codec_id: c for c in CODECS.values()}


def _unported_codec(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"codec {what} is not ported yet (ROADMAP queue 1 item 8); "
        "the port speaks fp32")


def get_codec(spec) -> Codec:
    """Resolve ``"fp32"`` / a Codec instance."""
    if isinstance(spec, Codec):
        return spec
    name = str(spec).partition(":")[0]
    if name in _UNPORTED_CODECS:
        raise _unported_codec(repr(spec))
    if name not in CODECS or str(spec) != name:
        raise KeyError(f"unknown codec {spec!r}; options {sorted(CODECS)}")
    return CODECS[name]


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
        if codec_id in _UNPORTED_CODECS.values():
            raise _unported_codec(f"id {codec_id}")
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
    return b"".join([_header(KIND_SVM, codec), _SVM_PREFIX.pack(n, d, float(model.gamma)),
                     _arr(sup, "<f4"), _arr(coef, "<f4")])


def _decode_svm(r: WireReader, device) -> SVMModel:
    n, d, gamma = r.unpack(_SVM_PREFIX)
    sup = r.array(n * d, "<f4", (n, d))
    coef = r.array(n, "<f4")
    return SVMModel(support_x=sup, coef=coef, gamma=gamma, device=str(device))


def encode(obj, codec="fp32") -> bytes:
    """Encode a protocol payload; ``len(...)`` of the result is the
    exact number of bytes the message costs on the wire."""
    codec = get_codec(codec)
    if isinstance(obj, SVMModel):
        return _encode_svm(obj, codec)
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
    raise TypeError(f"cannot wire-encode {type(obj).__name__}")


def decode(blob: bytes, *, device="cuda"):
    """Decode one wire message; decoded SVMs score on ``device``."""
    r = WireReader(blob)
    if r.kind == KIND_SVM:
        return _decode_svm(r, device)
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
    if r.kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"wire kind {_UNPORTED_KINDS[r.kind]} is not ported yet")
    raise ValueError(f"unknown wire kind {r.kind}")


def encoded_nbytes(obj, codec="fp32") -> int:
    """Exact encoded size; defined as ``len(encode(obj, codec))``."""
    return len(encode(obj, codec))


# the pre-round metadata exchange costs exactly this much per device
REPORT_NBYTES = len(encode(DeviceReport(0, 0, 0.5, True)))
