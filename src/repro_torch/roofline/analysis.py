"""Three-term roofline model: the least time a step or a call can take.

    compute    = FLOPs_per_chip / peak_FLOP/s
    memory     = bytes_per_chip / HBM_bw
    collective = collective_bytes_per_chip / link_bw

A copy of ``repro.roofline.analysis`` (the same ``HardwareSpec`` fields,
``roofline_report`` formulas and HLO collective parser) with two sheets
for the card beside the reference's ``V5E``. The port has no XLA
``cost_analysis``: its FLOPs and bytes come from analytic counts over
the arguments' shapes (``repro_torch.obs.profile.kernel_cost`` for a
kernel call). ``collective_bytes_from_hlo`` parses HLO text as the
reference's does, for reading the reference's dry-run artifacts; no
path of the port produces HLO.

Sheets:
  * ``H100_SXM``: one NVIDIA H100 SXM5, bf16 tensor cores dense
    (989 TFLOP/s) and HBM3 (3.35 TB/s), NVIDIA's data sheet at the
    700 W limit;
  * ``H100_SXM_FP32``: the same card priced at fp32 outside the tensor
    cores (67 TFLOP/s), the rate the fp32 kernels run at;
  * ``V5E``: the reference's TPU sheet, kept so both packages can be
    priced on one sheet in the parity tests. No figure of it is the
    card's.

``link_bw`` of the H100 sheets is one NVLink-4 link, 50 GB/s (900 GB/s
over 18 links); no path on one card reads it.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # FLOP/s per chip at the sheet's precision
    hbm_bw: float  # bytes/s per chip
    link_bw: float  # interconnect bytes/s per link


V5E = HardwareSpec(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
H100_SXM = HardwareSpec(name="h100-sxm-bf16", peak_flops=989e12, hbm_bw=3.35e12,
                        link_bw=50e9)
H100_SXM_FP32 = dataclasses.replace(H100_SXM, name="h100-sxm-fp32", peak_flops=67e12)


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# shapes like  bf16[16,512,128]{2,1,0}  or  f32[]  possibly inside tuples
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# instruction line:  %name = <shape-or-tuple> opcode(...)
_INSTR_RE = re.compile(r"=\s*(\([^)]*\)|[^\s]+)\s+([\w-]+)")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, int]:
    """Per-collective-op byte totals from a (post-SPMD) HLO module."""
    out = {k: 0 for k in _COLLECTIVES}
    out["start_ops"] = 0
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        shape_str, opcode = m.groups()
        base = opcode
        for suffix in ("-start", "-done"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
        if base in _COLLECTIVES:
            if opcode.endswith("-done"):
                continue  # avoid double count of async pairs
            out[base] += _shape_bytes(shape_str)
            if opcode.endswith("-start"):
                out["start_ops"] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def roofline_report(
    flops_per_chip: float,
    bytes_per_chip: float,
    collective_bytes_per_chip: float,
    hw: HardwareSpec = V5E,
    model_flops: Optional[float] = None,
    chips: int = 1,
) -> Dict[str, float]:
    t_compute = flops_per_chip / hw.peak_flops
    t_memory = bytes_per_chip / hw.hbm_bw
    t_coll = collective_bytes_per_chip / hw.link_bw
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    report = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "flops_per_chip": flops_per_chip,
        "bytes_per_chip": bytes_per_chip,
        "collective_bytes_per_chip": collective_bytes_per_chip,
        "chips": chips,
    }
    if model_flops:
        report["model_flops"] = model_flops
        report["useful_flops_ratio"] = model_flops / max(flops_per_chip * chips, 1.0)
        # MFU bound if the step ran exactly at the roofline bound
        report["mfu_at_bound"] = model_flops / (chips * hw.peak_flops * bound) if bound > 0 else 0.0
    return report
