"""Kernel profiling hooks — every dispatched kernel call becomes a span.

A port of ``repro.obs.profile``. ``kernels/ops.py`` routes every public
kernel dispatch through ``maybe_profile(name, fn, *args)``. With no
tracer installed this is one attribute check and a tail call: the
dispatch pays nothing and synchronises nothing. With a tracer active,
each call is timed to completion (on a CUDA tensor with CUDA events
around the call and a synchronise on the end event; on the CPU with the
host clock) and emitted as a ``cat="kernel"`` complete event
``kernel.<name>`` whose attributes carry the achieved-vs-roofline
accounting, under the reference's keys:

  * ``backend`` (the device type of the call's first tensor), ``dur_s``;
  * ``flops`` / ``bytes_accessed`` — ``kernel_cost``: torch has no XLA
    ``cost_analysis``, so the work is counted analytically from the
    arguments (each input read once, each output written once; SDCA's
    steps from its ``n_real``, attention's pairs from its masks);
  * ``achieved_gflops`` — flops / measured seconds;
  * ``roofline_bound_us`` / ``roofline_frac`` / ``dominant`` — the
    three-term model of ``roofline.analysis.roofline_report`` (no
    collective term for a single kernel call).

The sheet a call is priced on (``hardware_for``): ``H100_SXM`` (16-bit
tensor cores) when the kernel computes the call in bfloat16 or float16,
``H100_SXM_FP32`` otherwise; ``set_hardware(hw)`` puts one sheet in place for every call
(``set_hardware(V5E)`` prices as the reference does) and
``set_hardware(None)`` goes back to the per-dtype choice. On the per-dtype
sheets the cross term (2 m n d of the operations) of a kernel that runs it
as bf16 plane products on the tensor cores is priced at the tensor cores'
bf16 rate over the number of those products (``PLANE_PRODUCTS``):
``gram_matvec``'s six, both operands in three planes (989 / 6 TFLOP/s;
3xTF32 gives the same, 495 / 3), ``rbf_gram_q8``'s three, x * scale in
three planes against int8 values exact in bf16 (989 / 3); their other
operations at the fp32 rate: the bound is the largest of those two times
and the bytes' (``priced``). ``chip_smoke.py`` takes its kernels'
bounds from these same functions, so a span's ``roofline_bound_us`` and
the timing table's bound are one number.

``timed_call`` is the shared benchmark timing helper (warmup + repeats,
each ended by a synchronise when its result lies on the card) built on
the same span emission.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import current_tracer
from repro_torch.roofline.analysis import H100_SXM, H100_SXM_FP32, HardwareSpec, roofline_report
from repro_torch.utils.trees import tree_leaves

_HW: Optional[HardwareSpec] = None   # None: priced by the call's first operand
# bf16 products a kernel's fp32-accurate cross term runs on the tensor cores
PLANE_PRODUCTS = {"gram_matvec": 6, "rbf_gram_q8": 3}


def set_hardware(hw: Optional[HardwareSpec]) -> None:
    """Swap the roofline sheet kernel spans are priced against (``None``:
    by the first operand's dtype)."""
    global _HW
    _HW = hw


def hardware_for(args: tuple, name: Optional[str] = None) -> HardwareSpec:
    """The sheet a call of kernel ``name`` with ``args`` is priced on: the
    tensor cores' (``H100_SXM``) when it computes in bfloat16 or float16,
    the fp32 one otherwise. Flash attention says which type a call runs
    in (``flash_attention.run_dtype``); any other call runs in its
    tensors' one type (fp32 where they differ)."""
    if _HW is not None:
        return _HW
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import run_dtype

        dtype = run_dtype(*args[:3])
    else:
        dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor)}
        dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    return H100_SXM if dtype in (torch.bfloat16, torch.float16) else H100_SXM_FP32


# ----------------------------------------------------------------------
# analytic work: (operations, bytes) of one call
# ----------------------------------------------------------------------

def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes  # repro: allow[wire-cost-honesty] reason=the bytes a kernel call moves, for its roofline bound, not a wire price


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the causal and window masks leave, per (batch, head)."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def gram_work(g: int, m: int, n: int, d: int, same: bool = False,
              gammas: bool = True) -> Tuple[int, int]:
    """(operations, bytes) of g RBF Grams (m, n, d): norms 2d a row; per
    pair 2d for the cross term, 3 to combine, clamp, scale, exp. An operand
    passed as both x1 and x2 (a fit) is read once; per-device gammas add g
    floats."""
    ops = g * (m * n * (2 * d + 6) + 2 * d * (m + (0 if same else n)))
    nbytes = 4 * (g * (m + (0 if same else n)) * d + g * m * n + (g if gammas else 0))
    return ops, nbytes


def _host_ints(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.int64)
    return np.asarray(a).astype(np.int64)


def _work(name: str, args: tuple) -> Tuple[int, int]:
    if name in ("batched_rbf_gram", "rbf_gram"):
        x1, x2 = args[0], args[1]
        g = x1.shape[0] if x1.ndim == 3 else 1
        m, d = x1.shape[-2:]
        return gram_work(g, m, x2.shape[-2], d, same=x2 is x1, gammas=x1.ndim == 3)
    if name == "ensemble_score":
        x, sup = args[0], args[1]
        b, d = x.shape
        k, n_max, _ = sup.shape
        # per pair: 2d cross, 3 combine, clamp, scale, exp, 2 for coef*K + sum
        ops = b * k * n_max * (2 * d + 8) + 2 * d * (b + k * n_max) + b
        nbytes = 4 * (b * d + k * n_max * d + k * n_max + k + b)
        return ops, nbytes
    if name == "gram_matvec":
        x1, x2 = args[0], args[1]
        m, d = x1.shape
        n = x2.shape[0]
        # per pair: 2d cross, 3 combine, clamp, scale, exp, 2 for v*K + sum
        ops = m * n * (2 * d + 8) + 2 * d * (m + n)
        nbytes = 4 * (m * d + n * d + n + m)
        return ops, nbytes
    if name == "rbf_gram_q8":
        x, q = args[0], args[1]
        m, d = x.shape
        n = q.shape[0]
        ops = m * n * (2 * d + 6) + 2 * d * (m + n) + 2 * n * d
        nbytes = 4 * m * d + n * d + 4 * 2 * d + 4 * m * n
        return ops, nbytes
    if name == "ensemble_score_q8":
        x, q = args[0], args[1]
        b, d = x.shape
        k, n_max, _ = q.shape
        ops = (b * k * n_max * (2 * d + 8) + 2 * d * (b + k * n_max) + b
               + 2 * k * n_max * d)
        nbytes = 4 * b * d + k * n_max * d + 4 * (2 * k * d + k * n_max + k + b)
        return ops, nbytes
    if name == "flash_attention":
        q, k = args[0], args[1]
        causal, window = (args[3], args[4]) if len(args) > 3 else (True, 0)
        B, Sq, H, hd = q.shape
        # per unmasked pair: hd multiply-adds for q.k and hd for p v
        ops = B * H * attention_pairs(Sq, k.shape[1], causal, window) * 4 * hd
        # q and o, k and v: each read or written once
        nbytes = 2 * (_nbytes(q) + _nbytes(k))
        return ops, nbytes
    if name == "sdca":
        K, n_real, epochs = args[0], args[2], args[4]
        g, b, _ = K.shape
        n = _host_ints(n_real)
        # K*y once, then per step a length-n dot (2n) and ~8 scalar ops
        ops = int((n * n + epochs * n * (2 * n + 8)).sum())
        nbytes = 4 * (g * b * b + g * b + g + g * b)
        return ops, nbytes
    raise KeyError(name)


def kernel_cost(name: str, fn: Optional[Callable], args: tuple) -> Optional[Tuple[float, float]]:
    """(flops, bytes accessed) of the call ``name(*args)``, counted from
    the arguments (``fn`` is not run or read); None for a function whose
    work has no formula here. Arguments may be tensors on any device
    (the ``meta`` device too: only shapes are read, SDCA's ``n_real``
    aside) or numpy arrays."""
    try:
        ops, nbytes = _work(name, args)
    except KeyError:
        return None
    return float(ops), float(nbytes)


def priced(name: str, args: tuple, flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, ``roofline_report``'s "compute" or "memory") of a
    call of ``name`` that does ``flops`` operations on ``nbytes`` bytes:
    ``roofline_report`` on ``hardware_for(args)``, but for a kernel of
    ``PLANE_PRODUCTS`` on the per-dtype sheets its cross term at the bf16
    rate over its products and the rest at the fp32 rate (module
    docstring)."""
    if name in PLANE_PRODUCTS and _HW is None:
        (m, d), n = args[0].shape, args[1].shape[0]
        cross = 2.0 * m * n * d
        rate = H100_SXM.peak_flops / PLANE_PRODUCTS[name]
        terms = {"compute": max(cross / rate, (flops - cross) / H100_SXM_FP32.peak_flops),
                 "memory": nbytes / H100_SXM_FP32.hbm_bw}
        dominant = max(terms, key=terms.get)
        return terms[dominant], dominant
    rl = roofline_report(flops, nbytes, 0.0, hw=hardware_for(args, name))
    return rl["step_lower_bound_s"], rl["dominant"]


def kernel_bound(name: str, args: tuple) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes"): ``priced`` of
    ``kernel_cost``, the bound a kernel span carries as
    ``roofline_bound_us``."""
    flops, nbytes = kernel_cost(name, None, args)
    bound, dominant = priced(name, args, flops, nbytes)
    return bound, "operations" if dominant == "compute" else "bytes"


# ----------------------------------------------------------------------
# the dispatch hook
# ----------------------------------------------------------------------

def _device_of(args: tuple) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _wait(out) -> None:
    """Block until every CUDA tensor in ``out`` is computed."""
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


def maybe_profile(name: str, fn: Callable, *args):
    """The ops.py dispatch hook: call through, and when a tracer is
    installed, time the call to completion and attach the roofline
    accounting to a kernel span."""
    tracer = current_tracer()
    if not tracer.enabled:
        return fn(*args)
    cost = kernel_cost(name, fn, args)
    dev = _device_of(args)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
        out = fn(*args)
        dt = time.perf_counter() - t0  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
    attrs = {"backend": dev.type, "dur_s": dt}
    if cost is not None:
        flops, nbytes = cost
        bound, dominant = priced(name, args, flops, nbytes)
        attrs.update(
            flops=flops,
            bytes_accessed=nbytes,
            achieved_gflops=flops / max(dt, 1e-12) / 1e9,
            roofline_bound_us=bound * 1e6,
            roofline_frac=bound / max(dt, 1e-12),
            dominant=dominant,
        )
    ts = tracer.clock() if hasattr(tracer, "clock") else 0.0
    tracer.complete(f"kernel.{name}", ts - dt * 1e6, dt * 1e6,
                    cat="kernel", **attrs)
    return out


def timed_call(name: str, fn: Callable, repeats: int = 5, warmup: int = 2) -> float:
    """Warmup + repeat timing of ``fn()`` to completion; returns mean
    microseconds per call. Each timed repeat is emitted as a
    ``cat="bench"`` span on the current tracer."""
    tracer = current_tracer()
    for _ in range(warmup):
        _wait(fn())
    total = 0.0
    for i in range(repeats):
        t0 = time.perf_counter()  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
        _wait(fn())
        dt = time.perf_counter() - t0  # repro: allow[wall-clock-ban] reason=the port's obs layer owns its clock reads, as repro/obs does
        total += dt
        if tracer.enabled:
            ts = tracer.clock() if hasattr(tracer, "clock") else 0.0
            tracer.complete(f"bench.{name}", ts - dt * 1e6, dt * 1e6,
                            cat="bench", repeat=i)
    return total / repeats * 1e6
