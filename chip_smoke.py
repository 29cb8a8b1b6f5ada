#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports the port and nothing of JAX or of the reference package
``repro``, and runs eight phases, each printing one JSON line on stdout:

  build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
           for sm_90a, one ``nvcc`` per source, all started together;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes and one ragged shape, at the registry's
           tolerance; flash attention in fp32 and bf16 at head dims 32, 64
           and 128, 1, 4 and 6 query heads per KV head, causal, causal with
           a window, non-causal, ragged lengths and the serve shape;
  parity   ``run_protocol`` on the full gleam federation three ways
           (bucketed on cuda, bucketed on cpu through the plain versions,
           the loop tier on cuda), then the int8 round with CG
           distillation on cuda and on cpu: equal ledgers (the student's
           download included), selected ids and best k, AUCs (the
           distilled one included) within 1e-4;
  main     ``run_protocol`` on the full-scale emnist federation on cuda
           (``benchmarks/fig1_mean_auc.py``'s setting): the seconds of each
           ``round.*`` span, the AUCs, and each kernel's launches in that
           run, all four of the fp32 round's kernels > 0; then the same
           round once more under ``torch.profiler`` for the device's busy
           share;
  main_q8  the same federation with the int8 codec and CG distillation on
           4,096 validation-pool proxy rows: spans (``distill.round``
           included), AUCs (the distilled student's included), the
           student's support count and codec, and each kernel's launches,
           all seven > 0, ``gram_matvec``'s equal to the CG iterations;
           then once more under the profiler;
  lm_parity  llama3.2-1b at full width cut to 2 layers, fp32, with the
           flash kernel (``use_pallas``): 2 prompts of 200 tokens and 8
           greedy tokens through ``launch/serve.py``'s ``serve_prompts`` on
           cuda and on cpu (the plain versions): equal tokens, last-position
           logits within LM_LOGIT_TOL;
  serve    the full 16-layer bf16 llama3.2-1b from the port's seeded init:
           4 requests of 2,048 prompt tokens from
           ``make_federated_lm_data`` through the ``MicroBatchScheduler``,
           32 greedy tokens each: flash launches (exactly one per layer)
           and peak memory of that first serve, prefill and decode seconds
           and tokens/s of it (cold) and of a second serve (warm); then
           the same serve once more under the profiler;
  timing   each kernel and its plain version, in turns (plain, kernel,
           kernel, plain) with CUDA events, at main-path shapes, beside the
           analytic bound: the larger of operations over the card's peak
           for the inputs' type (67 TFLOP/s fp32 outside the tensor cores,
           989 TFLOP/s bf16 dense) and bytes (each input read once, each
           output written once) over 3.35 TB/s, the H100 SXM's published
           peaks; flash attention also beside ``library_ms``, one call of
           ``torch.nn.functional.scaled_dot_product_attention`` on the same
           tensors (a yardstick only: the port never calls it).

The last three lines are the per-kernel summary ``{"kernels": [...]}``
(each kernel's launches read from the run it was ported for: ``main``
for the four fp32 kernels, ``main_q8`` for the three int8/CG ones,
``serve`` for flash attention, named in ``launches_path``), the card's
name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``. A failed phase exits non-zero without
that last line, and so does a machine without a CUDA device or a
directory without the port's sources. ``--phases`` runs a subset (for a
first check of a new kernel: ``--phases build,kernels``); ``--out FILE``
writes the compiler's log and the detailed timings there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "main", "main_q8", "lm_parity", "serve", "timing")
AUC_TOL = 1e-4                    # the reference's engine-tier tolerance
PEAK_FP32_OPS = 67e12             # H100 SXM fp32 outside the tensor cores
PEAK_BF16_OPS = 989e12            # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
MAIN_KS = (1, 10, 50, 100)        # fig1_mean_auc.py's ks at emnist scale
PARITY_KS = (1, 10, 38)
FP32_KERNELS = ("batched_rbf_gram", "rbf_gram", "ensemble_score", "sdca")
Q8_KERNELS = ("gram_matvec", "rbf_gram_q8", "ensemble_score_q8")
LAUNCHES_PATH = {**{n: "main" for n in FP32_KERNELS}, **{n: "main_q8" for n in Q8_KERNELS},
                 "flash_attention": "serve"}
# bf16 keeps 8 significant bits: two fp32 results a rounding error apart can
# round to neighbouring bf16 values, at most 2^-7 of the value apart; the
# absolute term covers the fp32 difference itself near zero
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
# full-width logits (unit scale) after 2 fp32 layers whose sums (up to 8,192
# terms) run in another order on each device: ~1e-5 expected
LM_LOGIT_TOL = 1e-3
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "llama3.2-1b", 4, 2048, 32
# (label, (B, S, H, K, hd), causal, window); the last is the serve phase's prefill
FLASH_SHAPES = (
    ("hd32 rep1 causal", (2, 256, 4, 4, 32), True, 0),
    ("hd64 rep4 causal window100", (2, 300, 8, 2, 64), True, 100),
    ("hd128 rep6 non-causal", (1, 256, 12, 2, 128), False, 0),
    ("hd128 rep6 causal ragged333", (1, 333, 12, 2, 128), True, 0),
    ("hd64 rep4 non-causal window64 ragged201", (2, 201, 8, 2, 64), False, 64),
    ("serve b4 s2048 h32 k8 hd64 causal", (4, 2048, 32, 8, 64), True, 0),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# inputs at the main path's shapes
# ----------------------------------------------------------------------

def _gram_inputs(rng, g, m, n, d):
    x1 = rng.normal(size=(g, m, d)).astype("float32")
    x2 = rng.normal(size=(g, n, d)).astype("float32")
    gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=g))).astype("float32")
    return x1, x2, gam


def kernel_cases(rng, ops):
    """name -> [(label, numpy args)]: the main path's shapes, then the
    registry's ragged shape. Shapes follow the full emnist round (d = 32;
    SDCA buckets 64..256 in groups of up to 256 devices; val/test queries
    padded to 8 rows; 8192-row scoring chunks; 2,821 eligible members of
    up to 230 supports; the 2,000-row pooled ideal, SDCA bucket 2048) and
    its int8 + distillation leg (CG on 4,096 proxy rows; the 4,096-support
    int8 student scored in 8192-row chunks). int8 supports are quantised
    from normal data by the port's own codec, so scale and zero are what
    the wire gives."""
    import numpy as np
    import torch

    from repro_torch.comm.wire import _quantize_columns

    def gram1(m, n, d):
        x1, x2, _ = _gram_inputs(rng, 1, m, n, d)
        return x1[0], x2[0], float(1.0 / d)

    def ens(b, k, n_max, d):
        x = rng.normal(size=(b, d)).astype(np.float32)
        sup = rng.normal(size=(k, n_max, d)).astype(np.float32)
        # trained models' scale: coef = alpha * y / (lam * n), alpha in [0, 1]
        sign = np.where(rng.random((k, n_max)) < 0.5, -1.0, 1.0)
        coef = (rng.random((k, n_max)) * sign / (0.01 * n_max)).astype(np.float32)
        gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=k))).astype(np.float32)
        return x, sup, coef, gam

    def ens_q8(b, k, n_max, d):
        x, sup, coef, gam = ens(b, k, n_max, d)
        q = np.empty((k, n_max, d), np.int8)
        scale = np.empty((k, d), np.float32)
        zero = np.empty((k, d), np.float32)
        for t in range(k):
            q[t], scale[t], zero[t] = _quantize_columns(sup[t])
        return x, q, scale, zero, coef, gam

    def matvec(l, d):
        xp = rng.normal(size=(l, d)).astype(np.float32)
        v = rng.normal(size=l).astype(np.float32)
        return xp, xp, v, float(1.0 / (d * xp.var()))

    def gram_q8(m, n, d):
        x = rng.normal(size=(m, d)).astype(np.float32)
        q, scale, zero = _quantize_columns(rng.normal(size=(n, d)).astype(np.float32))
        return x, q, scale, zero, float(1.0 / d)

    def sdca(g, b, lo, hi):
        n_real = rng.integers(lo, hi + 1, size=g)
        return ops.make_sdca_problem(rng, g=g, b=b, d=32, n_real=n_real)

    def flash(shape, causal, window, dtype):
        B, S, H, K, hd = shape
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32))
                   .to(dtype) for h in (H, K, K))
        return q, k, v, causal, window

    cases = {
        "batched_rbf_gram": [
            ("fit g256 b64", _gram_inputs(rng, 256, 64, 64, 32)),
            ("fit g128 b256", _gram_inputs(rng, 128, 256, 256, 32)),
            ("score g256 q56 b64", _gram_inputs(rng, 256, 56, 64, 32)),
            ("score g128 q184 b256", _gram_inputs(rng, 128, 184, 256, 32)),
        ],
        "rbf_gram": [
            ("ideal 2000x2000x32", gram1(2000, 2000, 32)),
        ],
        "ensemble_score": [
            ("full b8192 k2821 n230", ens(8192, 2821, 230, 32)),
            ("k100 b8192 n230", ens(8192, 100, 230, 32)),
            ("ideal predict b8192 k1 n2000", ens(8192, 1, 2000, 32)),
        ],
        "sdca": [
            ("group g256 b64", sdca(256, 64, 33, 64)),
            ("group g128 b256", sdca(128, 256, 193, 256)),
            ("ideal g1 b2048 n2000", sdca(1, 2048, 2000, 2000)),
        ],
        "gram_matvec": [
            ("cg l4096 d32", matvec(4096, 32)),
        ],
        "rbf_gram_q8": [
            ("student predict b8192 n4096 d32", gram_q8(8192, 4096, 32)),
        ],
        "ensemble_score_q8": [
            ("full b8192 k2821 n230", ens_q8(8192, 2821, 230, 32)),
            ("k100 b8192 n230", ens_q8(8192, 100, 230, 32)),
        ],
        "flash_attention": [
            (f"{label} {dt}", flash(shape, causal, window, getattr(torch, dt)))
            for dt in ("bfloat16", "float32")
            for label, shape, causal, window in FLASH_SHAPES
        ],
    }
    for name, spec in ops.KERNEL_REGISTRY.items():
        cases[name].append(("ragged", spec.make_ragged(rng)))
    return cases


def to_device(args, device):
    import numpy as np
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray)
                 else a.to(device) if isinstance(a, torch.Tensor) else a for a in args)


def agreement(spec, got, want):
    """(max |kernel - plain|, within tolerance, the tolerance): the
    registry's tol in fp32; in bf16, compared in fp32, at most
    BF16_ATOL + BF16_RTOL |plain| element by element."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    finite = bool(torch.isfinite(got).all())
    if got.dtype == torch.bfloat16:
        ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
        return err, finite and ok, f"{BF16_ATOL} + 2^-7 |plain|"
    return err, finite and err <= spec.tol, spec.tol


def _nbytes(a):
    return a.numel() * a.element_size() if hasattr(a, "element_size") else a.nbytes


def attention_pairs(Sq, Skv, causal, window):
    """(query, key) pairs the causal and window masks leave, per (batch, head)."""
    import numpy as np

    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


# ----------------------------------------------------------------------
# analytic bounds: (fp32 operations, bytes) of one call
# ----------------------------------------------------------------------

def work_of(name, args):
    """Operations and bytes the function needs for these inputs (each
    input read once, each output written once, int8 supports at one byte
    an element and two operations an element to dequantise; SDCA counts
    the steps its n_real coordinates take)."""
    if name in ("batched_rbf_gram", "rbf_gram"):
        x1, x2 = args[0], args[1]
        g = x1.shape[0] if x1.ndim == 3 else 1
        m, d = x1.shape[-2:]
        n = x2.shape[-2]
        # norms 2d per row; per pair: 2d cross, 3 combine, clamp, scale, exp
        ops = g * (m * n * (2 * d + 6) + 2 * d * (m + n))
        nbytes = 4 * (g * (m + n) * d + g * m * n + (g if x1.ndim == 3 else 0))
        return ops, nbytes
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
        n = n_real.astype("int64")
        # K*y once, then per step a length-n dot (2n) and ~8 scalar ops
        ops = int((n * n + epochs * n * (2 * n + 8)).sum())
        nbytes = 4 * (g * b * b + g * b + g + g * b)
        return ops, nbytes
    raise KeyError(name)


def bound_of(name, args):
    ops, nbytes = work_of(name, args)
    bf16 = str(getattr(args[0], "dtype", "")) == "torch.bfloat16"
    t_ops, t_bytes = ops / (PEAK_BF16_OPS if bf16 else PEAK_FP32_OPS), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_build(native):
    t0 = time.perf_counter()
    logs = native.build_all()
    secs = time.perf_counter() - t0
    libs = sorted(p.name for p in native.build_dir().glob("lib*.so"))
    return {"seconds": secs, "built": sorted(logs), "libs": libs,
            "build_dir": str(native.build_dir().relative_to(ROOT))}, logs


def phase_kernels(ops, device, rng):
    """Every case of every kernel against its plain version; all cases run,
    and the phase fails at the end if any disagreed. ``errs`` holds each
    kernel's largest fp32 error, ``errs[name + "/bf16"]`` its bf16 one."""
    import torch

    results, errs, failed = [], {}, []
    for name, cases in kernel_cases(rng, ops).items():
        spec = ops.KERNEL_REGISTRY[name]
        for label, args in cases:
            targs = to_device(args, device)
            got = spec.kernel(*targs)
            torch.cuda.synchronize()
            want = spec.plain(*targs)
            torch.cuda.synchronize()
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                raise AssertionError(f"{name} [{label}]: {tuple(got.shape)} {got.dtype} "
                                     f"!= plain {tuple(want.shape)} {want.dtype}")
            err, ok, tol = agreement(spec, got, want)
            results.append({"kernel": name, "case": label, "shape": list(got.shape),
                            "max_abs_err": err, "tol": tol, "ok": ok})
            key = name + "/bf16" if got.dtype == torch.bfloat16 else name
            errs[key] = max(errs.get(key, 0.0), err)
            if not ok:
                failed.append(f"{name} [{label}]: max |kernel - plain| = {err} (tol {tol})")
            del got, want, targs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return {"cases": results}, errs


def round_signature(res):
    """What must be exactly equal between two runs of one round."""
    ids = [(e.tag, e.device_id) for e in res.ledger.events]
    best_k = {s: max(v, key=v.get) for s, v in res.ensemble_auc.items() if v}
    return res.ledger.as_dict(), ids, best_k


def auc_values(res):
    import numpy as np

    vals = [res.local_mean_auc, res.ideal_mean_auc, res.full_ensemble_auc]
    for s in sorted(res.ensemble_auc):
        vals += [res.ensemble_auc[s][k] for k in sorted(res.ensemble_auc[s])]
    for key in sorted(res.per_device):
        vals += list(res.per_device[key])
    return np.asarray(vals, np.float64)


def phase_parity(make_dataset, run_protocol, DistillConfig):
    import numpy as np

    ds = make_dataset("gleam", seed=0, scale=1.0)
    q8 = {"codec": "int8", "distill": DistillConfig(proxy_size=4096, solver="cg")}
    runs, seconds = {}, {}
    for label, kw in (("cuda", {"device": "cuda"}),
                      ("cpu", {"device": "cpu"}),
                      ("loop_cuda", {"device": "cuda", "engine": "loop"}),
                      ("int8_cg_cuda", {"device": "cuda", **q8}),
                      ("int8_cg_cpu", {"device": "cpu", **q8})):
        t0 = time.perf_counter()
        runs[label] = run_protocol(ds, ks=PARITY_KS, random_trials=3, **kw)
        seconds[label] = time.perf_counter() - t0
    q8_res = runs["int8_cg_cuda"]
    out = {"devices": ds.n_devices, "best": runs["cuda"].best, "seconds": seconds,
           "int8_cg": {"best": q8_res.best, "distilled": q8_res.ensemble_auc["distilled"],
                       "student_supports": len(q8_res.student.coef),
                       "download_distilled": q8_res.ledger.total(tag="download_distilled")}}
    for base, other in (("cuda", "cpu"), ("cuda", "loop_cuda"),
                        ("int8_cg_cuda", "int8_cg_cpu")):
        res = runs[other]
        same = round_signature(res) == round_signature(runs[base])
        diff = float(np.abs(auc_values(res) - auc_values(runs[base])).max())
        out[f"{base}_vs_{other}"] = {"ledger_ids_best_k_equal": same, "max_auc_diff": diff}
        if not same:
            raise AssertionError(f"parity: {other} run's ledger, ids or best k differ "
                                 f"from the {base} run")
        if not diff <= AUC_TOL:
            raise AssertionError(f"parity: {other} AUCs differ by {diff} > {AUC_TOL}")
    if "download_distilled" not in q8_res.ledger.as_dict():
        raise AssertionError("parity: the int8 round recorded no student download")
    return out


def phase_main(make_dataset, run_protocol, ops, trace, must_launch, **kw):
    """One full-scale emnist round on cuda with ``kw`` (codec, distill),
    then the same round under the profiler. ``must_launch`` names the
    kernels that must have launched at least once in the measured round."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    ds = make_dataset("emnist", seed=0, scale=1.0)
    gen_s = time.perf_counter() - t0
    tracer = trace.Tracer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        res = run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    spans = tracer.span_seconds()
    aucs = auc_values(res)
    out = {
        "dataset": "emnist", "scale": 1.0, "devices": ds.n_devices,
        "samples": int(sum(d.n for d in ds.devices)), "generate_seconds": gen_s,
        "codec": res.codec, "round_seconds": wall,
        "spans": {k: v for k, v in sorted(spans.items())},
        "local_mean_auc": res.local_mean_auc, "ideal_mean_auc": res.ideal_mean_auc,
        "full_ensemble_auc": res.full_ensemble_auc, "best": res.best,
        "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                         for s, d in res.ensemble_auc.items()},
        "comm_total_up": res.ledger.total(direction="up"),
        "comm_total_down": res.ledger.total(direction="down"),
        "kernels": counts,
    }
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError("main: AUCs not finite or outside [0, 1]")
    for key, per in res.per_device.items():
        if len(per) != ds.n_devices:
            raise AssertionError(f"main: per_device[{key}] has {len(per)} entries, "
                                 f"want {ds.n_devices}")
    missing = [k for k in must_launch if counts[k] <= 0]
    if missing:
        raise AssertionError(f"main: kernels never launched on the main path: {missing}")
    if res.student is not None:
        cg = [ev["args"]["iterations"] for ev in tracer.events if ev["name"] == "distill.cg"]
        out["student"] = {"codec": res.student_codec, "supports": len(res.student.coef),
                          "type": type(res.student).__name__, "cg_iterations": cg,
                          "download_bytes": res.ledger.total(tag="download_distilled"),
                          "ensemble_download_bytes": res.ledger.total(tag="download_ensemble")}
        if "distilled" not in res.per_device:
            raise AssertionError("main: the distilled student was not evaluated")
        if cg and sum(cg) != counts["gram_matvec"]:
            raise AssertionError(f"main: gram_matvec launched {counts['gram_matvec']} "
                                 f"times for {sum(cg)} CG iterations")
    out["profile"], _ = profile_call(lambda: run_protocol(ds, ks=MAIN_KS, random_trials=3,
                                                          device="cuda", **kw))
    return out


def profile_call(fn, top=12):
    """``fn()`` under ``torch.profiler``: the device's busy seconds (the
    sum of every kernel and copy on the card; one stream, so they do not
    overlap) against the call's wall seconds, and the device time by
    kernel. The profiler slows the host, so this wall is longer than an
    unprofiled one's; the busy share is that of the profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    ranked = sorted(on_card, key=lambda e: -e.self_device_time_total)[:top]
    out = {
        "wall_seconds": wall, "device_seconds": busy,
        "device_busy_share": busy / wall if busy > 0 else None,
        "by_kernel": [{"name": e.key[:100], "count": e.count,
                       "seconds": e.self_device_time_total / 1e6} for e in ranked],
    }
    return out, result


def phase_lm_parity(ops, device):
    """llama3.2-1b at full width, 2 layers, fp32, through the flash kernel
    on cuda and through its plain version on cpu: the same seeded
    parameters (drawn on the cpu, then moved), 2 prompts of 200 tokens,
    8 greedy tokens; tokens equal and last-position logits within
    LM_LOGIT_TOL."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_data
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import forward_prefill, init_cache, init_params

    cfg = get_config(SERVE_ARCH).replace(n_layers=2, dtype=torch.float32, use_pallas=True)
    prompts = np.stack([c[:200] for c in make_federated_lm_data(2, cfg.vocab, 208, seed=0)])
    params = init_params(cfg, seed=0, device="cpu")
    runs = {}
    for dev in (torch.device("cpu"), device):
        params = params.to(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens, _ = serve_prompts(cfg, params, prompts.astype(np.int32), gen=8)
        logits, _ = forward_prefill(params, cfg, {"tokens": prompts},
                                    init_cache(cfg, 2, 200, device=dev))
        runs[dev.type] = {
            "tokens": tokens, "logits": logits.cpu(), "seconds": time.perf_counter() - t0,
            "flash_launches": ops.launch_counts()["flash_attention"]}
    cpu, card = runs["cpu"], runs["cuda"]
    diff = float((card["logits"] - cpu["logits"]).abs().max())
    out = {"arch": SERVE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "prompts": list(prompts.shape), "gen": 8,
           "tokens_equal": bool(np.array_equal(card["tokens"], cpu["tokens"])),
           "max_logit_diff": diff, "tol": LM_LOGIT_TOL,
           "seconds": {k: r["seconds"] for k, r in runs.items()},
           "flash_launches": {k: r["flash_launches"] for k, r in runs.items()},
           "tokens": card["tokens"].tolist()}
    if not out["tokens_equal"]:
        raise AssertionError(f"lm_parity: cuda tokens {card['tokens'].tolist()} != cpu "
                             f"tokens {cpu['tokens'].tolist()}")
    if not (torch.isfinite(card["logits"]).all() and diff <= LM_LOGIT_TOL):
        raise AssertionError(f"lm_parity: logits differ by {diff} > {LM_LOGIT_TOL}")
    # one prefill in serve_prompts and one more here, each a launch per layer
    if cpu["flash_launches"] != 0 or card["flash_launches"] != 2 * cfg.n_layers:
        raise AssertionError(f"lm_parity: flash launches {out['flash_launches']}, want "
                             f"0 on cpu and {2 * cfg.n_layers} on cuda")
    return out


def phase_serve(ops, device):
    """The full 16-layer bf16 llama3.2-1b serving 4 requests of 2,048
    prompt tokens, 32 greedy tokens each, through ``serve_prompts`` (the
    body of ``launch/serve.py``'s ``main``) with the flash kernel; then
    the same serve once more under the profiler."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_data
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import cache_spec, forward_prefill, init_cache, init_params
    from repro_torch.models import param_count

    cfg = get_config(SERVE_ARCH).replace(use_pallas=True)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    if n_params != param_count(cfg):
        raise AssertionError(f"serve: {n_params} parameters, config says {param_count(cfg)}")
    clients = make_federated_lm_data(SERVE_BATCH, cfg.vocab, SERVE_PROMPT + 8, seed=0)
    prompts = np.stack([c[:SERVE_PROMPT] for c in clients]).astype(np.int32)
    kv_len = SERVE_PROMPT + SERVE_GEN + 1
    spec = cache_spec(cfg, SERVE_BATCH, kv_len)
    cache_bytes = sum(int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
                      for sub in spec["blocks"] for shape, dtype in sub["attn"].values())

    # the first serve is the measured main path (launch counts, peak
    # memory); it also pays the first calls' set-up (cuBLAS handles and
    # heuristics), so a second, warm serve gives the steady-state seconds
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, sched = serve_prompts(cfg, params, prompts, SERVE_GEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    warm_tokens, warm_sched = serve_prompts(cfg, params, prompts, SERVE_GEN)

    # the first generated token is the prefill's argmax, and the logits are finite
    logits, _ = forward_prefill(params, cfg, {"tokens": prompts},
                                init_cache(cfg, SERVE_BATCH, kv_len, device=device))
    first = torch.argmax(logits, dim=-1).cpu().numpy()
    profile, (again, _) = profile_call(lambda: serve_prompts(cfg, params, prompts, SERVE_GEN))
    cold, warm = sched.score_fn.timings[0], warm_sched.score_fn.timings[0]

    def rates(timing):
        pre_s, dec_s = timing["prefill_seconds"], timing["decode_seconds"]
        return {"prefill_seconds": pre_s,
                "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / pre_s,
                "decode_seconds": dec_s,
                "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / dec_s,
                "decode_ms_per_step": 1e3 * dec_s / SERVE_GEN}

    out = {
        "arch": SERVE_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], "vocab": cfg.vocab,
        "dtype": "bfloat16", "params": n_params, "init_seconds": init_s,
        "requests": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
        "kv_cache_bytes": cache_bytes, "peak_memory_bytes": peak,
        "warm": rates(warm), "cold": rates(cold), "cold_serve_wall_seconds": wall,
        "scheduler": vars(sched.stats), "kernels": counts,
        "tokens_head": tokens[:, :8].tolist(), "profile": profile,
    }
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"serve: tokens {tokens.shape} outside the vocabulary")
    if not bool(torch.isfinite(logits.float()).all()) or not np.array_equal(first, tokens[:, 0]):
        raise AssertionError("serve: prefill logits not finite or their argmax is not "
                             "the first generated token")
    if sched.stats.batches != 1 or sched.stats.scored_rows != SERVE_BATCH:
        raise AssertionError(f"serve: scheduler stats {vars(sched.stats)}")
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"serve: flash_attention launched {counts['flash_attention']} "
                             f"times, want one per layer ({cfg.n_layers})")
    if not (np.array_equal(again, tokens) and np.array_equal(warm_tokens, tokens)):
        raise AssertionError("serve: a repeat of the serve generated other tokens")
    return out


def _time_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, args, budget_ms=40.0, library=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    each turn a run of back-to-back calls (L2 warm) sized to ~budget_ms;
    with ``library``, its two turns go between the kernel's (plain,
    kernel, library, library, kernel, plain)."""
    fns = {"plain": plain, "kernel": kernel}
    order = ["plain", "kernel", "kernel", "plain"]
    if library is not None:
        fns["library"] = library
        order[2:2] = ["library", "library"]
    reps = {}
    for label, fn in fns.items():
        once = _time_ms(lambda: fn(*args), 1)   # warm-up, then size the run
        reps[label] = max(1, min(200, int(budget_ms / max(once, 1e-3))))
    turns = {label: [] for label in fns}
    for label in order:
        turns[label].append(_time_ms(lambda: fns[label](*args), reps[label]))
    return turns, reps


def sdpa_library(q, k, v, causal, window):
    """The yardstick for flash attention: one PyTorch call on the same
    tensors, in its (B, heads, S, hd) layout (transposed views)."""
    import torch.nn.functional as F

    if window:
        raise ValueError("the library yardstick is timed without a window")
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


TIMING_CASES = {
    # first case of each kernel is the one the summary line reports
    "batched_rbf_gram": ("fit g256 b64", "fit g128 b256", "score g128 q184 b256"),
    "rbf_gram": ("ideal 2000x2000x32",),
    "ensemble_score": ("full b8192 k2821 n230", "k100 b8192 n230",
                       "ideal predict b8192 k1 n2000"),
    "sdca": ("ideal g1 b2048 n2000", "group g256 b64", "group g128 b256"),
    "gram_matvec": ("cg l4096 d32",),
    "rbf_gram_q8": ("student predict b8192 n4096 d32",),
    "ensemble_score_q8": ("full b8192 k2821 n230", "k100 b8192 n230"),
    "flash_attention": ("serve b4 s2048 h32 k8 hd64 causal bfloat16",
                        "serve b4 s2048 h32 k8 hd64 causal float32"),
}
LIBRARY = {"flash_attention": sdpa_library}


def phase_timing(ops, device, rng):
    import torch

    cases = {name: dict(c) for name, c in kernel_cases(rng, ops).items()}
    rows = []
    for name, labels in TIMING_CASES.items():
        spec = ops.KERNEL_REGISTRY[name]
        for label in labels:
            args = cases[name][label]
            targs = to_device(args, device)
            library = LIBRARY.get(name)
            turns, reps = time_pair(spec.kernel, spec.plain, targs, library=library)
            bound_ms, bound_by = bound_of(name, args)
            ops_n, bytes_n = work_of(name, args)
            row = {
                "kernel": name, "case": label,
                "ms": sum(turns["kernel"]) / 2, "plain_ms": sum(turns["plain"]) / 2,
                "library_ms": sum(turns["library"]) / 2 if library else None,
                "turns": turns, "reps": reps, "bound_ms": bound_ms,
                "bound_by": bound_by, "ops": ops_n, "bytes": bytes_n,
            }
            if library:   # how far the yardstick's own answer is from the plain version's
                row["library_max_abs_err"] = float(
                    (library(*targs).float() - spec.plain(*targs).float()).abs().max())
            rows.append(row)
            del targs
            torch.cuda.empty_cache()
    return {"rows": rows}


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out", help="JSON file for the compiler log and detailed timings")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {ROOT / 'src'}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.core.protocol import run_protocol
    from repro_torch.data import make_dataset
    from repro_torch.distill import DistillConfig
    from repro_torch.kernels import native, ops
    from repro_torch.obs import trace
    from repro_torch.utils.device import resolve_device

    card = nvidia_smi()
    device = resolve_device("cuda")   # also turns TF32 off
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    detail = {"nvidia_smi": card}
    errs, counts, timing = {}, {}, {}   # counts: phase -> kernel -> launches
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        try:
            if phase == "build":
                out, logs = phase_build(native)
                detail["nvcc"] = logs
            elif phase == "kernels":
                out, errs = phase_kernels(ops, device, np.random.default_rng(0))
            elif phase == "parity":
                out = phase_parity(make_dataset, run_protocol, DistillConfig)
            elif phase == "main":
                out = phase_main(make_dataset, run_protocol, ops, trace, FP32_KERNELS)
                counts[phase] = out["kernels"]
            elif phase == "main_q8":
                out = phase_main(make_dataset, run_protocol, ops, trace,
                                 FP32_KERNELS + Q8_KERNELS, codec="int8",
                                 distill=DistillConfig(proxy_size=4096, solver="cg"))
                counts[phase] = out["kernels"]
            elif phase == "lm_parity":
                out = phase_lm_parity(ops, device)
            elif phase == "serve":
                out = phase_serve(ops, device)
                counts[phase] = out["kernels"]
            else:
                out = phase_timing(ops, device, np.random.default_rng(0))
                timing = {r["kernel"]: r for r in reversed(out["rows"])}
        except Exception as e:
            emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
            raise
        out = {"phase": phase, "ok": True, "phase_seconds": time.perf_counter() - t0, **out}
        detail[phase] = out
        if phase == "timing":   # the turns and counts go to --out only
            out = {**out, "rows": [{k: r[k] for k in ("kernel", "case", "ms", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_by")}
                                   for r in out["rows"]]}
        emit(out)

    # each kernel's launches come from the run it was ported for: the fp32
    # round's four from ``main``, the int8 + distillation round's three from
    # ``main_q8``, flash attention from ``serve`` (every phase line carries
    # every kernel's count)
    summary = []
    for name, spec in ops.KERNEL_REGISTRY.items():
        row = timing.get(name, {})
        path = LAUNCHES_PATH[name]
        entry = {
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": counts.get(path, {}).get(name),
            "launches_path": path,
            "max_abs_err": errs.get(name), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
        }
        if name + "/bf16" in errs:
            entry["max_abs_err_bf16"] = errs[name + "/bf16"]
        summary.append(entry)
    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(detail, indent=1, default=str) + "\n")
    emit({"kernels": summary})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
