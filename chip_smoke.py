#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports the port and nothing of JAX or of the reference package
``repro``, and runs five phases, each printing one JSON line on stdout:

  build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
           for sm_90a, one ``nvcc`` per source, all started together;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes and one ragged shape, at the registry's
           tolerance;
  parity   ``run_protocol`` on the full gleam federation three ways
           (bucketed on cuda, bucketed on cpu through the plain versions,
           the loop tier on cuda): equal ledgers, selected ids and best k,
           AUCs within 1e-4;
  main     ``run_protocol`` on the full-scale emnist federation on cuda
           (``benchmarks/fig1_mean_auc.py``'s setting): the seconds of each
           ``round.*`` span, the AUCs, and each kernel's launches in that
           run, all of which must be > 0; then the same round once more
           under ``torch.profiler`` for the device's busy share;
  timing   each kernel and its plain version, in turns (plain, kernel,
           kernel, plain) with CUDA events, at main-path shapes, beside the
           analytic bound: the larger of fp32 operations over 67 TFLOP/s
           and bytes (each input read once, each output written once) over
           3.35 TB/s, the H100 SXM's published peaks.

The last three lines are the per-kernel summary ``{"kernels": [...]}``,
the card's name and power limit as ``nvidia-smi`` gives them, and
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
PHASES = ("build", "kernels", "parity", "main", "timing")
AUC_TOL = 1e-4                    # the reference's engine-tier tolerance
PEAK_FP32_OPS = 67e12             # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
MAIN_KS = (1, 10, 50, 100)        # fig1_mean_auc.py's ks at emnist scale
PARITY_KS = (1, 10, 38)


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
    up to 230 supports; the 2,000-row pooled ideal, SDCA bucket 2048)."""
    import numpy as np

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

    def sdca(g, b, lo, hi):
        n_real = rng.integers(lo, hi + 1, size=g)
        return ops.make_sdca_problem(rng, g=g, b=b, d=32, n_real=n_real)

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
    }
    for name, spec in ops.KERNEL_REGISTRY.items():
        cases[name].append(("ragged", spec.make_ragged(rng)))
    return cases


def to_device(args, device):
    import numpy as np
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else a for a in args)


# ----------------------------------------------------------------------
# analytic bounds: (fp32 operations, bytes) of one call
# ----------------------------------------------------------------------

def work_of(name, args):
    """Operations and bytes the function needs for these inputs (each
    input read once, each output written once; SDCA counts the steps its
    n_real coordinates take)."""
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
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
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
    import numpy as np
    import torch

    results, errs = [], {}
    for name, cases in kernel_cases(rng, ops).items():
        spec = ops.KERNEL_REGISTRY[name]
        for label, args in cases:
            targs = to_device(args, device)
            got = spec.kernel(*targs)
            torch.cuda.synchronize()
            want = spec.plain(*targs)
            torch.cuda.synchronize()
            if tuple(got.shape) != tuple(want.shape):
                raise AssertionError(f"{name} [{label}]: shape {tuple(got.shape)} "
                                     f"!= plain {tuple(want.shape)}")
            finite = bool(torch.isfinite(got).all())
            err = float((got - want).abs().max()) if got.numel() else 0.0
            ok = finite and err <= spec.tol
            results.append({"kernel": name, "case": label, "shape": list(got.shape),
                            "max_abs_err": err, "tol": spec.tol, "ok": ok})
            errs[name] = max(errs.get(name, 0.0), err)
            if not ok:
                raise AssertionError(f"{name} [{label}]: max |kernel - plain| = "
                                     f"{err} (tol {spec.tol}), finite={finite}")
            del got, want, targs
    torch.cuda.empty_cache()
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


def phase_parity(make_dataset, run_protocol):
    import numpy as np

    ds = make_dataset("gleam", seed=0, scale=1.0)
    runs = {}
    for label, kw in (("cuda", {"device": "cuda"}),
                      ("cpu", {"device": "cpu"}),
                      ("loop_cuda", {"device": "cuda", "engine": "loop"})):
        t0 = time.perf_counter()
        runs[label] = run_protocol(ds, ks=PARITY_KS, random_trials=3, **kw)
        runs[label + "_seconds"] = time.perf_counter() - t0
    base = runs["cuda"]
    out = {"devices": ds.n_devices, "best": base.best,
           "seconds": {k[:-8]: v for k, v in runs.items() if k.endswith("_seconds")}}
    for other in ("cpu", "loop_cuda"):
        res = runs[other]
        same = round_signature(res) == round_signature(base)
        diff = float(np.abs(auc_values(res) - auc_values(base)).max())
        out[f"vs_{other}"] = {"ledger_ids_best_k_equal": same, "max_auc_diff": diff}
        if not same:
            raise AssertionError(f"parity: {other} run's ledger, ids or best k differ "
                                 "from the cuda run")
        if not diff <= AUC_TOL:
            raise AssertionError(f"parity: {other} AUCs differ by {diff} > {AUC_TOL}")
    return out


def phase_main(make_dataset, run_protocol, ops, trace):
    import numpy as np
    import torch

    t0 = time.perf_counter()
    ds = make_dataset("emnist", seed=0, scale=1.0)
    gen_s = time.perf_counter() - t0
    tracer = trace.Tracer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        res = run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    spans = tracer.span_seconds()
    aucs = auc_values(res)
    out = {
        "dataset": "emnist", "scale": 1.0, "devices": ds.n_devices,
        "samples": int(sum(d.n for d in ds.devices)), "generate_seconds": gen_s,
        "round_seconds": wall,
        "spans": {k: v for k, v in sorted(spans.items())},
        "local_mean_auc": res.local_mean_auc, "ideal_mean_auc": res.ideal_mean_auc,
        "full_ensemble_auc": res.full_ensemble_auc, "best": res.best,
        "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                         for s, d in res.ensemble_auc.items()},
        "comm_total_up": res.ledger.total(direction="up"),
        "kernels": counts,
    }
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError("main: AUCs not finite or outside [0, 1]")
    for key, per in res.per_device.items():
        if len(per) != ds.n_devices:
            raise AssertionError(f"main: per_device[{key}] has {len(per)} entries, "
                                 f"want {ds.n_devices}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main: kernels never launched on the main path: {missing}")
    out["profile"] = profile_round(run_protocol, ds)
    return out


def profile_round(run_protocol, ds):
    """The same round once more, under ``torch.profiler``: the device's
    busy seconds (the sum of every kernel and copy on the card; one stream,
    so they do not overlap) against the round's wall seconds, and the
    device time by kernel. The profiler slows the host, so this round's
    wall is longer than the measured one's; the busy share is that of the
    profiled round."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "wall_seconds": wall, "device_seconds": busy,
        "device_busy_share": busy / wall if busy > 0 else None,
        "by_kernel": [{"name": e.key[:100], "count": e.count,
                       "seconds": e.self_device_time_total / 1e6} for e in top],
    }


def _time_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, args, budget_ms=40.0):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    each turn a run of back-to-back calls (L2 warm) sized to ~budget_ms."""
    reps = {}
    for label, fn in (("plain", plain), ("kernel", kernel)):
        once = _time_ms(lambda: fn(*args), 1)   # warm-up, then size the run
        reps[label] = max(1, min(200, int(budget_ms / max(once, 1e-3))))
    turns = {"plain": [], "kernel": []}
    for label, fn in (("plain", plain), ("kernel", kernel),
                      ("kernel", kernel), ("plain", plain)):
        turns[label].append(_time_ms(lambda: fn(*args), reps[label]))
    return turns, reps


TIMING_CASES = {
    # first case of each kernel is the one the summary line reports
    "batched_rbf_gram": ("fit g256 b64", "fit g128 b256", "score g128 q184 b256"),
    "rbf_gram": ("ideal 2000x2000x32",),
    "ensemble_score": ("full b8192 k2821 n230", "k100 b8192 n230",
                       "ideal predict b8192 k1 n2000"),
    "sdca": ("ideal g1 b2048 n2000", "group g256 b64", "group g128 b256"),
}


def phase_timing(ops, device, rng):
    import torch

    cases = {name: dict(c) for name, c in kernel_cases(rng, ops).items()}
    rows = []
    for name, labels in TIMING_CASES.items():
        spec = ops.KERNEL_REGISTRY[name]
        for label in labels:
            args = cases[name][label]
            targs = to_device(args, device)
            turns, reps = time_pair(spec.kernel, spec.plain, targs)
            bound_ms, bound_by = bound_of(name, args)
            ops_n, bytes_n = work_of(name, args)
            rows.append({
                "kernel": name, "case": label,
                "ms": sum(turns["kernel"]) / 2, "plain_ms": sum(turns["plain"]) / 2,
                "turns": turns, "reps": reps, "bound_ms": bound_ms,
                "bound_by": bound_by, "ops": ops_n, "bytes": bytes_n,
            })
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
    from repro_torch.kernels import native, ops
    from repro_torch.obs import trace
    from repro_torch.utils.device import resolve_device

    card = nvidia_smi()
    device = resolve_device("cuda")   # also turns TF32 off
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    detail = {"nvidia_smi": card}
    errs, counts, timing = {}, {}, {}
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
                out = phase_parity(make_dataset, run_protocol)
            elif phase == "main":
                out = phase_main(make_dataset, run_protocol, ops, trace)
                counts = out["kernels"]
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
                                                      "bound_ms", "bound_by")}
                                   for r in out["rows"]]}
        emit(out)

    summary = []
    for name, spec in ops.KERNEL_REGISTRY.items():
        row = timing.get(name, {})
        summary.append({
            "name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": counts.get(name),
            "max_abs_err": errs.get(name), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": None,
        })
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
