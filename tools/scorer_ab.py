"""Hold this tree's ensemble scorers to another build of them on one card:
a parent commit's sources, or a variant of this tree's.

    python3 tools/scorer_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]
        [--sass DIR] [--rounds N]

Each DIR holds ``ensemble_score.cu`` and ``supports.cuh`` with this tree's
C launchers; a parent's come from ``git show
<commit>:src/repro_torch/kernels/csrc/<file> > DIR/<file>``. Every DIR is
built with this tree's nvcc flags, all builds at once, and then, for each
build against this tree's library:

- bits: fp32 and int8, at b 8,192, k 282, n 230 and d 64, 220 and 784
  through the public launchers and the chunked ones, and at the d-32 full
  shape (b 8,192, k 2,821, n 230) through the public ones: this tree's
  scores bitwise the build's or not (any case apart fails the run);
- time: at ``TIMED`` (the two wide rows of ``chip_smoke.py``'s timing
  phase and the d-32 full shape, fp32 and int8), the build and this tree
  in ``--rounds`` rounds of turns (build, this, this, build), each turn a
  run of back-to-back calls over ~200 ms timed with CUDA events: ms a
  call of each turn, their means and the spread (max - min) / mean of
  each side;
- resources: registers, stack and spill bytes of every kernel (``ptxas
  -v``) of each build's library and of this tree's, the chunked kernels'
  shared memory and blocks an SM; with ``--sass DIR``, each library's
  SASS in DIR (gzip) and its opcode counts by kernel in the JSON;
- the SM clock and board power, sampled every 100 ms by ``nvidia-smi``
  through the timed turns.

The inputs are ``chip_smoke.py``'s ``wide_inputs``, drawn on the card.
Prints a JSON line with the card's name and power limit, the resources
and the bits, then one a timed case (``--out`` keeps everything). Needs a
CUDA card, nvcc and cuobjdump; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from flash_ab import nvidia_smi, resources, sass, time_ms  # noqa: E402

LIB = "ensemble_score"
# (fp32 launcher, int8 launcher), public and chunked
LAUNCHERS = {"public": ("ensemble_score_launch", "ensemble_score_q8_launch"),
             "chunked": ("ensemble_score_chunked_launch", "ensemble_score_q8_chunked_launch")}
# (label, k, d, launchers)
BITS = (("b8192 k282 n230 d64", 282, 64, ("public", "chunked")),
        ("b8192 k282 n230 d220", 282, 220, ("public", "chunked")),
        ("b8192 k282 n230 d784", 282, 784, ("public", "chunked")),
        ("full b8192 k2821 n230 d32", 2821, 32, ("public",)))
TIMED = (("wide b8192 k282 n230 d784", 282, 784),
         ("full b8192 k2821 n230 d32", 2821, 32))
TURN_MS = 200.0
SMEM_PER_SM = 233_472   # shared memory an SM holds; a block also takes 1 KB of the runtime's
REGS_PER_SM = 65_536


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(native, src_dir: Path, out_dir: Path):
    """One nvcc of ``src_dir``'s scorer source: (library path, process)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{LIB}.so"
    return so, subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
         str(src_dir / f"{LIB}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(lib: ctypes.CDLL, native) -> dict:
    fns = {}
    for names in LAUNCHERS.values():
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = native.SIGNATURES[LIB][name]
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def blocks_per_sm(res: dict, smem: int, threads: int = 256) -> int:
    """Blocks of ``threads`` an SM holds by registers (allocated in 8s a
    thread) and shared memory."""
    regs = -(-res["registers"] // 8) * 8
    return min(REGS_PER_SM // (regs * threads), SMEM_PER_SM // (smem + 1024))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--sass", metavar="DIR", help="dump each library's SASS here")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.kernels import ensemble_score as ens
    from repro_torch.kernels import native

    if not torch.cuda.is_available():
        print("scorer_ab: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smoke = chip_smoke()
    builds = dict(b.split("=", 1) for b in args.builds)
    scratch = ROOT / ".checkout" / "scorer_ab_build"
    if "this" in builds:
        ap.error("'this' names this tree's build")
    # this tree's sources too, so that ptxas reports on every build alike
    procs = {name: build(native, Path(d), scratch / name)
             for name, d in {"this": native.CSRC, **builds}.items()}
    fns, res, libs, errors = {}, {}, {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:   # reported, and the run fails at its end
            errors[name] = log[-4000:]
            continue
        res[name] = resources(log)
        libs[name] = ctypes.CDLL(str(so))
        fns[name] = bind(libs[name], native)
    if "this" not in libs:
        print(f"scorer_ab: this tree's scorer did not build:\n{errors['this']}", file=sys.stderr)
        return 1
    smem = {"fp32": libs["this"].ensemble_score_chunked_smem_bytes(),
            "int8": libs["this"].ensemble_score_q8_chunked_smem_bytes()}
    chunked = {k: dict(v, blocks_per_sm=blocks_per_sm(
                   v, smem["int8" if "Int8" in k else "fp32"]))
               for k, v in res["this"].items() if "partials_chunked_kernel" in k}
    out = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "builds": builds, "build_errors": errors, "resources": res,
           "chunked_smem_bytes": smem, "chunked_this": chunked}
    if args.sass:
        dump = Path(args.sass)
        dump.mkdir(parents=True, exist_ok=True)
        out["sass"] = {name: sass(native, so, dump / f"{name}_{LIB}.sass.gz")
                       for name, (so, _) in procs.items() if name in fns}
    stream = native.stream_handle(device)

    def call(fn, args):
        """fn on ``wide_inputs``' tensors: the wrapper's scratch, sized for
        either tree (this one adds b query norms)."""
        x, *sup, coef, gam = args
        b, d = x.shape
        k, n_max = coef.shape
        plan = ens.split_plan(k, n_max)
        norms = torch.empty(k * n_max + b, device=device)
        partial = torch.empty(plan.splits * b, device=device)
        out_ = torch.empty(b, device=device)
        ptrs = [t.data_ptr() for t in (x, *sup, coef, gam, norms, partial, out_)]

        def run():
            rc = fn(*ptrs, b, k, n_max, d, plan.per_split, plan.splits, stream)
            if rc:
                raise RuntimeError(f"scorer_ab: launch failed with CUDA error {rc}")
            return out_
        return run

    inputs = {}

    def case(kind, k, d):
        key = (kind, k, d)
        if key not in inputs:
            inputs.clear()
            torch.cuda.empty_cache()
            inputs[key] = smoke.wide_inputs(kind, d, device, k=k)
        return inputs[key]

    failed = []
    out["bits"] = []
    for label, k, d, kinds in BITS:
        for int8, kind in enumerate(("ensemble_score", "ensemble_score_q8")):
            args_ = case(kind, k, d)
            for launcher in kinds:
                fn_name = LAUNCHERS[launcher][int8]
                want = call(fns["this"][fn_name], args_)().clone()
                for name in fns:
                    if name == "this":
                        continue
                    got = call(fns[name][fn_name], args_)()
                    torch.cuda.synchronize()
                    row = {"case": label, "kernel": kind, "launcher": launcher, "against": name,
                           "bitwise": bool(torch.equal(got, want)),
                           "max_abs_diff": float((got - want).abs().max())}
                    out["bits"].append(row)
                    if not row["bitwise"]:
                        failed.append(f"{name} {kind} {launcher} {label}")

    # the SM clock and the board's power every 100 ms through the timed turns
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out["timing"] = []
    for label, k, d in TIMED:
        for int8, kind in enumerate(("ensemble_score", "ensemble_score_q8")):
            args_ = case(kind, k, d)
            fn_name = LAUNCHERS["public"][int8]
            for name in fns:
                if name == "this":
                    continue
                calls = {name: call(fns[name][fn_name], args_),
                         "this": call(fns["this"][fn_name], args_)}
                reps = {}
                for side, fn in calls.items():
                    time_ms(fn, 2)
                    reps[side] = max(1, int(TURN_MS / max(time_ms(fn, 1), 1e-3)))
                turns = {name: [], "this": []}
                for _ in range(args.rounds):
                    for side in (name, "this", "this", name):
                        turns[side].append(time_ms(calls[side], reps[side]))
                mean = {s: sum(t) / len(t) for s, t in turns.items()}
                out["timing"].append({
                    "case": f"{label} {kind}", "against": name, "ms": mean,
                    "this_over_other": mean["this"] / mean[name],
                    "spread": {s: (max(t) - min(t)) / mean[s] for s, t in turns.items()},
                    "turns": turns, "reps": reps})
    smi.terminate()
    samples = [tuple(map(float, line.split(","))) for line in smi.communicate()[0].splitlines()
               if line.count(",") == 1]
    if samples:
        clocks, watts = sorted(c for c, _ in samples), sorted(w for _, w in samples)
        out["clocks"] = {"samples": len(samples), "sm_mhz_median": clocks[len(clocks) // 2],
                         "sm_mhz_min": clocks[0], "sm_mhz_max": clocks[-1],
                         "power_w_median": watts[len(watts) // 2], "power_w_max": watts[-1]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("nvidia_smi", "build_errors", "chunked_smem_bytes",
                                          "chunked_this", "resources")}))
    print(json.dumps({"clocks": out.get("clocks")}))
    print(json.dumps({"bits_cases": len(out["bits"]),
                      "all_bitwise": all(r["bitwise"] for r in out["bits"]),
                      "differ": [r for r in out["bits"] if not r["bitwise"]]}))
    for row in out["timing"]:
        print(json.dumps({k: row[k] for k in ("case", "against", "ms", "this_over_other",
                                              "spread")}))
    if failed or errors:
        print(f"scorer_ab: not bitwise this tree's: {failed}; not built: {sorted(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
