"""Hold this tree's ``gram_matvec`` kernels to another build of them on one
card: a parent commit's source, or a variant of this tree's.

    python3 tools/gram_matvec_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]
        [--sass DIR] [--rounds N]

Each DIR holds a ``gram_matvec.cu``; a parent's comes from ``git show
<commit>:src/repro_torch/kernels/csrc/gram_matvec.cu > DIR/gram_matvec.cu``.
A build whose library exports ``gram_matvec_scratch_rows`` takes this
tree's C launchers (the chunked route's planes and norms as scratch);
one without it the launchers from before that route (no scratch; its
chunked kernel then takes the staged kernel's split plan). Every DIR is
built with this tree's nvcc flags, all builds at once, and then, for each
build against this tree's library:

- bits: the staged kernel through the public launcher at the CG's l
  4,096 on ``chip_smoke.py``'s cases ("cg l4096 d32", "cg emnist l4096
  d32", "cg l4096 d16") and at d 64: this tree's output bitwise the
  build's or not (any case apart fails the run);
- errors: past d 64, where the two chunked kernels give other bits, each
  side's largest error against the plain version at the CG's l 4,096 and
  d 129, 220, 784 and 1,024;
- time: at ``TIMED`` (the ``timing`` phase's wide row, l 4,096 d 784, and
  its d-32 row), the build and this tree in ``--rounds`` rounds of turns
  (build, this, this, build), each turn a run of back-to-back calls over
  ~100 ms timed with CUDA events: ms a call of each turn, their means and
  the spread (max - min) / mean of each side;
- resources: registers, stack and spill bytes of every kernel (``ptxas
  -v``) of each build's library and of this tree's; with ``--sass DIR``,
  each library's SASS in DIR (gzip) and its opcode counts by kernel in
  the JSON.

The inputs are ``chip_smoke.py``'s ``wide_inputs`` and ``kernel_cases``,
drawn as that script draws them. Prints a JSON line with the card's name
and power limit, the resources, the bits and the errors, then one a timed
case (``--out`` keeps everything). Needs a CUDA card, nvcc and cuobjdump;
imports no JAX.
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

LIB = "gram_matvec"
LAUNCHER = "gram_matvec_launch"
# the C launcher from before the chunked route's scratch: x1, x2, v, gamma,
# partial, out, m, n, d, per_split, splits, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURE = [_P, _P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P]
BITS = ("cg l4096 d32", "cg emnist l4096 d32", "cg l4096 d16", "cg l4096 d64")
ERROR_DS = (129, 220, 784, 1024)
TIMED = (("wide cg l4096 d784", 784), ("cg l4096 d32", 32))
TURN_MS = 100.0


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(native, src_dir: Path, out_dir: Path):
    """One nvcc of ``src_dir``'s source: (library path, process)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{LIB}.so"
    return so, subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(src_dir / f"{LIB}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(lib: ctypes.CDLL, native):
    """(launcher, takes the chunked route's scratch)."""
    fn = getattr(lib, LAUNCHER)
    scratch = hasattr(lib, "gram_matvec_scratch_rows")
    fn.argtypes = native.SIGNATURES[LIB][LAUNCHER] if scratch else OLD_SIGNATURE
    fn.restype = ctypes.c_int
    return fn, scratch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--sass", metavar="DIR", help="dump each library's SASS here")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.kernels import gram_matvec as gmv
    from repro_torch.kernels import native, ops

    if not torch.cuda.is_available():
        print("gram_matvec_ab: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smoke = chip_smoke()
    builds = dict(b.split("=", 1) for b in args.builds)
    if "this" in builds:
        ap.error("'this' names this tree's build")
    scratch_dir = ROOT / ".checkout" / "gram_matvec_ab_build"
    # this tree's source too, so that ptxas reports on every build alike
    procs = {name: build(native, Path(d), scratch_dir / name)
             for name, d in {"this": native.CSRC, **builds}.items()}
    fns, res, errors = {}, {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:   # reported, and the run fails at its end
            errors[name] = log[-4000:]
            continue
        res[name] = resources(log)
        fns[name] = bind(ctypes.CDLL(str(so)), native)
    if "this" not in fns:
        print(f"gram_matvec_ab: this tree's library did not build:\n{errors['this']}",
              file=sys.stderr)
        return 1
    out = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "builds": builds, "build_errors": errors, "resources": res}
    if args.sass:
        dump = Path(args.sass)
        dump.mkdir(parents=True, exist_ok=True)
        out["sass"] = {name: sass(native, so, dump / f"{name}_{LIB}.sass.gz")
                       for name, (so, _) in procs.items() if name in fns}
    stream = native.stream_handle(device)

    def call(side, x1, x2, v, gamma):
        """The side's launcher on these tensors, with the scratch and the
        split plan its launchers take."""
        fn, scratch = fns[side]
        m, d = x1.shape
        n = x2.shape[0]
        chunked = d > gmv.CHUNK
        target = gmv.CHUNKED_TARGET_BLOCKS if chunked and scratch else gmv.TARGET_BLOCKS
        per_split, splits = gmv.split_plan(m, n, target)
        partial = torch.empty((splits, m), dtype=torch.float64, device=device)
        out_ = torch.empty((m,), device=device)
        head = [x1.data_ptr(), x2.data_ptr(), v.data_ptr(), float(gamma), partial.data_ptr(),
                out_.data_ptr()]
        if scratch:
            elems, rows = gmv.chunked_scratch(m, n, d, x1.data_ptr() == x2.data_ptr() and m == n)
            planes = torch.empty((elems if chunked else 1,), dtype=torch.bfloat16, device=device)
            norms = torch.empty((rows if chunked else 1,), dtype=torch.float64, device=device)
            head += [planes.data_ptr(), norms.data_ptr()]

        def run():
            rc = fn(*head, m, n, d, per_split, splits, stream)
            if rc:
                raise RuntimeError(f"gram_matvec_ab: {side} failed with CUDA error {rc}")
            return out_
        return run

    cases = dict(smoke.kernel_cases(np.random.default_rng(0), ops)["gram_matvec"])

    def inputs(label, d):
        if label in cases:
            return smoke.to_device(cases[label], device)
        return smoke.wide_inputs("gram_matvec", d, device)

    failed = []
    out["bits"], out["errors"] = [], []
    for label in BITS:
        args_ = inputs(label, int(label.rsplit("d", 1)[1]))
        want = call("this", *args_)().clone()
        for name in fns:
            if name == "this":
                continue
            got = call(name, *args_)()
            torch.cuda.synchronize()
            row = {"case": label, "against": name, "bitwise": bool(torch.equal(got, want)),
                   "max_abs_diff": float((got - want).abs().max())}
            out["bits"].append(row)
            if not row["bitwise"]:
                failed.append(f"{name} {label}")
    for d in ERROR_DS:
        args_ = inputs(None, d)
        plain = gmv.gram_matvec_plain(*args_)
        row = {"case": f"cg l4096 d{d}", "max_abs_err_vs_plain": {}}
        for name in fns:
            got = call(name, *args_)()
            torch.cuda.synchronize()
            row["max_abs_err_vs_plain"][name] = float((got - plain).abs().max())
        out["errors"].append(row)

    # the SM clock and the board's power every 100 ms through the timed turns
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out["timing"] = []
    for label, d in TIMED:
        args_ = inputs(None, d)
        for name in fns:
            if name == "this":
                continue
            calls = {name: call(name, *args_), "this": call("this", *args_)}
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
                "case": label, "against": name, "ms": mean,
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
    print(json.dumps({k: out[k] for k in ("nvidia_smi", "build_errors", "resources")}))
    print(json.dumps({"clocks": out.get("clocks")}))
    print(json.dumps({"bits": out["bits"], "errors": out["errors"]}))
    for row in out["timing"]:
        print(json.dumps({k: row[k] for k in ("case", "against", "ms", "this_over_other",
                                              "spread")}))
    if failed or errors:
        print(f"gram_matvec_ab: not bitwise this tree's: {failed}; not built: {sorted(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
