"""Hold this tree's ``rbf_gram_q8`` kernels to another build of them on one
card: a parent commit's source, or a variant of this tree's.

    python3 tools/gram_q8_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]
        [--sass DIR] [--rounds N] [--dims D,D,...] [--require-bits NAME ...]

Each DIR holds a ``gram_q8.cu``; a parent's comes from ``git show
<commit>:src/repro_torch/kernels/csrc/gram_q8.cu > DIR/gram_q8.cu``. A
build whose library exports ``rbf_gram_q8_slab_dim`` takes this tree's C
launchers (the chunked route's scratch, its split plan at
``CHUNKED_TARGET_BLOCKS``); one without it the launchers from before that
route (no scratch; every kernel on the staged kernel's split plan). Every
DIR is built with this tree's nvcc flags, all builds at once, and then,
for each build against this tree's library:

- bits: the staged kernel through the public launcher on
  ``chip_smoke.py``'s d-32 student cases ("student predict b8192 n4096
  d32", "student emnist b8192 n4096 d32") and at d 128, and the chunked
  route past d 128 at ``DIMS`` (b 8,192 against 4,096 int8 supports,
  ``chip_smoke.py``'s ``wide_inputs``): this tree's output bitwise the
  build's or not (a build named by ``--require-bits``, by default every
  build, that differs fails the run);
- errors: each side's largest error against the plain version at ``DIMS``;
- time: at ``DIMS`` (``--dims`` picks some) and the staged d-32 student,
  the build and this tree in ``--rounds`` rounds of turns (build, this,
  this, build), each turn a run of back-to-back calls over ~100 ms timed
  with CUDA events: ms a call of each turn, their means and the spread
  (max - min) / mean of each side; then each side's device ms a call by
  kernel (the prologue's and the kernel's apart), read by
  ``chip_smoke.py``'s ``device_time`` (``torch.profiler``);
- resources: registers, stack and spill bytes of every kernel (``ptxas
  -v``) of each build's library and of this tree's; with ``--sass DIR``,
  each library's SASS in DIR (gzip) and its opcode counts by kernel in
  the JSON.

Prints a JSON line with the card's name and power limit, the resources,
the bits and the errors, then one a timed case (``--out`` keeps
everything). Needs a CUDA card, nvcc and cuobjdump; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from flash_ab import nvidia_smi, resources, sass, time_ms  # noqa: E402
from gram_matvec_ab import TURN_MS, build, chip_smoke  # noqa: E402

LIB = "gram_q8"
LAUNCHER = "rbf_gram_q8_launch"
# the C launcher from before the chunked route's scratch: x, q, scale, zero,
# gamma, out, m, n, d, per_split, splits, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURE = [_P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _P]
STAGED_BITS = ("student predict b8192 n4096 d32", "student emnist b8192 n4096 d32")
STAGED_TIMED = "student emnist b8192 n4096 d32"
DIMS = (129, 256, 784, 1024)


def bind(lib: ctypes.CDLL, native):
    """(launcher, takes the chunked route's scratch)."""
    fn = getattr(lib, LAUNCHER)
    scratch = hasattr(lib, "rbf_gram_q8_slab_dim")
    fn.argtypes = native.SIGNATURES[LIB][LAUNCHER] if scratch else OLD_SIGNATURE
    fn.restype = ctypes.c_int
    return fn, scratch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--sass", metavar="DIR", help="dump each library's SASS here")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dims", default=",".join(map(str, DIMS)),
                    help="the feature dims past 128 to time (bits and errors take all DIMS)")
    ap.add_argument("--require-bits", nargs="*", metavar="NAME",
                    help="the builds that must give this tree's bits (default: all)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.kernels import native, ops
    from repro_torch.kernels import rbf_gram_q8 as q8

    if not torch.cuda.is_available():
        print("gram_q8_ab: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smoke = chip_smoke()
    builds = dict(b.split("=", 1) for b in args.builds)
    if "this" in builds:
        ap.error("'this' names this tree's build")
    required = set(builds if args.require_bits is None else args.require_bits)
    timed_dims = [int(d) for d in args.dims.split(",") if d]
    scratch_dir = ROOT / ".checkout" / "gram_q8_ab_build"
    # this tree's source too, so that ptxas reports on every build alike
    procs = {name: build(native, Path(d), scratch_dir / name, LIB)
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
        print(f"gram_q8_ab: this tree's library did not build:\n{errors['this']}",
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

    def call(side, x, q, scale, zero, gamma):
        """The side's public launcher on these tensors, with the scratch and
        the split plan its launchers take."""
        fn, scratch = fns[side]
        m, d = x.shape
        n = q.shape[0]
        chunked = scratch and d > q8.STAGED_D
        per_split, splits = q8.plan(m, n, chunked)
        out_ = torch.empty((m, n), device=device)
        head = [x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(), float(gamma),
                out_.data_ptr()]
        kept = ()
        if scratch:
            elems, floats = q8.chunked_scratch(m, n, d) if chunked else (1, 1)
            kept = (torch.empty((elems,), dtype=torch.bfloat16, device=device),
                    torch.empty((floats,), dtype=torch.float32, device=device))
            head += [t.data_ptr() for t in kept]

        def run(_scratch=kept):   # the scratch lives as long as the call
            rc = fn(*head, m, n, d, per_split, splits, stream)
            if rc:
                raise RuntimeError(f"gram_q8_ab: {side} failed with CUDA error {rc}")
            return out_
        return run

    cases = dict(smoke.kernel_cases(np.random.default_rng(0), ops)["rbf_gram_q8"])

    def inputs(label, d):
        if label in cases:
            return smoke.to_device(cases[label], device)
        return smoke.wide_inputs("rbf_gram_q8", d, device)

    failed = []
    out["bits"], out["errors"] = [], []
    for label, d in [(lbl, 32) for lbl in STAGED_BITS] + [(f"b8192 n4096 d{d}", d)
                                                           for d in (128, *DIMS)]:
        args_ = inputs(label, d)
        want = call("this", *args_)().clone()
        plain = q8.rbf_gram_q8_plain(*args_) if d > q8.STAGED_D else None
        row = {"case": label, "bitwise": {}, "max_abs_diff": {}}
        if plain is not None:
            row["max_abs_err_vs_plain"] = {"this": float((want - plain).abs().max())}
        for name in fns:
            if name == "this":
                continue
            got = call(name, *args_)()
            torch.cuda.synchronize()
            row["bitwise"][name] = bool(torch.equal(got, want))
            row["max_abs_diff"][name] = float((got - want).abs().max())
            if plain is not None:
                row["max_abs_err_vs_plain"][name] = float((got - plain).abs().max())
            if name in required and not row["bitwise"][name]:
                failed.append(f"{name} {label}")
        (out["errors"] if plain is not None else out["bits"]).append(row)
        del args_, want, plain
        torch.cuda.empty_cache()

    # the SM clock and the board's power every 100 ms through the timed turns
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out["timing"] = []
    for label, d in [(f"wide student b8192 n4096 d{d}", d) for d in timed_dims] + [
            (STAGED_TIMED, 32)]:
        args_ = inputs(label if d == 32 else None, d)
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
            dev_ms = {side: smoke.device_time(fn, (), reps[side], mean[side])[2]
                      for side, fn in calls.items()}
            out["timing"].append({
                "case": label, "against": name, "ms": mean,
                "this_over_other": mean["this"] / mean[name],
                "spread": {s: (max(t) - min(t)) / mean[s] for s, t in turns.items()},
                "device_ms": dev_ms, "turns": turns, "reps": reps})
        del args_
        torch.cuda.empty_cache()
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
                                              "spread", "device_ms")}))
    if failed or errors:
        print(f"gram_q8_ab: not bitwise this tree's: {failed}; not built: {sorted(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
