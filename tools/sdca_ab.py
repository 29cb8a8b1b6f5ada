"""Hold this tree's SDCA kernels to another build of them on one card: a
parent commit's source, or a variant of this tree's.

    python3 tools/sdca_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]
        [--sass DIR] [--rounds N]

Each DIR holds an ``sdca.cu`` (and the headers it includes); a parent's
comes from ``git show <commit>:src/repro_torch/kernels/csrc/sdca.cu >
DIR/sdca.cu``. A build whose library exports ``sdca_cluster_launch`` takes
this tree's C launchers; one without it the launchers from before the
cluster kernel (an fp64 ``v`` scratch, the global-memory instantiation
past bucket 12,384 and through ``sdca_global_launch``). Every DIR is built
with this tree's nvcc flags, all builds at once, and then, for each build
against this tree's library:

- the one-block kernel (buckets up to 12,384) through the public launcher
  at ``SHARED``: ``chip_smoke.py``'s group shapes g256 b64 and g128 b256
  and the emnist ideal at bucket 2,048 (20 epochs), and the pooled emnist
  ideal at scale 0.1 cut to 4,096, 8,192 and 12,352 rows (1 epoch; past
  ~3,600 rows its K outgrows the L2): this tree's alphas bitwise the
  build's or not (any case apart fails the run), and the two in turns;
- past the shared-memory bucket (``PAST``: the ideal at 12,416 and 16,384
  rows, 1 epoch) the public launchers in turns, this tree's cluster kernel
  against the build's kernel there, and each side's largest error against
  the plain version at 1 epoch;
- this tree's cluster kernel through its private entry at the one-block
  kernel's ``PRIVATE`` shapes (the ideal at 4,096, 8,192 and 12,352 rows,
  1 epoch), in turns with this tree's one-block kernel.

Turns go (other, this, this, other) for ``--rounds`` rounds, each turn a
run of back-to-back calls over ~``TURN_MS`` timed with CUDA events: ms a
call of each turn, their means and the spread (max - min) / mean of each
side. Resources: registers, stack and spill bytes of every kernel (``ptxas
-v``) of each build's library and of this tree's; with ``--sass DIR``,
each library's SASS in DIR (gzip) and its opcode counts by kernel in the
JSON. Prints a JSON line with the card's name and power limit and the
resources, then one a case (``--out`` keeps everything). Needs a CUDA card,
nvcc and cuobjdump; imports no JAX.
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

LIB = "sdca"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launchers from before the cluster kernel: K, y, n_real, alpha, v, g, b, lam, epochs, stream
OLD_SIGNATURE = [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P]
IDEAL_SCALE = 0.1   # an emnist federation pooling > 16,384 train rows (chip_smoke.py's)
SHARED = (("group g256 b64", None), ("group g128 b256", None),
          ("ideal emnist g1 b2048 n2000", None), ("ideal g1 b4096 e1", 4096),
          ("ideal g1 b8192 e1", 8192), ("ideal g1 b12352 e1", 12_352))
PAST = (("ideal g1 b12416 e1", 12_400), ("ideal g1 b16384 e1", 16_384))
PRIVATE = ("ideal g1 b4096 e1", "ideal g1 b8192 e1", "ideal g1 b12352 e1")
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
    """(public launcher, the launcher past the shared-memory bucket at any
    bucket, takes the fp64 v scratch)."""
    old = not hasattr(lib, "sdca_cluster_launch")
    names = ("sdca_launch", "sdca_global_launch" if old else "sdca_cluster_launch")
    fns = tuple(getattr(lib, n) for n in names)
    for fn, name in zip(fns, names):
        fn.argtypes = OLD_SIGNATURE if old else native.SIGNATURES[LIB][name]
        fn.restype = ctypes.c_int
    return fns[0], fns[1], old


def turns(calls: dict, rounds: int, order: tuple) -> dict:
    """``calls`` (side -> fn) in turns (a, b, b, a) for ``rounds`` rounds."""
    reps = {}
    for side, fn in calls.items():
        time_ms(fn, 1)
        reps[side] = max(1, int(TURN_MS / max(time_ms(fn, 1), 1e-3)))
    got = {side: [] for side in calls}
    for _ in range(rounds):
        for side in (order[0], order[1], order[1], order[0]):
            got[side].append(time_ms(calls[side], reps[side]))
    mean = {s: sum(t) / len(t) for s, t in got.items()}
    return {"ms": mean, "this_over_other": mean[order[1]] / mean[order[0]],
            "spread": {s: (max(t) - min(t)) / mean[s] for s, t in got.items()},
            "turns": got, "reps": reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--sass", metavar="DIR", help="dump each library's SASS here")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.kernels import native, ops
    from repro_torch.kernels.sdca import sdca_plain

    if not torch.cuda.is_available():
        print("sdca_ab: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smoke = chip_smoke()
    builds = dict(b.split("=", 1) for b in args.builds)
    if "this" in builds:
        ap.error("'this' names this tree's build")
    scratch_dir = ROOT / ".checkout" / "sdca_ab_build"
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
        print(f"sdca_ab: this tree's library did not build:\n{errors['this']}", file=sys.stderr)
        return 1
    out = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "builds": builds, "build_errors": errors, "resources": res}
    if args.sass:
        dump = Path(args.sass)
        dump.mkdir(parents=True, exist_ok=True)
        out["sass"] = {name: sass(native, so, dump / f"{name}_{LIB}.sass.gz")
                       for name, (so, _) in procs.items() if name in fns}
    stream = native.stream_handle(device)

    def call(side, K, y, n_real, lam, epochs, private=False):
        """The side's public launcher (or, with ``private``, its launcher
        past the shared-memory bucket) on these tensors."""
        public, past, old = fns[side]
        fn = past if private else public
        g, b, _ = K.shape
        alpha = torch.empty((g, b), dtype=torch.float32, device=device)
        head = [K.data_ptr(), y.data_ptr(), n_real.data_ptr(), alpha.data_ptr()]
        if old:
            v = torch.empty((g, b), dtype=torch.float64, device=device)
            head.append(v.data_ptr())

        def run():
            rc = fn(*head, g, b, float(lam), int(epochs), stream)
            if rc:
                raise RuntimeError(f"sdca_ab: {side} failed with CUDA error {rc}")
            return alpha
        return run

    cases = dict(smoke.kernel_cases(np.random.default_rng(0), ops)["sdca"])

    def inputs(label, cap):
        if cap is None:
            return smoke.to_device(smoke.case_args(cases[label]), device)
        return smoke.ideal_problem_on(device, IDEAL_SCALE, cap, 1)

    failed = []
    out["shared"], out["past"], out["private"] = [], [], []
    for label, cap in SHARED:
        args_ = inputs(label, cap)
        want = call("this", *args_)().clone()
        for name in fns:
            if name == "this":
                continue
            got = call(name, *args_)().clone()
            torch.cuda.synchronize()
            row = {"case": label, "against": name, "bitwise": bool(torch.equal(got, want)),
                   "max_abs_diff": float((got - want).abs().max()),
                   **turns({name: call(name, *args_), "this": call("this", *args_)},
                           args.rounds, (name, "this"))}
            out["shared"].append(row)
            if not row["bitwise"]:
                failed.append(f"{name} {label}")
        if label in PRIVATE:
            out["private"].append({"case": label, "cluster_max_abs_diff": float(
                (call("this", *args_, private=True)() - want).abs().max()),
                **turns({"one_block": call("this", *args_),
                         "cluster": call("this", *args_, private=True)},
                        args.rounds, ("one_block", "cluster"))})
        del args_
        torch.cuda.empty_cache()
    for label, cap in PAST:
        args_ = inputs(label, cap)
        plain = sdca_plain(*args_)
        errs = {name: float((call(name, *args_)() - plain).abs().max()) for name in fns}
        for name in fns:
            if name != "this":
                out["past"].append({"case": label, "against": name,
                                    "max_abs_err_vs_plain": errs, **turns(
                                        {name: call(name, *args_), "this": call("this", *args_)},
                                        args.rounds, (name, "this"))})
        del args_, plain
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("nvidia_smi", "build_errors", "resources")}))
    for part in ("shared", "past", "private"):
        for row in out[part]:
            print(json.dumps({"part": part, **{k: v for k, v in row.items()
                                               if k not in ("turns", "reps")}}))
    if failed or errors:
        print(f"sdca_ab: not bitwise this tree's: {failed}; not built: {sorted(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
