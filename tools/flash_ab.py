"""Hold this tree's flash attention kernels to other builds of them on one
card: a parent commit's sources, or a variant of this tree's.

    python3 tools/flash_ab.py NAME=DIR [NAME=DIR ...] [--out FILE]
        [--sass DIR] [--require-bits NAME ...] [--rounds N]

Each DIR holds ``flash_attention.cu`` (float32), ``flash_attention_tc.cu``
(bfloat16), ``flash_attention_tc_f16.cu`` (float16, which includes the
bf16 source) or several, with this tree's C launchers, and the headers
they include (``flash_chunked.cuh``); a parent's come from ``git show
<commit>:src/repro_torch/kernels/csrc/<file> > DIR/<file>``. Every DIR is
built with this tree's nvcc flags, all builds at once, and then, for each
build against this tree's libraries:

- bits: at every one-pass width, hd 16, 32, 64, 128, 192 and 256, on the
  five shapes and masks of ``BITS_SHAPES``, this tree's output bitwise
  the build's or not (the builds named by ``--require-bits`` must agree on
  every case, or the run fails);
- time: at ``TIMED`` (the llama3.2-1b serve prefill in fp32 and bf16, the
  hd-128 prefill of llava's width in bf16, and the chunked kernels at hd
  512 in bf16, fp16 and fp32), the build and this tree in ``--rounds``
  rounds of turns (build, this, this, build), each turn a run of
  back-to-back launches over ~40 ms timed with CUDA events: ms a call of
  each turn, their means and the spread (max - min) / mean of each side;
  at a chunked row (hd past 256, where the bits may differ) each side's
  largest error against the plain version on the same inputs instead;
- resources: registers, stack and spill bytes of every kernel
  (``ptxas -v``) of each build's libraries, and of this tree's where the
  run builds them (not yet built in this checkout's ``_build/``); with
  ``--sass DIR``, each library's SASS in DIR (gzip) and its opcode counts by
  kernel in the JSON.

Prints a JSON line with the card's name and power limit and the bits,
then one a timed case (``--out`` keeps everything). Needs a CUDA card,
nvcc and cuobjdump; imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import gzip
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# library -> (C launcher, the torch dtype name it takes)
LIBS = {"flash_attention": ("flash_attention_launch", "float32"),
        "flash_attention_tc": ("flash_attention_tc_launch", "bfloat16"),
        "flash_attention_tc_f16": ("flash_attention_tc_f16_launch", "float16")}
# (label, (B, Sq, Skv, H, K), causal, window): one of each mask, and the serve shape
BITS_SHAPES = (
    ("b2 s256 h4 k4 causal", (2, 256, 256, 4, 4), True, 0),
    ("b2 s300 h8 k2 causal window100", (2, 300, 300, 8, 2), True, 100),
    ("b1 s333 h12 k2 non-causal", (1, 333, 333, 12, 2), False, 0),
    ("b2 s201 h8 k2 non-causal window64", (2, 201, 201, 8, 2), False, 64),
    ("serve b4 s2048 h32 k8 causal", (4, 2048, 2048, 32, 8), True, 0),
)
BITS_HDS = (16, 32, 64, 128, 192, 256)
# (label, (B, S, H, K, hd), dtype name), all causal
TIMED = (("serve b4 s2048 h32 k8 hd64 causal", (4, 2048, 32, 8, 64), "bfloat16"),
         ("serve b4 s2048 h32 k8 hd64 causal", (4, 2048, 32, 8, 64), "float32"),
         ("b4 s2048 h32 k8 hd128 causal", (4, 2048, 32, 8, 128), "bfloat16"),
         ("chunked b1 s2048 h8 k8 hd512 causal", (1, 2048, 8, 8, 512), "bfloat16"),
         ("chunked b1 s2048 h8 k8 hd512 causal", (1, 2048, 8, 8, 512), "float16"),
         ("chunked b1 s2048 h8 k8 hd512 causal", (1, 2048, 8, 8, 512), "float32"))
CHUNKED_HD = 256   # past it the chunked kernels run: their rows report errors, not bits
TURN_MS = 40.0


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def build(native, src_dir: Path, out_dir: Path) -> dict:
    """Start one nvcc per source in ``src_dir``: lib name -> (path, process)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib in LIBS:
        src = src_dir / f"{lib}.cu"
        if src.exists():
            so = out_dir / f"lib{lib}.so"
            procs[lib] = (so, subprocess.Popen(
                [native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def resources(log: str) -> dict:
    """ptxas -v output -> kernel -> {registers, stack, spill_stores, spill_loads}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out[name] = dict(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def sass(native, so: Path, dump: Path) -> dict:
    """The library's SASS into ``dump`` (gzip); kernel -> {opcode: count}."""
    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    dump.write_bytes(gzip.compress(text.encode()))
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[name][m.group(1).split(".")[0]] += 1
    return {k: dict(sorted(v.items())) for k, v in counts.items()}


def time_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--out", help="write the JSON here too")
    ap.add_argument("--sass", metavar="DIR", help="dump each library's SASS here")
    ap.add_argument("--require-bits", nargs="*", default=[], metavar="NAME")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.kernels import native
    from repro_torch.kernels.flash_attention import flash_attention_plain

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    builds = dict(b.split("=", 1) for b in args.builds)
    scratch = ROOT / ".checkout" / "flash_ab_build"
    procs = {name: build(native, Path(d), scratch / name) for name, d in builds.items()}
    logs = native.build_all(list(LIBS))   # this tree's, beside the others
    fns, res = {}, {"this": {lib: resources(log) for lib, log in logs.items()}}
    errors = {}
    for name, libs in procs.items():
        fns[name], res[name] = {}, {}
        for lib, (so, proc) in libs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:   # reported, and the run fails at its end
                errors[f"{name}/{lib}"] = log[-4000:]
                continue
            res[name][lib] = resources(log)
            fn = getattr(ctypes.CDLL(str(so)), LIBS[lib][0])
            fn.argtypes = native.SIGNATURES[lib][LIBS[lib][0]]
            fn.restype = ctypes.c_int
            fns[name][lib] = fn
    this = {lib: getattr(native.library(lib), fn_name) for lib, (fn_name, _) in LIBS.items()}
    out = {"nvidia_smi": nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
           "builds": builds, "build_errors": errors, "resources": res}
    if args.sass:
        dump = Path(args.sass)
        dump.mkdir(parents=True, exist_ok=True)
        out["sass"] = {"this": {lib: sass(native, native.build_dir() / f"lib{lib}.so",
                                          dump / f"this_{lib}.sass.gz") for lib in LIBS}}
        for name, libs in procs.items():
            out["sass"][name] = {lib: sass(native, so, dump / f"{name}_{lib}.sass.gz")
                                 for lib, (so, _) in libs.items() if lib in fns[name]}
    stream = native.stream_handle(device)

    def call(fn, q, k, v, o, causal, window):
        B, Sq, H, hd = q.shape
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
                          k.shape[1], H, k.shape[2], hd, int(causal), window,
                          1.0 / math.sqrt(hd), stream)

    def draw(rng, shape, dtype):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)

    rng = np.random.default_rng(29)
    failed = []
    out["bits"] = {}
    for name, libs in fns.items():
        rows = []
        for hd in BITS_HDS:
            for label, (B, Sq, Skv, H, K), causal, window in BITS_SHAPES:
                for lib, fn in libs.items():
                    dtype = getattr(torch, LIBS[lib][1])
                    q, k, v = (draw(rng, s, dtype)
                               for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
                    got, want = torch.empty_like(q), torch.empty_like(q)
                    rc = (call(this[lib], q, k, v, got, causal, window)(),
                          call(fn, q, k, v, want, causal, window)())
                    torch.cuda.synchronize()
                    rows.append({"hd": hd, "case": label, "dtype": LIBS[lib][1], "rc": rc,
                                 "bitwise": rc == (0, 0) and bool(torch.equal(got, want)),
                                 "max_abs_diff": float((got.float() - want.float()).abs().max())})
        same = all(r["bitwise"] for r in rows)
        out["bits"][name] = {"cases": len(rows), "all_bitwise": same,
                             "differ": [r for r in rows if not r["bitwise"]]}
        if name in args.require_bits and not same:
            failed.append(name)

    out["timing"] = []
    for label, (B, S, H, K, hd), dt in TIMED:
        lib = next(lib for lib, (_, d) in LIBS.items() if d == dt)
        q, k, v = (draw(rng, (B, S, h, hd), getattr(torch, dt)) for h in (H, K, K))
        o = torch.empty_like(q)
        for name, libs in fns.items():
            if lib not in libs:
                continue
            calls = {name: call(libs[lib], q, k, v, o, True, 0),
                     "this": call(this[lib], q, k, v, o, True, 0)}
            reps = {}
            for side, fn in calls.items():
                time_ms(fn, 2)
                reps[side] = max(1, int(TURN_MS / max(time_ms(fn, 1), 1e-3)))
            turns = {name: [], "this": []}
            for _ in range(args.rounds):
                for side in (name, "this", "this", name):
                    turns[side].append(time_ms(calls[side], reps[side]))
            mean = {s: sum(t) / len(t) for s, t in turns.items()}
            row = {"case": f"{label} {dt}", "against": name, "ms": mean,
                   "this_over_other": mean["this"] / mean[name],
                   "spread": {s: (max(t) - min(t)) / mean[s] for s, t in turns.items()},
                   "turns": turns}
            if hd > CHUNKED_HD:   # the bits may differ: each side against the plain version
                want = flash_attention_plain(q, k, v, True, 0).float()
                row["max_abs_err_vs_plain"] = {}
                for side, fn in calls.items():
                    fn()
                    torch.cuda.synchronize()
                    row["max_abs_err_vs_plain"][side] = float((o.float() - want).abs().max())
            out["timing"].append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("nvidia_smi", "build_errors", "bits")}))
    for row in out["timing"]:
        print(json.dumps({k: row[k] for k in ("case", "against", "ms", "this_over_other",
                                              "spread", "max_abs_err_vs_plain") if k in row}))
    if failed or errors:
        print(f"flash_ab: not bitwise this tree's: {failed}; not built: {sorted(errors)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
