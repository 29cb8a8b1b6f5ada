"""The paper's emnist round at emnist's 784 pixels on one card, with all
of Table 1's 3,462 writers: ``chip_smoke.py``'s ``wide`` (c), which runs a
quarter of them, at full scale.

    python3 tools/wide_round.py [--out FILE]

Builds the port's kernels (``native.build_all``), warms them with
``wide``'s scale-0.02 fp32 round at d 784, draws the federation
(``make_emnist_like(seed=0, scale=1.0, dim=784)``), then runs
``chip_smoke.wide_full_round`` on it: the round's wall seconds, its spans
(``round.score`` among them), each kernel's launches and summed CUDA-event
launch times inside the spans, the AUCs and best k. Prints the card's name
and power limit as ``nvidia-smi`` gives them, then one JSON line
(``--out`` writes it too). Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SCALE = 1.0   # Table 1's 3,462 devices


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON here too")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("wide_round: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import native, ops
    from repro_torch.obs import trace
    from repro_torch.utils.device import resolve_device

    smoke = chip_smoke()
    device = resolve_device("cuda")   # also turns TF32 off
    card = smoke.nvidia_smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    native.build_all()
    build_s = time.perf_counter() - t0
    _, warm_s = smoke.wide_round(smoke.WIDE_ROUNDS["fp32 d784"], smoke.WIDE_ROUND, device)
    ds, gen_s = smoke.wide_federation(SCALE, smoke.WIDE_FULL_DIM)
    out = {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "scale": SCALE, "build_seconds": build_s, "warm_round_seconds": warm_s,
           "generate_seconds": gen_s, **smoke.wide_full_round(ops, trace, ds, device)}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
