#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports the port and nothing of JAX or of the reference package
``repro``, and runs ten phases, each printing one JSON line on stdout:

  build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
           for sm_90a, one ``nvcc`` per source, all started together; count
           the tensor-core (HMMA), ldmatrix (LDSM) and cp.async (LDGSTS)
           instructions in the compiled code (``cuobjdump -sass``): the
           bf16 flash kernel, ``rbf_gram_q8``'s ``gram_q8`` and the fp32
           Grams' ``gram`` must have all three, the scorers and
           ``gram_matvec`` LDGSTS;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes and the registry's two shapes, at the
           registry's tolerance; flash attention in fp32 (``flash_attention.cu``)
           and bf16 (the tensor-core ``flash_attention_tc.cu``) at head dims
           32, 64 and 128, 1, 4 and 6 query heads per KV head, causal,
           causal with a window, non-causal, ragged lengths and the serve
           shape; the scorers at k 1 / n 2,000, k 10 at b 8, k 100, k 2,821
           and feature dims 12, 24, 32 and 37; SDCA at the group shapes, on
           the pooled emnist ideal, whose alphas are not all 0 or 1, and on
           the population round's first group
           (``ops.make_population_sdca_problem``);
           ``gram_matvec`` at the CG's l 4,096 on random normals and on the
           round's own validation-pool proxy rows
           (``ops.make_cg_matvec_problem``); ``rbf_gram_q8`` on normal data
           and on the round's own int8 student
           (``ops.make_q8_student_problem``); ``batched_rbf_gram`` at the
           round's fit and score shapes (fits pass x1 as x2) and on the
           round's own first fit group (``ops.make_fit_group_problem``:
           zero-padded rows, per-device gammas); at the population round's
           d 16: ``batched_rbf_gram`` on its first fit group
           (``ops.make_population_fit_group_problem``, g 256 b 64),
           ``ensemble_score`` at b 4,096 k 50 n 40 and ``gram_matvec`` at
           l 4,096. Then determinism, bit for bit:
           two launches of bf16 flash (serve shape), of both scorers (full
           shape; ``ensemble_score`` also at d 16), of SDCA (emnist ideal,
           g256 b64), of ``gram_matvec`` (both l 4,096 d 32 cases and d 16),
           of ``rbf_gram_q8`` (the student), of ``batched_rbf_gram`` (the
           emnist and the dirichlet fit groups) and of ``rbf_gram`` (the
           ideal) equal,
           the first 1,000 rows of an 8,192-row (at d 16 a 4,096-row) call
           of each scorer and of ``rbf_gram_q8`` equal to a 1,000-row call
           (the split plan never depends on b), one SDCA group member
           solved alone equal to its alpha in the group, device 17 of each
           fit group alone equal to its Gram in the group, and ``rbf_gram``
           equal to ``batched_rbf_gram`` of the same rows with g = 1; and
           ``population_identity``: on the population's first
           fit group, SDCA's alphas of 8 members fitted as a group of 8
           equal to theirs in the group of 256, and one device's val and
           test score rows in groups whose query pad selects the Gram's
           16-, 32- and 64-row tiles equal to its rows scored alone (the
           Gram's rows and the engine's ``_score_group``);
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
           share and the device time of ``batched_rbf_gram`` (its 39
           launches) and ``rbf_gram`` beside the bound of the round's own
           launch shapes (``ops.round_gram_launches``);
  main_q8  the same federation with the int8 codec and CG distillation on
           4,096 validation-pool proxy rows: spans (``distill.round``
           included), AUCs (the distilled student's included), the
           student's support count and codec, and each kernel's launches,
           all seven > 0, ``gram_matvec``'s equal to the CG iterations;
           then once more under the profiler;
  population  ``run_population`` (``sim/population.py``) at d 16: (a)
           parity on 2,048 devices, an availability federation (base
           dirichlet) in int8 under a binding 30,000-byte budget and a
           quantity-skew one in fp32, both with CG distillation on 1,024
           validation-pool rows, each bucketed on cuda, streamed on cuda in
           chunks of 300 and bucketed on cpu: streamed equal to bucketed in
           every report field (the student's coefficients bit for bit),
           cuda and cpu equal in ``comm``, picked ids and headcounts, AUCs
           within 1e-4 (the distilled one reported beside the CG's
           iterations where the CG stopped unconverged); (b) the streamed
           round on 100,000 dirichlet devices (alpha 0.3, 80 samples, chunks
           of 1,024, ks 10 and 50, cv/data/random, 128 evaluation devices,
           CG distillation on 4,096 ``scenario`` proxy rows): wall seconds,
           devices a second, ``round.*`` and ``distill.round`` spans, the
           ``engine.chunk`` count, headcounts, AUCs, ``comm``, the card's
           peak allocated bytes and each kernel's launches
           (``batched_rbf_gram``, ``sdca``, ``ensemble_score`` and
           ``gram_matvec`` > 0, ``gram_matvec``'s equal to the CG
           iterations); then once more under the profiler; (c) the traced
           host peak (``tracemalloc``) of the streamed pass alone at 25,000
           and 100,000 devices: under 64 MiB and flat;
  agg      the aggregator zoo (``repro_torch.agg``): (a) ``main``'s emnist
           round at full width with ``fisher``, ``reweight`` and
           ``feature_stats`` in fp32 (``fisher`` once more under the
           profiler for the device's busy share), then with ``reweight:10``
           in int8 with CG distillation on 4,096 proxy rows (a weighted
           int8 teacher): wall seconds, ``round.*`` spans, the extras' and
           uploads' bytes and each kernel's launches, the fp32 round's four
           kernels (and the int8 round's seven) > 0; (b) ``population``'s
           streamed 100,000-device round with ``reweight``: wall seconds,
           devices a second, the extras' bytes and ``train_selected``'s
           groups; (c) ``benchmarks/agg_bench.py``'s full sweep (3 scenarios
           x 3 codecs x 4 aggregators, 48 devices, cv, k 5) on cuda and on
           cpu: equal ledgers and picked ids, AUCs within 1e-4; and for
           each aggregator the streamed round equal to the bucketed round in
           every report field on cuda (2,048 int8 dirichlet devices); then
           the baselines: the Pegasos fit (128 rows, d 32, 5 epochs) timed
           on cuda and within 1e-5 of its cpu fit, and cohort labels from
           card-scored embeddings equal to the cpu's;
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
           kernel, plain) with CUDA events (``ms``; for a kernel of a few
           microseconds mostly the wrapper's host time), and the kernel's
           own device time a call from ``torch.profiler`` over a run of
           back-to-back calls (``device_ms``), at main-path shapes
           (``batched_rbf_gram`` at six of the round's 15), beside a
           ``fill_`` of the output (the card's own write rate) and the
           analytic bound: the larger of operations over the card's peak
           for the inputs' type (67 TFLOP/s fp32 outside the tensor cores,
           989 TFLOP/s bf16 dense) and bytes (each input read once, each
           output written once) over 3.35 TB/s, the H100 SXM's published
           peaks; flash attention also beside ``library_ms``, one call of
           ``torch.nn.functional.scaled_dot_product_attention`` on the same
           tensors (a yardstick only: the port never calls it). SDCA's
           rows also give ns a step and a chain figure: the steps of the
           longest solve times one step's latency, from the kernel on a
           single 32-row tile.

The last three lines are the per-kernel summary ``{"kernels": [...]}``
(each kernel's launches read from the run it was ported for: ``main``
for the four fp32 kernels, ``main_q8`` for the three int8/CG ones,
``serve`` for flash attention, named in ``launches_path``; the
``population`` line carries its own counts), the card's
name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {...}}``. A failed phase exits non-zero without
that last line, and so does a machine without a CUDA device or a
directory without the port's sources. ``--phases`` runs a subset (for a
first check of a new kernel: ``--phases build,kernels``), ``--kernels``
restricts the ``kernels`` and ``timing`` phases to the named kernels
(``--kernels gram_matvec``); ``--out FILE`` writes the compiler's log and
the detailed timings there as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "main", "main_q8", "population", "agg", "lm_parity",
          "serve", "timing")
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

def _gram_inputs(rng, g, m, n, d, fit=False):
    """Normal rows and gammas 1 / (d u), u in [0.5, 2]; a fit passes x1 as
    x2 (the same array), as the engine's fit does."""
    x1 = rng.normal(size=(g, m, d)).astype("float32")
    x2 = x1 if fit else rng.normal(size=(g, n, d)).astype("float32")
    gam = (1.0 / (d * rng.uniform(0.5, 2.0, size=g))).astype("float32")
    return x1, x2, gam


class Lazy:
    """A case's arguments built at first use (the cases made from a whole
    federation take seconds, and a run that never reads them skips them)."""

    def __init__(self, make):
        self.make, self.args = make, None

    def __call__(self):
        if self.args is None:
            self.args = self.make()
        return self.args


def case_args(args):
    return args() if isinstance(args, Lazy) else args


def kernel_cases(rng, ops):
    """name -> [(label, numpy args)]: the main path's shapes, then the
    registry's ragged shape. Shapes follow the full emnist round (d = 32;
    SDCA buckets 64..256 in groups of up to 256 devices; val/test queries
    padded to 8 rows; 8192-row scoring chunks; 2,821 eligible members of
    up to 230 supports; the 2,000-row pooled ideal, SDCA bucket 2048) and
    its int8 + distillation leg (CG on 4,096 proxy rows; the 4,096-support
    int8 student scored in 8192-row chunks). int8 supports are quantised
    from normal data by the port's own codec, so scale and zero are what
    the wire gives. The cases made from a federation are ``Lazy``
    (``case_args`` builds them)."""
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
            ("fit g256 b64", _gram_inputs(rng, 256, 64, 64, 32, fit=True)),
            ("fit g256 b128", _gram_inputs(rng, 256, 128, 128, 32, fit=True)),
            ("fit g128 b256", _gram_inputs(rng, 128, 256, 256, 32, fit=True)),
            ("score g256 q16 b64", _gram_inputs(rng, 256, 16, 64, 32)),
            ("score g256 q56 b64", _gram_inputs(rng, 256, 56, 64, 32)),
            ("score g128 q184 b256", _gram_inputs(rng, 128, 184, 256, 32)),
            # the round's own first fit: 256 emnist devices' train rows
            # zero-padded to 64, each at its default_gamma
            ("fit emnist g256 b64", Lazy(lambda: ops.make_fit_group_problem(seed=0))),
            # the population round's first fit group: 256 dirichlet devices
            # at d 16 (``ops.make_population_fit_group_problem``)
            ("fit dirichlet g256 b64 d16",
             Lazy(lambda: ops.make_population_fit_group_problem(seed=0))),
        ],
        "rbf_gram": [
            ("ideal 2000x2000x32", gram1(2000, 2000, 32)),
        ],
        "ensemble_score": [
            ("full b8192 k2821 n230", ens(8192, 2821, 230, 32)),
            ("k100 b8192 n230", ens(8192, 100, 230, 32)),
            ("ideal predict b8192 k1 n2000", ens(8192, 1, 2000, 32)),
            ("k10 b8 n230", ens(8, 10, 230, 32)),
            ("d37 b300 k7 n77", ens(300, 7, 77, 37)),
            # the population round's evaluation: 128 devices' test rows
            # (4,096 padded) against up to 50 members of 40 supports at d 16
            ("population b4096 k50 n40 d16", ens(4096, 50, 40, 16)),
        ],
        "sdca": [
            ("group g256 b64", sdca(256, 64, 33, 64)),
            ("group g128 b256", sdca(128, 256, 193, 256)),
            # random normals at gamma 1/32: every alpha ends at 0 or 1, so any
            # order of summation agrees here; kept for timing only
            ("ideal g1 b2048 n2000", sdca(1, 2048, 2000, 2000)),
            # the round's own ideal: 64 of its 2,000 alphas end inside (0, 1)
            ("ideal emnist g1 b2048 n2000", Lazy(lambda: ops.make_ideal_sdca_problem(seed=0))),
            # the population round's first group: 256 dirichlet devices' fit
            # Grams (d 16), masked as the engine masks them
            ("group dirichlet g256 b64", Lazy(lambda: ops.make_population_sdca_problem(seed=0))),
        ],
        "gram_matvec": [
            ("cg l4096 d32", matvec(4096, 32)),
            # the round's own CG input: 4,096 pooled validation rows at
            # default_gamma (gamma |x|^2 ~ 1)
            ("cg emnist l4096 d32", Lazy(lambda: ops.make_cg_matvec_problem(seed=0))),
            # the population round's CG on 4,096 proxy rows at d 16
            ("cg l4096 d16", matvec(4096, 16)),
        ],
        "rbf_gram_q8": [
            ("student predict b8192 n4096 d32", gram_q8(8192, 4096, 32)),
            # the round's own int8 student: 4,096 proxy supports as the codec
            # sends them, the first 8,192 pooled test rows, default_gamma
            ("student emnist b8192 n4096 d32",
             Lazy(lambda: ops.make_q8_student_problem(seed=0))),
        ],
        "ensemble_score_q8": [
            ("full b8192 k2821 n230", ens_q8(8192, 2821, 230, 32)),
            ("k100 b8192 n230", ens_q8(8192, 100, 230, 32)),
            ("k1 b8192 n2000", ens_q8(8192, 1, 2000, 32)),
            ("k10 b8 n230", ens_q8(8, 10, 230, 32)),
            ("d37 b300 k7 n77", ens_q8(300, 7, 77, 37)),
        ],
        "flash_attention": [
            (f"{label} {dt}", flash(shape, causal, window, getattr(torch, dt)))
            for dt in ("bfloat16", "float32")
            for label, shape, causal, window in FLASH_SHAPES
        ],
    }
    for name, spec in ops.KERNEL_REGISTRY.items():
        cases[name].append(("registry", spec.make_inputs(rng)))
        cases[name].append(("ragged", spec.make_ragged(rng)))
    return cases


def to_device(args, device):
    """The arguments on ``device``; an array passed twice (a fit's x1 and
    x2) becomes one tensor passed twice."""
    import numpy as np
    import torch

    moved = {}

    def move(a):
        if not isinstance(a, (np.ndarray, torch.Tensor)):
            return a
        if id(a) not in moved:
            moved[id(a)] = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                            if isinstance(a, np.ndarray) else a.to(device))
        return moved[id(a)]

    return tuple(move(a) for a in case_args(args))


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
        n = n_real.astype("int64")
        # K*y once, then per step a length-n dot (2n) and ~8 scalar ops
        ops = int((n * n + epochs * n * (2 * n + 8)).sum())
        nbytes = 4 * (g * b * b + g * b + g + g * b)
        return ops, nbytes
    raise KeyError(name)


def gram_work(g, m, n, d, same=False, gammas=True):
    """(operations, bytes) of g RBF Grams (m, n, d): norms 2d a row; per
    pair 2d for the cross term, 3 to combine, clamp, scale, exp. An operand
    passed as both x1 and x2 (a fit) is read once; per-device gammas add g
    floats."""
    ops = g * (m * n * (2 * d + 6) + 2 * d * (m + (0 if same else n)))
    nbytes = 4 * (g * (m + (0 if same else n)) * d + g * m * n + (g if gammas else 0))
    return ops, nbytes


def bound_ms(ops, nbytes, bf16=False):
    """(ms, "operations" or "bytes"): the larger of ops over the peak for
    the type and bytes over the memory rate."""
    t_ops, t_bytes = ops / (PEAK_BF16_OPS if bf16 else PEAK_FP32_OPS), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_of(name, args):
    ops, nbytes = work_of(name, args)
    return bound_ms(ops, nbytes, bf16=str(getattr(args[0], "dtype", "")) == "torch.bfloat16")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

# SASS opcodes counted in each library: tensor-core products, ldmatrix, cp.async
SASS_OPS = ("HMMA", "LDSM", "LDGSTS")
SASS_REQUIRED = {"flash_attention_tc": ("HMMA", "LDSM", "LDGSTS"), "ensemble_score": ("LDGSTS",),
                 "gram_matvec": ("LDGSTS",), "gram_q8": ("HMMA", "LDSM", "LDGSTS"),
                 "gram": ("HMMA", "LDSM", "LDGSTS")}


def sass_counts(native, name):
    """How often each of SASS_OPS occurs in lib<name>.so's device code."""
    import re

    cuobjdump = Path(native._nvcc()).parent / "cuobjdump"
    r = subprocess.run([str(cuobjdump), "-sass", str(native.build_dir() / f"lib{name}.so")],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass lib{name}.so failed: {r.stderr.strip()}")
    return {op: len(re.findall(rf"\b{op}\b", r.stdout)) for op in SASS_OPS}


def phase_build(native):
    t0 = time.perf_counter()
    logs = native.build_all()
    secs = time.perf_counter() - t0
    libs = sorted(p.name for p in native.build_dir().glob("lib*.so"))
    sass = {name: sass_counts(native, name) for name in SASS_REQUIRED}
    missing = [f"{name}: {op}" for name, ops in SASS_REQUIRED.items() for op in ops
               if sass[name][op] == 0]
    if missing:
        raise AssertionError(f"build: instructions missing from the compiled code: {missing}")
    return {"seconds": secs, "built": sorted(logs), "libs": libs, "sass": sass,
            "build_dir": str(native.build_dir().relative_to(ROOT))}, logs


def phase_kernels(ops, device, rng, names):
    """Every case of every kernel in ``names`` against its plain version;
    all cases run, and the phase fails at the end if any disagreed.
    ``errs`` holds each kernel's largest fp32 error, ``errs[name +
    "/bf16"]`` its bf16 one."""
    import torch

    results, errs, failed = [], {}, []
    all_cases = {n: c for n, c in kernel_cases(rng, ops).items() if n in names}
    for name, cases in all_cases.items():
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
    out = {"cases": results, "determinism": determinism(ops, device, all_cases)}
    if {"batched_rbf_gram", "sdca"} <= set(names):
        out["population_identity"] = population_identity(ops, device)
    return out, errs


SDCA_MEMBER = 17   # the group member solved alone in the determinism check
GRAM_MEMBER = 17   # the fit group's device whose Gram is taken alone


def determinism(ops, device, cases):
    """Bit-for-bit checks of the kernels in ``cases``: two launches of
    bf16 flash attention (serve shape), of both scorers (full shape;
    ``ensemble_score`` also at the population's d 16), of SDCA (the emnist
    ideal and group g256 b64), of ``gram_matvec`` (the l 4,096 CG cases at
    d 32 and d 16), of ``rbf_gram_q8`` (the emnist student), of
    ``batched_rbf_gram`` (the emnist and dirichlet fit groups) and of
    ``rbf_gram`` (the ideal) are equal; the first 1,000 rows of a call of
    each scorer and of ``rbf_gram_q8`` equal a 1,000-row call; member 17
    of the g256 b64 SDCA group solved alone (g = 1) equals its alpha in
    the group; device 17 of each fit group alone (g = 1) gives its Gram in
    the group; ``rbf_gram`` of the ideal equals ``batched_rbf_gram`` of the
    same rows with g = 1 and the same gamma."""
    import torch

    twice = {"flash_attention": ("serve b4 s2048 h32 k8 hd64 causal bfloat16",),
             "ensemble_score": ("full b8192 k2821 n230", "population b4096 k50 n40 d16"),
             "ensemble_score_q8": ("full b8192 k2821 n230",),
             "sdca": ("ideal emnist g1 b2048 n2000", "group g256 b64",
                      "group dirichlet g256 b64"),
             "gram_matvec": ("cg l4096 d32", "cg emnist l4096 d32", "cg l4096 d16"),
             "rbf_gram_q8": ("student emnist b8192 n4096 d32",),
             "batched_rbf_gram": ("fit emnist g256 b64", "fit dirichlet g256 b64 d16"),
             "rbf_gram": ("ideal 2000x2000x32",)}
    by_rows = ("ensemble_score", "ensemble_score_q8", "rbf_gram_q8")
    out = {}
    for name, labels in twice.items():
        if name not in cases:
            continue
        kernel, checks = ops.KERNEL_REGISTRY[name].kernel, {}
        for label in labels:
            args = to_device(dict(cases[name])[label], device)
            first = kernel(*args)
            checks[f"two_launches_equal [{label}]"] = bool(torch.equal(first, kernel(*args)))
            if name in by_rows:   # x is the first argument
                head = kernel(args[0][:1000].contiguous(), *args[1:])
                checks[f"rows_1000_of_{args[0].shape[0]}_equal [{label}]"] = bool(
                    torch.equal(first[:1000], head))
            if label.startswith("group ") and "g256 b64" in label:
                K, y, n_real = (a[SDCA_MEMBER:SDCA_MEMBER + 1].contiguous() for a in args[:3])
                alone = kernel(K, y, n_real, *args[3:])
                checks[f"member {SDCA_MEMBER} alone equals in group [{label}]"] = bool(
                    torch.equal(alone[0], first[SDCA_MEMBER]))
            if label.startswith("fit ") and "g256 b64" in label:
                one = args[0][GRAM_MEMBER:GRAM_MEMBER + 1].contiguous()
                alone = kernel(one, one, args[2][GRAM_MEMBER:GRAM_MEMBER + 1].contiguous())
                checks[f"device {GRAM_MEMBER} alone equals in group [{label}]"] = bool(
                    torch.equal(alone[0], first[GRAM_MEMBER]))
            if name == "rbf_gram":
                x1, x2, gamma = args
                batched = ops.KERNEL_REGISTRY["batched_rbf_gram"].kernel(
                    x1[None], x2[None], torch.tensor([gamma], dtype=torch.float32,
                                                     device=device))
                checks[f"equals batched_rbf_gram with g = 1 [{label}]"] = bool(
                    torch.equal(first, batched[0]))
            del args, first
        out[name] = checks
    torch.cuda.empty_cache()
    failed = [f"{name}: {c}" for name, checks in out.items() for c, ok in checks.items()
              if not ok]
    if failed:
        raise AssertionError(f"determinism: {failed}")
    return out


IDENTITY_MEMBER = 3   # the group position of the device scored alone and in groups
IDENTITY_QUERIES = {"val": (8, 32, 64), "test": (32, 48, 64)}   # q: 16-, 32-, 64-row tiles


def population_identity(ops, device):
    """Bit identity of one device's numbers across the group shapes the
    streamed tier gives it, on the population round's own first fit group
    (``ops.population_fit_group``: 256 dirichlet devices, bucket 64, d 16):
    - SDCA: the first 8 members fitted as a group of 8 (Gram and solve, as
      ``sim/engine.py::_fit_group`` runs them) equal their alphas in the
      group of 256;
    - scores: member ``IDENTITY_MEMBER``'s val rows (8) and test rows (32),
      in a group of 8 padded to each q of ``IDENTITY_QUERIES`` (q selects
      the Gram's 16-, 32- and 64-row tiles, ``batched_gram.tile_plan``)
      and in the whole group of 256 at its own q, give the bits they give
      alone (g 1, q its own rows rounded up to 8):
      the Gram rows and the scores of ``_score_group`` (whose contraction
      ``_row_dot`` sums in an order fixed by the bucket). Whether the
      reference's einsum would have kept them equal is recorded beside
      (``einsum_*``), not required."""
    import numpy as np
    import torch

    from repro_torch.kernels.batched_gram import tile_plan
    from repro_torch.sim import engine

    lam, epochs = 0.01, 20
    bucket, members, pad_floor = ops.population_fit_group(seed=0)

    def packed(group):
        xp, _, gam = ops.pack_fit_group(bucket, group, min(pad_floor, len(group)))
        g = len(xp)
        n_real = np.zeros(g, np.int32)
        n_real[:len(group)] = [sp["train"].n for _, sp in group]
        yp = np.ones((g, bucket), np.float32)
        for i, (_, sp) in enumerate(group):
            yp[i, :sp["train"].n] = sp["train"].y
        alpha = engine._fit_group(*(torch.from_numpy(a).to(device) for a in (xp, yp, n_real, gam)),
                                  lam, epochs).cpu().numpy()
        y0 = np.where(np.arange(bucket)[None, :] < n_real[:, None], yp, 0.0)
        coef = (alpha * y0 / (lam * np.maximum(n_real, 1)[:, None])).astype(np.float32)
        return xp, gam, alpha, coef

    xp256, gam256, alpha256, coef256 = packed(members)
    xp8, gam8, alpha8, coef8 = packed(members[:8])
    checks = {"sdca g8 alphas equal in g256 [b64 d16]": bool(
        np.array_equal(alpha8, alpha256[:8]))}

    gram = ops.KERNEL_REGISTRY["batched_rbf_gram"].kernel
    j = IDENTITY_MEMBER
    tiles = set()

    def run(xq, sup, coef, gam):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (xq, sup, coef, gam)]
        kq = gram(t[0], t[1], t[3])
        return (kq.cpu().numpy(), engine._score_group(*t).cpu().numpy(),
                torch.einsum("gqb,gb->gq", kq, t[2]).cpu().numpy())

    for split, qs in IDENTITY_QUERIES.items():
        rows = [sp[split].x for _, sp in members]
        n = len(rows[j])
        q1 = -(-n // engine.QUERY_PAD) * engine.QUERY_PAD
        alone = np.zeros((1, q1, xp8.shape[2]), np.float32)
        alone[0, :n] = rows[j]
        k1, s1, e1 = run(alone, xp8[j:j + 1], coef8[j:j + 1], gam8[j:j + 1])
        tiles.add(tile_plan(q1, bucket, xp8.shape[2])[0])
        # g 8 at each q, then the whole group of 256 at the round's own q
        einsums = {}
        for g, q, sup, coef, gam in [(8, q, xp8, coef8, gam8) for q in qs] + [
                (len(xp256), q1, xp256, coef256, gam256)]:
            xq = np.zeros((g, q, xp8.shape[2]), np.float32)
            for i, a in enumerate(rows[:g]):
                xq[i, :len(a)] = a
            kq, sc, ein = run(xq, sup, coef, gam)
            rows_tile = tile_plan(q, bucket, xp8.shape[2])[0]
            tiles.add(rows_tile)
            key = f"{split} {n} rows g{g} q{q} ({rows_tile}-row tiles) vs alone q{q1}"
            checks[f"gram {key}"] = bool(np.array_equal(kq[j, :n], k1[0, :n]))
            checks[f"scores {key}"] = bool(np.array_equal(sc[j, :n], s1[0, :n]))
            checks[f"einsum_{key}"] = bool(np.array_equal(ein[j, :n], e1[0, :n]))
            einsums[g, q] = ein[j, :n]
        checks[f"einsum_{split} g8 vs g256 q{q1}"] = bool(
            np.array_equal(einsums[8, q1], einsums[len(xp256), q1]))
    if tiles != {16, 32, 64}:
        raise AssertionError(f"population identity: the queries reached tiles {sorted(tiles)}, "
                             "want 16, 32 and 64")
    failed = [c for c, ok in checks.items() if not ok and not c.startswith("einsum_")]
    if failed:
        raise AssertionError(f"population identity: {failed}")
    return checks


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


def phase_main(make_dataset, run_protocol, ops, trace, must_launch, gram=False, **kw):
    """One full-scale emnist round on cuda with ``kw`` (codec, distill),
    then the same round under the profiler. ``must_launch`` names the
    kernels that must have launched at least once in the measured round;
    with ``gram``, rows 1 and 3's device time in the profiled round beside
    the bound of its launches (``gram_round``)."""
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
                                                          device="cuda", **kw),
                                     functions=tuple(DEVICE_FUNCTIONS) if gram else ())
    if gram:
        out["gram_device"] = gram_round(ops, ds, out["profile"]["by_function"], counts)
    return out


# the population phase: the streamed round at scale (``POP_SCALE``), the
# parity runs (``POP_PARITY``) and the streamed pass's memory
POP_KERNELS = ("batched_rbf_gram", "sdca", "ensemble_score", "gram_matvec")
POP_SCALE = dict(scenario="dirichlet", n_devices=100_000, seed=0, mean_samples=80, dim=16,
                 scenario_params={"alpha": 0.3}, engine="streamed", chunk_devices=1024,
                 ks=(10, 50), strategies=("cv", "data", "random"), eval_device_cap=128,
                 codec="fp32")
POP_PARITY = {   # name -> (config fields, budget); chunk 300 divides neither 2,048 nor a group
    "availability_int8": dict(scenario="availability", scenario_params={"base": "dirichlet"},
                              codec="int8", budget_bytes=30_000),
    "quantity_skew_fp32": dict(scenario="quantity_skew", scenario_params={"sigma": 1.2},
                               codec="fp32"),
}
POP_PARITY_COMMON = dict(n_devices=2048, seed=3, mean_samples=80, dim=16, ks=(10, 50),
                         eval_device_cap=128)
POP_PARITY_CHUNK = 300
POP_MEMORY_DEVICES = (25_000, 100_000)
POP_MEMORY_BUDGET = 64 * 2**20   # the reference's bar (tests/test_stream.py)


def population_fields(rep):
    """Every ``PopulationReport`` field that must be exactly equal between
    the streamed and the bucketed tier, the student's coefficients as bytes."""
    import numpy as np

    student = (None if rep.student is None
               else np.asarray(rep.student.coef, np.float32).tobytes())
    return {"n_available": rep.n_available, "n_eligible": rep.n_eligible,
            "mean_val_auc": rep.mean_val_auc, "mean_local_auc": rep.mean_local_auc,
            "ensemble_auc": rep.ensemble_auc, "comm": rep.comm,
            "time_to_aggregate": rep.time_to_aggregate, "student_coef": student}


def population_aucs(rep, distilled=True):
    import numpy as np

    vals = [rep.mean_val_auc, rep.mean_local_auc]
    for s in sorted(rep.ensemble_auc):
        if s != "distilled" or distilled:
            vals += [rep.ensemble_auc[s][k] for k in sorted(rep.ensemble_auc[s])]
    return np.asarray(vals, np.float64)


def upload_ids(rep):
    """(tag, device id) of every model upload on a materialised round's ledger."""
    return [(e.tag, e.device_id) for e in rep.ledger.events if e.kind == "model_upload"]


def population_parity(sim, trace, DistillConfig):
    """(a): each ``POP_PARITY`` config bucketed on cuda, streamed on cuda in
    chunks of ``POP_PARITY_CHUNK`` and bucketed on cpu (the plain versions),
    with CG distillation on 1,024 validation-pool rows (the lazy pool on the
    streamed run). Streamed equals bucketed in every report field, the
    student's coefficients included; cuda and cpu have equal ``comm``,
    picked ids and headcounts, and AUCs within AUC_TOL. The distilled
    student's AUC is held to AUC_TOL only where the CG converged on both
    devices: a CG stopped at ``maxiter`` returns an iterate that follows
    the rounding of its matvec (on these configs its AUC moves ~1e-4 when
    only the CPU matvec's precision changes), so there the difference is
    reported beside the iterations."""
    import numpy as np

    distill = DistillConfig(proxy_size=1024, solver="cg", proxy="validation")
    out = {}
    for name, fields in POP_PARITY.items():
        base = {**POP_PARITY_COMMON, **fields, "distill": distill}
        runs, seconds, cg = {}, {}, {}
        for label, engine, dev, extra in (
                ("bucketed_cuda", "bucketed", "cuda", {}),
                ("streamed_cuda", "streamed", "cuda", {"chunk_devices": POP_PARITY_CHUNK}),
                ("bucketed_cpu", "bucketed", "cpu", {})):
            tracer = trace.Tracer()
            t0 = time.perf_counter()
            with trace.use_tracer(tracer):
                runs[label] = sim.run_population(
                    sim.PopulationConfig(engine=engine, **base, **extra), device=dev)
            seconds[label] = time.perf_counter() - t0
            cg[label] = [ev["args"]["iterations"] for ev in tracer.events
                         if ev["name"] == "distill.cg"]
        card, strm, cpu = runs["bucketed_cuda"], runs["streamed_cuda"], runs["bucketed_cpu"]
        a, b = population_fields(strm), population_fields(card)
        unequal = sorted(k for k in a if a[k] != b[k])
        converged = all(it < distill.maxiter for its in cg.values() for it in its)
        diff = float(np.abs(population_aucs(card, converged)
                            - population_aucs(cpu, converged)).max())
        student_diff = float(np.abs(population_aucs(card) - population_aucs(cpu)).max())
        ids_equal = upload_ids(card) == upload_ids(cpu)
        budget = fields.get("budget_bytes")
        k50 = {tag: sum(1 for t, _ in upload_ids(card) if t == tag)
               for tag in sorted({t for t, _ in upload_ids(card)}) if tag.endswith("_k50")}
        out[name] = {
            "seconds": seconds, "n_available": card.n_available, "n_eligible": card.n_eligible,
            "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                             for s, d in card.ensemble_auc.items()},
            "student_supports": len(card.student.coef), "student_codec": card.student_codec,
            "streamed_equals_bucketed": not unequal, "unequal_fields": unequal,
            "cg_iterations": cg, "cg_converged": converged,
            "cuda_vs_cpu": {"comm_equal": card.comm == cpu.comm, "ids_equal": ids_equal,
                            "headcounts_equal": (card.n_available, card.n_eligible)
                            == (cpu.n_available, cpu.n_eligible),
                            "max_auc_diff_held": diff,
                            "max_auc_diff_with_student": student_diff},
            "budget_bytes": budget, "k50_uploads": k50,
        }
        if unequal:
            raise AssertionError(f"population parity [{name}]: streamed differs from bucketed "
                                 f"on cuda in {unequal}")
        if not (card.comm == cpu.comm and ids_equal and card.n_eligible == cpu.n_eligible
                and card.n_available == cpu.n_available):
            raise AssertionError(f"population parity [{name}]: cuda and cpu differ in comm, "
                                 "picked ids or headcounts")
        if not diff <= AUC_TOL:
            raise AssertionError(f"population parity [{name}]: cuda and cpu AUCs differ by "
                                 f"{diff} > {AUC_TOL}")
        if budget is not None and not (k50 and min(k50.values()) < 50):
            raise AssertionError(f"population parity [{name}]: the budget of {budget} bytes "
                                 f"does not bind at k 50 ({k50})")
    return out


def population_memory(sim, device, n_devices, chunk):
    """(c): the peak traced host memory (``tracemalloc``) of the streamed
    pass alone (``iter_population(mode="streamed")``) on ``POP_SCALE``'s
    dirichlet population of ``n_devices``, beside the card's peak
    allocated bytes and the pass's seconds."""
    import tracemalloc

    import torch

    cfg = POP_SCALE
    stream = sim.device_stream(cfg["scenario"], n_devices=n_devices, seed=cfg["seed"],
                               mean_samples=cfg["mean_samples"], dim=cfg["dim"],
                               **cfg["scenario_params"])
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tracemalloc.start()
    count = 0
    for update in sim.iter_population(stream, mode="streamed", seed=cfg["seed"],
                                      chunk_devices=chunk, device=device):
        count += len(update.outcomes)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    torch.cuda.synchronize()
    if count != n_devices:
        raise AssertionError(f"population memory: {count} outcomes for {n_devices} devices")
    return {"devices": n_devices, "host_peak_bytes": peak,
            "card_peak_allocated_bytes": torch.cuda.max_memory_allocated(device),
            "seconds": time.perf_counter() - t0}


def phase_population(ops, trace, DistillConfig, device, memory_devices=POP_MEMORY_DEVICES):
    """(a) parity, (b) the 100,000-device streamed dirichlet round at full
    width (d 16) on cuda with CG distillation on 4,096 ``scenario`` proxy
    rows, then once more under the profiler, (c) the streamed pass's
    traced host memory at ``memory_devices``."""
    import numpy as np
    import torch

    from repro_torch import sim

    out = {"parity": population_parity(sim, trace, DistillConfig)}

    cfg = sim.PopulationConfig(**POP_SCALE, distill=DistillConfig(
        proxy_size=4096, solver="cg", proxy="scenario"))
    tracer = trace.Tracer()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        rep = sim.run_population(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    spans = tracer.span_seconds()
    chunks = sum(1 for ev in tracer.events if ev["name"] == "engine.chunk" and ev["ph"] == "B")
    groups = sum(1 for ev in tracer.events if ev["name"] == "engine.group" and ev["ph"] == "B")
    cg = [ev["args"]["iterations"] for ev in tracer.events if ev["name"] == "distill.cg"]
    aucs = population_aucs(rep)
    scale = {
        "config": {k: v for k, v in POP_SCALE.items()}, "distill": "cg, 4096 scenario rows",
        "wall_seconds": wall, "train_seconds": rep.train_seconds,
        "devices_per_second": cfg.n_devices / wall,
        "trained_devices_per_second": rep.devices_per_second,
        "spans": {k: v for k, v in sorted(spans.items())
                  if k.startswith(("round.", "distill.round"))},
        "engine_chunks": chunks, "engine_groups": groups, "cg_iterations": cg,
        "n_available": rep.n_available, "n_eligible": rep.n_eligible,
        "mean_local_auc": rep.mean_local_auc, "mean_val_auc": rep.mean_val_auc,
        "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                         for s, d in rep.ensemble_auc.items()},
        "comm": rep.comm, "student_supports": len(rep.student.coef),
        "card_peak_allocated_bytes": torch.cuda.max_memory_allocated(device),
        "kernels": counts,
    }
    want_chunks = -(-cfg.n_devices // cfg.chunk_devices)
    if chunks != want_chunks:
        raise AssertionError(f"population: {chunks} engine.chunk spans, want {want_chunks}")
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError("population: AUCs not finite or outside [0, 1]")
    if rep.n_available != cfg.n_devices or not 0 < rep.n_eligible <= rep.n_available:
        raise AssertionError(f"population: {rep.n_available} available and "
                             f"{rep.n_eligible} eligible of {cfg.n_devices}")
    cells = {s: sorted(v) for s, v in rep.ensemble_auc.items()}
    if any(cells.get(s) != sorted(cfg.ks) for s in cfg.strategies) or "distilled" not in cells:
        raise AssertionError(f"population: ensemble cells {cells}")
    missing = [k for k in POP_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"population: kernels never launched on the path: {missing}")
    if sum(cg) != counts["gram_matvec"]:
        raise AssertionError(f"population: gram_matvec launched {counts['gram_matvec']} "
                             f"times for {sum(cg)} CG iterations")
    scale["profile"], _ = profile_call(lambda: sim.run_population(cfg, device="cuda"))
    out["scale"] = scale

    memory = [population_memory(sim, device, n, POP_SCALE["chunk_devices"])
              for n in memory_devices]
    small, large = (m["host_peak_bytes"] for m in memory)
    out["memory"] = {"runs": memory, "budget_bytes": POP_MEMORY_BUDGET,
                     "flat": large < max(1.5 * small, small + 8 * 2**20)}
    if not large < POP_MEMORY_BUDGET:
        raise AssertionError(f"population memory: peak {large} bytes over the "
                             f"{POP_MEMORY_BUDGET}-byte budget")
    if not out["memory"]["flat"]:
        raise AssertionError(f"population memory: the peak grew with the population: "
                             f"{small} -> {large} bytes")
    out["kernels"] = counts
    return out


# the agg phase: the aggregator zoo at full width (``main``'s setting; mean
# is ``main`` itself), the streamed population round with ``reweight``, and
# parity (``agg_bench.py``'s full sweep on cuda and cpu, then streamed =
# bucketed at 2,048 int8 devices for every aggregator)
AGG_FP32 = ("fisher", "reweight", "feature_stats")
AGG_PROFILED = "fisher"
AGG_Q8 = "reweight:10"
AGG_ALL = ("mean", "fisher", "reweight", "feature_stats")
AGG_BENCH = dict(scenarios=("iid", "dirichlet", "quantity_skew"), codecs=("fp32", "fp16", "int8"),
                 n_devices=48, mean_samples=60, ks=(5,), seed=3)   # agg_bench.py's FULL sweep
AGG_TIERS = dict(POP_PARITY_COMMON, scenario="dirichlet", codec="int8")
PEGASOS = dict(rows=128, d=32, epochs=5, seed=0)


def agg_round(run_protocol, ds, ops, trace, must_launch, **kw):
    """One full-width emnist round on cuda with an aggregator (``kw``):
    wall seconds, ``round.*`` spans, the extras' and uploads' bytes and
    each kernel's launches in that round."""
    import numpy as np
    import torch

    tracer = trace.Tracer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        res = run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    summary = res.ledger.summary()
    spans = tracer.span_seconds()
    out = {"aggregator": res.aggregator, "codec": res.codec, "round_seconds": wall,
           "spans": {k: v for k, v in sorted(spans.items())
                     if k.startswith(("round.", "distill.round"))},
           "best": res.best, "full_ensemble_auc": res.full_ensemble_auc,
           "total_agg_extra": summary["total_agg_extra"], "total_up": summary["total_up"],
           "server_scorer": type(res.server_scorer).__name__, "kernels": counts}
    aucs = auc_values(res)
    label = f"agg [{res.aggregator}, {res.codec}]"
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError(f"{label}: AUCs not finite or outside [0, 1]")
    if not summary["total_agg_extra"] > 0:
        raise AssertionError(f"{label}: no aggregator extra on the ledger")
    missing = [k for k in must_launch if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
    if res.student is not None:
        cg = [ev["args"]["iterations"] for ev in tracer.events if ev["name"] == "distill.cg"]
        out["student"] = {"codec": res.student_codec, "type": type(res.student).__name__,
                          "supports": len(res.student.coef), "cg_iterations": cg,
                          "distilled_auc": res.ensemble_auc["distilled"]}
        if sum(cg) != counts["gram_matvec"]:
            raise AssertionError(f"{label}: gram_matvec launched {counts['gram_matvec']} "
                                 f"times for {sum(cg)} CG iterations")
    return out


def train_selected_groups(tracer):
    """``engine.group`` spans outside every ``engine.chunk`` span: the
    groups ``train_selected`` trained after the streamed pass."""
    depth, groups = 0, 0
    for ev in tracer.events:
        if ev["name"] == "engine.chunk":
            depth += 1 if ev["ph"] == "B" else -1
        elif ev["name"] == "engine.group" and ev["ph"] == "B" and depth == 0:
            groups += 1
    return groups


def agg_population(sim, ops, trace, DistillConfig, device):
    """(b): ``population``'s streamed round (100,000 dirichlet devices, CG
    distillation on 4,096 ``scenario`` rows) with ``reweight``."""
    import numpy as np
    import torch

    cfg = sim.PopulationConfig(**POP_SCALE, aggregator="reweight",
                               distill=DistillConfig(proxy_size=4096, solver="cg",
                                                     proxy="scenario"))
    tracer = trace.Tracer()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        rep = sim.run_population(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    aucs = population_aucs(rep)
    out = {"devices": cfg.n_devices, "aggregator": rep.aggregator, "wall_seconds": wall,
           "devices_per_second": cfg.n_devices / wall,
           "spans": {k: v for k, v in sorted(tracer.span_seconds().items())
                     if k.startswith(("round.", "distill.round"))},
           "train_selected_groups": train_selected_groups(tracer),
           "total_agg_extra": rep.comm["total_agg_extra"], "total_up": rep.comm["total_up"],
           "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                            for s, d in rep.ensemble_auc.items()},
           "card_peak_allocated_bytes": torch.cuda.max_memory_allocated(device),
           "kernels": counts}
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError("agg population: AUCs not finite or outside [0, 1]")
    if not rep.comm["total_agg_extra"] > 0 or rep.aggregator != "reweight":
        raise AssertionError(f"agg population: {rep.aggregator} round with "
                             f"{rep.comm['total_agg_extra']} extra bytes")
    missing = [k for k in POP_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"agg population: kernels never launched on the path: {missing}")
    return out


def agg_parity(sim):
    """(c): ``agg_bench.py``'s full sweep (3 scenarios x 3 codecs x 4
    aggregators, cv, k 5, bucketed) on cuda and on cpu: ledgers and picked
    ids equal, AUCs within AUC_TOL; then, for each aggregator, the streamed
    round (chunks of ``POP_PARITY_CHUNK``) equal to the bucketed round in
    every report field on cuda at 2,048 int8 dirichlet devices."""
    import numpy as np

    b = AGG_BENCH
    cells, worst, t0 = 0, 0.0, time.perf_counter()
    for scenario in b["scenarios"]:
        fed = sim.make_federation(scenario, n_devices=b["n_devices"], seed=b["seed"],
                                  mean_samples=b["mean_samples"], min_samples=40)
        for codec in b["codecs"]:
            for name in AGG_ALL:
                reps = {dev: sim.run_population(sim.PopulationConfig(
                    scenario=scenario, n_devices=b["n_devices"], seed=b["seed"],
                    mean_samples=b["mean_samples"], min_samples=40, engine="bucketed",
                    codec=codec, ks=b["ks"], strategies=("cv",), aggregator=name),
                    federation=fed, device=dev) for dev in ("cuda", "cpu")}
                card, cpu = reps["cuda"], reps["cpu"]
                diff = float(np.abs(population_aucs(card) - population_aucs(cpu)).max())
                worst = max(worst, diff)
                cells += 1
                label = f"agg parity [{scenario}, {codec}, {name}]"
                if card.comm != cpu.comm or upload_ids(card) != upload_ids(cpu):
                    raise AssertionError(f"{label}: cuda and cpu differ in ledger or ids")
                if (name != "mean") != (card.comm["total_agg_extra"] > 0):
                    raise AssertionError(f"{label}: {card.comm['total_agg_extra']} extra bytes")
                if not diff <= AUC_TOL:
                    raise AssertionError(f"{label}: cuda and cpu AUCs differ by {diff}")
    out = {"bench_cells": cells, "bench_max_auc_diff": worst,
           "bench_seconds": time.perf_counter() - t0, "tiers": {}}
    for name in AGG_ALL:
        t0 = time.perf_counter()
        reps = {engine: sim.run_population(sim.PopulationConfig(
            engine=engine, aggregator=name, chunk_devices=POP_PARITY_CHUNK, **AGG_TIERS),
            device="cuda") for engine in ("bucketed", "streamed")}
        a, c = population_fields(reps["streamed"]), population_fields(reps["bucketed"])
        unequal = sorted(k for k in a if a[k] != c[k])
        out["tiers"][name] = {"streamed_equals_bucketed": not unequal,
                              "total_agg_extra": reps["bucketed"].comm["total_agg_extra"],
                              "seconds": time.perf_counter() - t0}
        if unequal:
            raise AssertionError(f"agg tiers [{name}]: streamed differs from bucketed on "
                                 f"cuda in {unequal}")
    return out


def agg_baselines(make_cohort_dataset, device):
    """The one-shot baselines on the card: the Pegasos fit (``PEGASOS``)
    timed on cuda (host clock to a synchronise, warm) and held to its cpu
    fit within 1e-5; cohort labels from card-scored embeddings equal to
    the cpu's."""
    import numpy as np
    import torch

    from repro_torch.core import cohorts
    from repro_torch.core.averaging import train_linear_svm
    from repro_torch.sim.engine import train_population

    p = PEGASOS
    rng = np.random.default_rng(p["seed"])
    x = rng.normal(size=(p["rows"], p["d"])).astype(np.float32)
    y = np.where(x[:, 0] + 0.5 * rng.normal(size=p["rows"]) > 0, 1.0, -1.0).astype(np.float32)
    fit = lambda dev: train_linear_svm(x, y, epochs=p["epochs"], seed=p["seed"], device=dev)
    fit("cuda")
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        card = fit("cuda")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    cpu = fit("cpu")
    w_diff = float(np.abs(card.w - cpu.w).max())
    b_diff = abs(card.b - cpu.b)
    out = {"pegasos": {**p, "steps": p["epochs"] * p["rows"], "ms": 1e3 * float(np.median(secs)),
                       "ms_runs": [1e3 * s for s in secs], "max_w_diff_cuda_cpu": w_diff,
                       "b_diff_cuda_cpu": b_diff}}
    if not (w_diff <= 1e-5 and b_diff <= 1e-5):
        raise AssertionError(f"agg: the Pegasos fit differs on cuda and cpu by {w_diff} (w), "
                             f"{b_diff} (b)")
    ds = make_cohort_dataset(seed=0)
    probe = np.random.default_rng(1).normal(size=(64, ds.dim)).astype(np.float32)
    labels = {}
    for dev in ("cuda", "cpu"):
        outcomes = train_population(ds, seed=0, device=dev).outcomes
        labels[dev] = cohorts.run_cohort_protocol(outcomes, 3, probe, seed=0)
    out["cohorts"] = {dev: {"cohort_auc": r.cohort_auc, "global_auc": r.global_auc}
                      for dev, r in labels.items()}
    if not np.array_equal(labels["cuda"].labels, labels["cpu"].labels):
        raise AssertionError("agg: cohort labels differ on cuda and cpu")
    return out


def phase_agg(make_dataset, run_protocol, ops, trace, DistillConfig, device):
    """(a) the emnist round at full width with each non-mean aggregator in
    fp32 (one of them once more under the profiler) and with ``reweight:10``
    in int8 with CG distillation; (b) the streamed population round with
    ``reweight``; (c) parity; then the baselines."""
    from repro_torch import sim
    from repro_torch.data import make_cohort_dataset

    t0 = time.perf_counter()
    ds = make_dataset("emnist", seed=0, scale=1.0)
    out = {"dataset": "emnist", "scale": 1.0, "devices": ds.n_devices,
           "generate_seconds": time.perf_counter() - t0, "rounds": []}
    for name in AGG_FP32:
        out["rounds"].append(agg_round(run_protocol, ds, ops, trace, FP32_KERNELS,
                                       aggregator=name))
    out["profile"], _ = profile_call(lambda: run_protocol(
        ds, ks=MAIN_KS, random_trials=3, device="cuda", aggregator=AGG_PROFILED))
    out["profile"]["aggregator"] = AGG_PROFILED
    out["rounds"].append(agg_round(
        run_protocol, ds, ops, trace, FP32_KERNELS + Q8_KERNELS, aggregator=AGG_Q8,
        codec="int8", distill=DistillConfig(proxy_size=4096, solver="cg")))
    out["population"] = agg_population(sim, ops, trace, DistillConfig, device)
    out["parity"] = agg_parity(sim)
    out.update(agg_baselines(make_cohort_dataset, device))
    out["kernels"] = out["rounds"][-1]["kernels"]
    return out


IDEAL_ROWS = 2000   # run_protocol's ideal_cap: the ideal's Gram is 2,000 x 2,000


def gram_round(ops, ds, by_function, counts):
    """Rows 1 and 3 in the profiled round: their launches (and the
    measured round's), device seconds, and the bound of those launches:
    ``batched_rbf_gram``'s from the round's own launch shapes
    (``ops.round_gram_launches``: fits with x2 = x1, val and test scores),
    ``rbf_gram``'s the ideal's one 2,000 x 2,000 x d Gram (x2 = x1)."""
    shapes = ops.round_gram_launches(ds)
    d = shapes[0][4]
    bounds = {
        "batched_rbf_gram": sum(bound_ms(*gram_work(g, m, n, d_, same=kind == "fit"))[0]
                                for kind, g, m, n, d_ in shapes),
        "rbf_gram": bound_ms(*gram_work(1, IDEAL_ROWS, IDEAL_ROWS, d, same=True,
                                        gammas=False))[0],
    }
    out = {}
    for name, prof in by_function.items():
        out[name] = {"launches": counts[name], "profiled_launches": prof["count"],
                     "device_ms": 1e3 * prof["seconds"], "bound_ms": bounds[name]}
    out["batched_rbf_gram"]["shapes"] = len({sh[1:] for sh in shapes})
    if out["batched_rbf_gram"]["launches"] != len(shapes):
        raise AssertionError(f"main: batched_rbf_gram launched "
                             f"{out['batched_rbf_gram']['launches']} times, the round's "
                             f"groups give {len(shapes)}")
    return out


# the device functions of a kernel wrapper, as the profiler names them
# (rows 1 and 3 run one tile body as two kernels, so a profile tells them apart)
DEVICE_FUNCTIONS = {"batched_rbf_gram": "batched_rbf_gram_kernel", "rbf_gram": "rbf_gram_kernel"}


def profile_call(fn, top=20, functions=()):
    """``fn()`` under ``torch.profiler``: the device's busy seconds (the
    sum of every kernel and copy on the card; one stream, so they do not
    overlap) against the call's wall seconds, and the device time by
    kernel; with ``functions`` (names of ``DEVICE_FUNCTIONS``), each one's
    launches and device seconds, summed over its instantiations. The
    profiler slows the host, so this wall is longer than an unprofiled
    one's; the busy share is that of the profiled call."""
    import re

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
    if functions:
        out["by_function"] = {}
        for name in functions:
            own = [e for e in on_card
                   if re.search(rf"(?<!\w){DEVICE_FUNCTIONS[name]}\b", e.key)]
            out["by_function"][name] = {
                "count": sum(e.count for e in own),
                "seconds": sum(e.self_device_time_total for e in own) / 1e6}
    return out, result


DEVICE_CALLS = 20   # at least this many calls in a device-time window
DEVICE_WINDOWS = 3  # windows tried before a call counts as recorded by no kernel


def device_time(fn, args, reps):
    """At least ``reps`` back-to-back calls of ``fn(*args)`` (warm) under
    the profiler, read as ``profile_call`` reads it: (device ms a call,
    the kernels' launches the profiler recorded, their names). Nothing else
    runs on the card in the window; each kernel's device time over its own
    count, summed over the call's kernels, is the call's device time (the
    profiler does not record the window's first few launches, so the
    calls made are no divisor)."""
    calls = max(reps, DEVICE_CALLS)
    windows = []
    for _ in range(DEVICE_WINDOWS):   # a window the profiler missed whole: 4x longer
        prof, _ = profile_call(lambda: [fn(*args) for _ in range(calls)], top=8)
        kernels = prof["by_kernel"]
        windows.append(calls)
        if kernels:
            break
        calls *= 4
    else:
        raise AssertionError(f"timing: the profiler recorded no kernel in windows of "
                             f"{windows} calls")
    ms = 1e3 * sum(k["seconds"] / k["count"] for k in kernels)
    return ms, sum(k["count"] for k in kernels), sorted(k["name"] for k in kernels), windows


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
    each turn a run of back-to-back calls (L2 warm) sized to ~budget_ms
    from one call made after a warm-up call; with ``library``, its two
    turns go between the kernel's (plain, kernel, library, library,
    kernel, plain)."""
    import torch

    fns = {"plain": plain, "kernel": kernel}
    order = ["plain", "kernel", "kernel", "plain"]
    if library is not None:
        fns["library"] = library
        order[2:2] = ["library", "library"]
    reps = {}
    for label, fn in fns.items():
        fn(*args)                                # warm-up: a first call pays set-up
        torch.cuda.synchronize()
        once = _time_ms(lambda: fn(*args), 1)   # then size the run
        reps[label] = max(1, min(200, int(budget_ms / max(once, 1e-3))))
    turns = {label: [] for label in fns}
    for label in order:
        turns[label].append(_time_ms(lambda: fns[label](*args), reps[label]))
    return turns, reps


def fill_ms(like, budget_ms=20.0):
    """One ``fill_`` of a tensor shaped as the kernel's output: the card's
    own rate of writing those bytes, a floor for a byte-bound kernel whose
    output is its traffic. Warm, back-to-back, CUDA events."""
    import torch

    t = torch.empty_like(like)
    t.fill_(0.5)
    torch.cuda.synchronize()
    once = _time_ms(lambda: t.fill_(0.5), 1)
    return _time_ms(lambda: t.fill_(0.5), max(1, min(200, int(budget_ms / max(once, 1e-3)))))


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
    "batched_rbf_gram": ("fit g256 b64", "fit g256 b128", "fit g128 b256", "score g256 q16 b64",
                         "score g256 q56 b64", "score g128 q184 b256",
                         "fit dirichlet g256 b64 d16"),
    "rbf_gram": ("ideal 2000x2000x32",),
    "ensemble_score": ("full b8192 k2821 n230", "k100 b8192 n230",
                       "ideal predict b8192 k1 n2000", "population b4096 k50 n40 d16"),
    "sdca": ("ideal g1 b2048 n2000", "ideal emnist g1 b2048 n2000", "group g256 b64",
             "group g128 b256", "group dirichlet g256 b64"),
    "gram_matvec": ("cg l4096 d32", "cg emnist l4096 d32", "cg l4096 d16"),
    "rbf_gram_q8": ("student predict b8192 n4096 d32", "student emnist b8192 n4096 d32"),
    "ensemble_score_q8": ("full b8192 k2821 n230", "k100 b8192 n230"),
    "flash_attention": ("serve b4 s2048 h32 k8 hd64 causal bfloat16",
                        "serve b4 s2048 h32 k8 hd64 causal float32"),
}
LIBRARY = {"flash_attention": sdpa_library}


def phase_timing(ops, device, rng, names):
    import torch

    cases = {name: dict(c) for name, c in kernel_cases(rng, ops).items()}
    rows = []
    for name, labels in TIMING_CASES.items():
        if name not in names:
            continue
        spec = ops.KERNEL_REGISTRY[name]
        for label in labels:
            args = case_args(cases[name][label])
            targs = to_device(args, device)
            library = LIBRARY.get(name)
            turns, reps = time_pair(spec.kernel, spec.plain, targs, library=library)
            try:
                dev_ms, dev_launches, dev_names, windows = device_time(spec.kernel, targs,
                                                                       reps["kernel"])
            except AssertionError as e:
                raise AssertionError(f"{name} [{label}]: {e}") from e
            bound_ms, bound_by = bound_of(name, args)
            ops_n, bytes_n = work_of(name, args)
            row = {
                "kernel": name, "case": label,
                "ms": sum(turns["kernel"]) / 2, "device_ms": dev_ms,
                "device_launches_recorded": dev_launches, "device_kernels": dev_names,
                "device_windows": windows,
                "plain_ms": sum(turns["plain"]) / 2,
                "library_ms": sum(turns["library"]) / 2 if library else None,
                "turns": turns, "reps": reps, "bound_ms": bound_ms,
                "bound_by": bound_by, "ops": ops_n, "bytes": bytes_n,
                "fill_ms": fill_ms(spec.kernel(*targs)),
            }
            if library:   # how far the yardstick's own answer is from the plain version's
                row["library_max_abs_err"] = float(
                    (library(*targs).float() - spec.plain(*targs).float()).abs().max())
            if name == "sdca":   # the longest chain of dependent steps in the call
                row["steps"] = int(args[4] * min(int(args[2].max()), args[0].shape[1]))
                row["ns_per_step"] = 1e6 * row["ms"] / row["steps"]
            rows.append(row)
            del targs
            torch.cuda.empty_cache()
    if "sdca" not in names:
        return {"rows": rows}
    step_ns = sdca_step_ns(ops, device, rng)
    for row in rows:
        if row["kernel"] == "sdca":
            row["chain_ms"] = 1e-6 * row["steps"] * step_ns
    return {"rows": rows, "sdca_step_ns": step_ns}


def sdca_step_ns(ops, device, rng, epochs=1250):
    """One SDCA step's latency on the card: the kernel on a single 32-row
    tile (so the look-ahead matvec has 32 x 32 products to hide) for
    40,000 steps, warm, over the step count. The chain figure beside the
    bytes bound is a case's steps times this."""
    args = ops.make_sdca_problem(rng, g=1, b=32, d=32, n_real=[32], epochs=epochs)
    targs = to_device(args, device)
    kernel = ops.KERNEL_REGISTRY["sdca"].kernel
    kernel(*targs)
    ms = min(_time_ms(lambda: kernel(*targs), 5) for _ in range(3))
    return 1e6 * ms / (epochs * 32)


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels for the kernels and timing phases "
                         "(default: all)")
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

    names = [k for k in args.kernels.split(",") if k] or list(ops.KERNEL_REGISTRY)
    unknown = sorted(set(names) - set(ops.KERNEL_REGISTRY))
    if unknown:
        ap.error(f"unknown kernels {unknown}")
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
                out, errs = phase_kernels(ops, device, np.random.default_rng(0), names)
            elif phase == "parity":
                out = phase_parity(make_dataset, run_protocol, DistillConfig)
            elif phase == "main":
                out = phase_main(make_dataset, run_protocol, ops, trace, FP32_KERNELS, gram=True)
                counts[phase] = out["kernels"]
            elif phase == "main_q8":
                out = phase_main(make_dataset, run_protocol, ops, trace,
                                 FP32_KERNELS + Q8_KERNELS, codec="int8",
                                 distill=DistillConfig(proxy_size=4096, solver="cg"))
                counts[phase] = out["kernels"]
            elif phase == "population":
                out = phase_population(ops, trace, DistillConfig, device)
                counts[phase] = out["kernels"]
            elif phase == "agg":
                out = phase_agg(make_dataset, run_protocol, ops, trace, DistillConfig, device)
                counts[phase] = out["kernels"]
            elif phase == "lm_parity":
                out = phase_lm_parity(ops, device)
            elif phase == "serve":
                out = phase_serve(ops, device)
                counts[phase] = out["kernels"]
            else:
                out = phase_timing(ops, device, np.random.default_rng(0), names)
                timing = {r["kernel"]: r for r in reversed(out["rows"])}
        except Exception as e:
            emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
            raise
        out = {"phase": phase, "ok": True, "phase_seconds": time.perf_counter() - t0, **out}
        detail[phase] = out
        if phase == "timing":   # the turns and counts go to --out only
            keep = ("kernel", "case", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "fill_ms", "ns_per_step", "chain_ms")
            out = {**out, "rows": [{k: r[k] for k in keep if k in r} for r in out["rows"]]}
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
            "max_abs_err": errs.get(name), "ms": row.get("ms"), "device_ms": row.get("device_ms"),
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
