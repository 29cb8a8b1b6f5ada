#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports the port and nothing of JAX or of the reference package
``repro``, and runs thirteen phases, each printing one JSON line on stdout:

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
           and feature dims 12, 24, 32 and 37, and at the fleet's d 8 (k 4,
           n 40 at b 8, 32 and 256); SDCA at the group shapes, on
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
           Gram's rows and the engine's ``_score_group``); and both
           scorers' rows 0-7 bitwise equal in calls of 8, 32 and 256 rows
           (the fleet's buckets and ``ServeConfig()``'s largest) at d 8
           and d 32;
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
  train    the LM train step (``models.make_train_step``, ``launch/train.py``;
           no hand-written kernel runs in it: none has a backward, as no
           Pallas kernel of the reference has one): (a) llama3.2-1b at full
           width cut to 2 layers, fp32, the same parameters (drawn on the
           cpu) 3 steps of ``make_optimizer(1e-3)`` at batch 2, seq 64 on
           cuda and on cpu: losses within 1e-4 (step 1) and 1e-3 relative;
           (b) the full 16-layer bf16 llama3.2-1b through
           ``launch.train.main`` on cuda, 8 steps at batch 4, seq 1,024, lr
           3e-4: s/step over steps 2-8 (``train.step`` spans), tokens/s,
           peak memory, every loss finite, no kernel launched; the same
           steps again from the same parameters: step 1's batch's loss
           lower after them than before; a step's forward + backward and
           optimizer seconds apart (CUDA events); one more step under the
           profiler (busy share, GEMM seconds),
           the roofline share against ``roofline_report`` on ``H100_SXM``
           (6 N T + attention FLOPs); and a ``use_pallas`` step, which must
           raise and leave the parameters as they were;
  fleet    the SVM serving path and the multi-tenant fleet
           (``repro_torch.serve``, ``repro_torch.fleet``): (1) the emnist
           round's fp32 ``server_scorer`` and ``main_q8``'s int8 student
           (those phases' rounds, or the rounds run here when they did not
           run) each deployed through ``serve_round_artifact``'s path
           (encode, ``save_payload``, ``register_wire``, ``ServeFleet.run``
           with ``keep_results``): conserved, ``ensemble_score`` (fp32) or
           ``ensemble_score_q8`` (int8) launched once per scheduler batch,
           each kept result bitwise a direct cuda score of its row and
           within AUC_TOL of the cpu plain scorer; (2)
           ``benchmarks/serve_load_bench.py``'s full sweep and determinism
           replay and (3) its trace baseline, rebuilt with the scorers on
           cuda: byte for byte ``benchmarks/serve_load_bench.json`` and
           ``benchmarks/fleet_trace_baseline.json``, one ``ensemble_score``
           launch per scheduler batch; (4) ``benchmarks/serve_bench.py``'s
           comparisons on the card (fused ``predict`` against
           ``predict_padded`` at k 8 and 32, scheduler batch 256 against
           batch 1, repeat traffic through the LRU) and the round's server
           scorer through ``MicroBatchScheduler`` at ``ServeConfig()``'s
           defaults on 4,096 requests: host seconds, requests/s, device ms;
  timing   each kernel and its plain version, in turns (plain, kernel,
           kernel, plain) with CUDA events (``ms``; for a kernel of a few
           microseconds mostly the wrapper's host time), and the kernel's
           own device time a call from ``torch.profiler`` over a run of
           back-to-back calls (``device_ms``), at main-path shapes
           (``batched_rbf_gram`` at six of the round's 15), beside a
           ``fill_`` of the output (the card's own write rate) and the
           analytic bound from the port's ``obs.profile.kernel_bound``: the
           larger of operations over the card's peak for the inputs' type
           (``roofline.H100_SXM_FP32``, 67 TFLOP/s fp32 outside the tensor
           cores; ``H100_SXM``, 989 TFLOP/s bf16 dense) and bytes (each
           input read once, each output written once) over 3.35 TB/s, the
           H100 SXM's published peaks; flash attention also beside
           ``library_ms``, one call of
           ``torch.nn.functional.scaled_dot_product_attention`` on the same
           tensors (a yardstick only: the port never calls it). SDCA's
           rows also give ns a step and a chain figure: the steps of the
           longest solve times one step's latency, from the kernel on a
           single 32-row tile;
  profile  the kernel spans (``obs.profile.maybe_profile``): every timing
           case once more through its dispatcher under a tracer, the
           traced result bitwise the untraced one, each span's flops and
           bytes > 0, 0 < ``roofline_frac`` <= 1.05 and
           ``roofline_bound_us`` the ``timing`` row's bound; then ``main``'s
           round under a tracer: its ``kernel.<name>`` spans one per launch.

The last three lines are the per-kernel summary ``{"kernels": [...]}``
(each kernel's launches read from the run it was ported for: ``main``
for the four fp32 kernels, ``main_q8`` for the three int8/CG ones,
``serve`` for flash attention, named in ``launches_path``, each
kernel's launches in the ``fleet`` phase's runs (1)-(3) as
``launches_fleet`` and in ``train`` (b)'s steps as ``launches_train``;
the ``population`` line carries its own counts), the card's
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
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "main", "main_q8", "population", "agg", "lm_parity",
          "serve", "train", "fleet", "timing", "profile")
AUC_TOL = 1e-4                    # the reference's engine-tier tolerance
MAIN_KS = (1, 10, 50, 100)        # fig1_mean_auc.py's ks at emnist scale
FLEET_BUCKETS = (8, 32, 256)      # the fleet's two buckets and ServeConfig()'s largest
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

    def ens(b, k, n_max, d, r=rng):
        x = r.normal(size=(b, d)).astype(np.float32)
        sup = r.normal(size=(k, n_max, d)).astype(np.float32)
        # trained models' scale: coef = alpha * y / (lam * n), alpha in [0, 1]
        sign = np.where(r.random((k, n_max)) < 0.5, -1.0, 1.0)
        coef = (r.random((k, n_max)) * sign / (0.01 * n_max)).astype(np.float32)
        gam = (1.0 / (d * r.uniform(0.5, 2.0, size=k))).astype(np.float32)
        return x, sup, coef, gam

    def ens_q8(b, k, n_max, d, r=rng):
        x, sup, coef, gam = ens(b, k, n_max, d, r)
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
    # the fleet's shapes (serve_load_bench.py's tenants: k 4, 40 supports,
    # d 8) at its buckets 8 and 32 and ServeConfig's 256, from their own
    # generator so the cases above keep their data
    fleet_rng = np.random.default_rng(8)
    for b in FLEET_BUCKETS:
        cases["ensemble_score"].append((f"fleet d8 b{b} k4 n40", ens(b, 4, 40, 8, fleet_rng)))
        cases["ensemble_score_q8"].append((f"fleet d8 b{b} k4 n40",
                                           ens_q8(b, 4, 40, 8, fleet_rng)))
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
    # a query's bits whatever bucket the scheduler pads it into (the fleet
    # scores a row in bucket 8 or 32, ServeConfig's default serves 256)
    for name in ("ensemble_score", "ensemble_score_q8"):
        if name not in cases:
            continue
        kernel, checks = ops.KERNEL_REGISTRY[name].kernel, out.setdefault(name, {})
        for label in (f"fleet d8 b{FLEET_BUCKETS[-1]} k4 n40", "k100 b8192 n230"):
            args = to_device(dict(cases[name])[label], device)
            calls = [kernel(args[0][:b].contiguous(), *args[1:]) for b in FLEET_BUCKETS]
            checks[f"rows_0-7_equal_in_buckets_{'_'.join(map(str, FLEET_BUCKETS))} "
                   f"[{label}]"] = all(torch.equal(calls[0], c[:8]) for c in calls[1:])
            del args, calls
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
    return out, res


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
    measured round's), device seconds, and the bound of those launches
    (``obs.profile.kernel_bound``, priced on shape-only ``meta`` tensors):
    ``batched_rbf_gram``'s from the round's own launch shapes
    (``ops.round_gram_launches``: fits with x2 = x1, val and test scores),
    ``rbf_gram``'s the ideal's one 2,000 x 2,000 x d Gram (x2 = x1)."""
    import torch

    from repro_torch.obs.profile import kernel_bound

    def meta(*shape):
        return torch.empty(shape, device="meta")

    def launch_args(kind, g, m, n, d):
        x1 = meta(g, m, d)
        return x1, x1 if kind == "fit" else meta(g, n, d), meta(g)

    shapes = ops.round_gram_launches(ds)
    ideal = meta(IDEAL_ROWS, shapes[0][4])
    bounds = {
        "batched_rbf_gram": sum(1e3 * kernel_bound("batched_rbf_gram", launch_args(*sh))[0]
                                for sh in shapes),
        "rbf_gram": 1e3 * kernel_bound("rbf_gram", (ideal, ideal, 1.0))[0],
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


# the train phase: the LM train step (``models.make_train_step``,
# ``launch/train.py``); no hand-written kernel runs in it, as none has a
# backward (the reference trains with ``use_pallas=False`` too)
TRAIN_ARCH = SERVE_ARCH
TRAIN_PARITY = dict(n_layers=2, batch=2, seq=64, steps=3, lr=1e-3)
# step 1 starts from equal parameters; later steps add the optimizer's
# arithmetic, in another order on each device
TRAIN_LOSS_RTOL = (1e-4, 1e-3)
# lr: the reference's make_optimizer default for full-size models; at the
# driver's CLI default 1e-3 (no warmup) the bf16 1.2B model's loss rose to
# 13.55 by step 8 (the reduced model in bf16 tracks the reference's losses
# there: tests/test_torch_train.py)
TRAIN_FULL = dict(steps=8, batch=4, seq=1024, lr=3e-4)


def _windows(vocab, batch, seq, steps, seed=0):
    """``launch/train.py``'s first ``steps`` token windows."""
    import numpy as np

    from repro_torch.data import make_federated_lm_data, token_batches

    stream = token_batches(np.concatenate(make_federated_lm_data(8, vocab, 20_000, seed=seed)),
                           batch, seq, seed=seed)
    return [next(stream) for _ in range(steps)]


def train_parity(ops, device):
    """(a) llama3.2-1b at full width, 2 layers, fp32: the same parameters
    (drawn on the cpu, a copy moved to the card) take 3 steps of
    ``make_optimizer(1e-3)`` on the same windows on cuda and on cpu."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, make_train_step, param_tree

    tp = TRAIN_PARITY
    cfg = get_config(TRAIN_ARCH).replace(n_layers=tp["n_layers"], dtype=torch.float32)
    windows = _windows(cfg.vocab, tp["batch"], tp["seq"], tp["steps"])
    params = init_params(cfg, seed=0, device="cpu", trainable=True)
    copies = {"cuda": copy.deepcopy(params).to(device), "cpu": params}
    runs = {}
    for dev, p in copies.items():
        opt = make_optimizer(tp["lr"])
        state = opt.init(param_tree(p))
        step = make_train_step(cfg, opt)
        ops.reset_launch_counts()
        losses, t0 = [], time.perf_counter()
        for w in windows:
            t = torch.from_numpy(w).to(p.embed.device)
            p, state, m = step(p, state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
            losses.append(float(m["loss"]))
        runs[dev] = {"losses": losses, "seconds": time.perf_counter() - t0,
                     "kernels": sum(ops.launch_counts().values())}
    param_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                     for a, b in zip(copies["cuda"].parameters(), copies["cpu"].parameters()))
    rel = [abs(a - b) / abs(b) for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"])]
    out = {"arch": TRAIN_ARCH, "dtype": "float32", **tp, "d_model": cfg.d_model,
           "losses": {k: r["losses"] for k, r in runs.items()}, "loss_rel_diff": rel,
           "tol": list(TRAIN_LOSS_RTOL), "max_param_diff": param_diff,
           "seconds": {k: r["seconds"] for k, r in runs.items()},
           "kernel_launches": {k: r["kernels"] for k, r in runs.items()}}
    tols = [TRAIN_LOSS_RTOL[0]] + [TRAIN_LOSS_RTOL[1]] * (len(rel) - 1)
    if not all(r <= t for r, t in zip(rel, tols)):
        raise AssertionError(f"train (a): cuda and cpu losses {out['losses']} differ by {rel}")
    if any(r["kernels"] for r in runs.values()):
        raise AssertionError(f"train (a): kernels launched {out['kernel_launches']}")
    return out


def step_spans(tracer):
    """(seconds of each ``train.step`` span, losses of ``train.metrics``)."""
    begins, secs = [], []
    for ev in tracer.events:
        if ev["name"] == "train.step" and ev["ph"] == "B":
            begins.append(ev["ts"])
        elif ev["name"] == "train.step" and ev["ph"] == "E":
            secs.append((ev["ts"] - begins.pop()) / 1e6)
    losses = [ev["args"]["loss"] for ev in tracer.events if ev["name"] == "train.metrics"]
    return secs, losses


def train_model_flops(cfg, batch, seq):
    """6 N T for the parameters that multiply (all but the embedding, a
    gather) plus ``_sdpa``'s attention, forward 4 B H S^2 hd a layer (all
    pairs: the mask is applied after the product) and twice that back."""
    from repro_torch.models import param_count

    n = param_count(cfg) - cfg.vocab * cfg.d_model
    attn = cfg.n_layers * 12 * batch * cfg.n_heads * seq ** 2 * cfg.head_dim
    return 6 * n * batch * seq + attn


# library matrix products as the profiler names them (cuBLAS's nvjet and
# CUTLASS-style sm90 kernels)
GEMM_KERNELS = r"nvjet|gemm|cutlass|sm90_xmma"


def step_split(cfg, opt, params, state, batch):
    """Seconds (CUDA events, warm) of one train step's two halves, as
    ``make_train_step`` runs them: the forward, ``lm_loss`` and
    ``torch.autograd.grad``; then the optimizer's update and
    ``apply_updates`` (not copied back: the parameters stay as they are)."""
    import torch

    from repro_torch.models import forward_train, lm_loss, param_tree
    from repro_torch.optim import apply_updates
    from repro_torch.utils.trees import tree_leaves, tree_structure, tree_unflatten

    tree = param_tree(params)
    leaves = tree_leaves(tree)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, _ = forward_train(params, cfg, batch)
    loss = lm_loss(logits, batch["labels"])
    del logits
    grads = tree_unflatten(tree_structure(tree), torch.autograd.grad(loss, leaves))
    ev[1].record()
    with torch.no_grad():
        updates, _ = opt.update(grads, state, tree)
        del grads
        new = apply_updates(tree, updates)
    ev[2].record()
    ev[2].synchronize()
    del updates, new
    return {"forward_backward_s": ev[0].elapsed_time(ev[1]) / 1e3,
            "optimizer_s": ev[1].elapsed_time(ev[2]) / 1e3}


def train_full(ops, trace, device):
    """(b) the 16-layer bf16 llama3.2-1b at full width through
    ``launch.train.main`` on cuda (8 steps at batch 4, seq 1,024). Then the
    same 8 steps again through ``make_train_step`` from the same seeded
    parameters, to read what ``main`` keeps to itself: the loss of step 1's
    batch before the steps and after them (``make_eval_step``; the steps'
    own losses are each on another batch, so the last against the first
    is not a measure of learning); then one more step under the profiler,
    and a ``use_pallas`` step, which must raise."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main, make_optimizer
    from repro_torch.models import (init_params, make_eval_step, make_train_step, param_count,
                                    param_tree)
    from repro_torch.roofline import H100_SXM, roofline_report

    tf = TRAIN_FULL
    cfg = get_config(TRAIN_ARCH)
    tracer = trace.Tracer()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        final = train_main(["--arch", TRAIN_ARCH, "--steps", str(tf["steps"]), "--batch",
                            str(tf["batch"]), "--seq", str(tf["seq"]), "--lr", str(tf["lr"]),
                            "--log-every", "1"], device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    secs, losses = step_spans(tracer)
    torch.cuda.empty_cache()

    tokens = tf["batch"] * tf["seq"]
    s_step = sum(secs[1:]) / len(secs[1:])
    flops = train_model_flops(cfg, tf["batch"], tf["seq"])
    # the least bytes a step moves: bf16 parameters and gradients each
    # written and read, fp32 moments read and written
    nbytes = param_count(cfg) * (2 * 2 + 2 * 2 + 2 * 8)
    rl = roofline_report(flops, nbytes, 0.0, hw=H100_SXM, model_flops=flops)

    # main's steps again, from main's parameters and on main's windows
    params = init_params(cfg, seed=0, device=device, trainable=True)
    opt = make_optimizer(tf["lr"])
    state = opt.init(param_tree(params))
    step = make_train_step(cfg, opt)
    evaluate = make_eval_step(cfg)
    batches = []
    for w in _windows(cfg.vocab, tf["batch"], tf["seq"], tf["steps"]):
        t = torch.from_numpy(w).to(device)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    before = float(evaluate(params, batches[0]))
    rerun = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        rerun.append(float(m["loss"]))
    after = float(evaluate(params, batches[0]))
    batch = batches[0]
    split = step_split(cfg, opt, params, state, batch)
    # one more step (warm), under the profiler
    profile, (params, state, m) = profile_call(lambda: step(params, state, batch), top=60)
    gemm = [k for k in profile["by_kernel"] if re.search(GEMM_KERNELS, k["name"])]
    profile["gemm_seconds"] = sum(k["seconds"] for k in gemm)
    profile["gemm_launches"] = sum(k["count"] for k in gemm)

    # with the flash kernel the step raises at the first attention and
    # leaves every parameter as it was
    probe = [params.embed, params.blocks[0].mixer.wq, params.lm_head]
    saved = [t.detach().clone() for t in probe]
    try:
        make_train_step(cfg.replace(use_pallas=True), opt)(params, state, batch)
        pallas = "trained"
    except RuntimeError as e:
        pallas = str(e)
    unchanged = all(torch.equal(a, t) for a, t in zip(saved, probe))
    counts = ops.launch_counts()   # over every step of the phase's (b)

    out = {
        "arch": TRAIN_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "params": param_count(cfg), **tf, "tokens_per_step": tokens, "main_wall_seconds": wall,
        "final_loss": final, "losses": losses, "step_seconds": secs,
        "rerun_losses": rerun, "first_batch_loss": {"before": before, "after": after},
        "seconds_per_step": s_step, "tokens_per_s": tokens / s_step, "peak_memory_bytes": peak,
        "model_flops": flops, "step_bytes": nbytes, "roofline": rl,
        "roofline_share": rl["step_lower_bound_s"] / s_step,
        "step_split": split, "profiled_step": profile,
        # the profiler's own start and stop dwarf one step's wall, so the
        # busy share is the profiled step's device seconds over an
        # unprofiled step's
        "device_busy_share": profile["device_seconds"] / s_step, "kernels": counts,
        "use_pallas_step": pallas[:300], "use_pallas_params_unchanged": unchanged,
    }
    if len(losses) != tf["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train (b): losses {losses}")
    if not (math.isfinite(after) and after < before and abs(before - losses[0]) <= 1e-2):
        raise AssertionError(f"train (b): step 1's batch loss {before} -> {after} after the "
                             f"steps (main's first loss {losses[0]})")
    if any(counts.values()):
        raise AssertionError(f"train (b): kernels launched during the steps: {counts}")
    if "no backward" not in pallas or not unchanged:
        raise AssertionError(f"train (b): a use_pallas step on cuda did not raise cleanly: "
                             f"{pallas[:200]} (parameters unchanged: {unchanged})")
    return out


def phase_train(ops, trace, device):
    return {"parity": train_parity(ops, device), "full": train_full(ops, trace, device)}


# the fleet phase: the SVM serving path and the multi-tenant fleet
# (``repro_torch.serve``, ``repro_torch.fleet``) on the card. The cells of
# ``benchmarks/serve_load_bench.py`` are rebuilt here on the port (its two
# SLO classes, registry, grids and JSON; ``tests/test_torch_fleet.py``
# runs the same functions on the cpu), and held byte for byte to the
# committed ``benchmarks/serve_load_bench.json`` and
# ``benchmarks/fleet_trace_baseline.json``
LOAD_CLASS_SLOS = {"premium": dict(deadline_ms=20.0, priority=1),
                   "batch": dict(deadline_ms=100.0, priority=0)}
LOAD_FULL = dict(tenant_counts=(2, 4, 8), loads=(0.25, 0.5, 1.0, 1.5, 2.0, 3.0),
                 horizon_ms=300.0, seed=7, pool_size=2048, quota=256)
LOAD_SMOKE = dict(tenant_counts=(2, 4), loads=(0.5, 1.0, 2.0), horizon_ms=150.0, seed=7,
                  pool_size=1024, quota=256)
LOAD_TRACE = dict(n_tenants=2, load=2.0, horizon_ms=8.0, seed=7, pool_size=256, quota=256)
LOAD_DIM = 8
HANDOFF = dict(seed=0, horizon_ms=250.0, load=1.0)   # serve_round_artifact's defaults
SERVE_BENCH = dict(batch=2048, d=32, n=200, ks=(8, 32), sched_k=16, sched_queries=256,
                   round_requests=4096, seed=1)   # benchmarks/serve_bench.py's setting


def load_setup():
    """``serve_load_bench.py``'s serve and fleet configs."""
    from repro_torch.fleet import CostModel, FleetConfig
    from repro_torch.serve import ServeConfig

    serve = ServeConfig(max_batch=32, max_queue=4096, buckets=(8, 32), cache_size=256)
    return serve, FleetConfig(n_servers=2, max_global_queue=1024, cost=CostModel())


def load_class(index):
    return "premium" if index % 2 == 0 else "batch"


def load_tenants(n_tenants, seed):
    """The bench's tenants as arrays: (name, SLO class, [(support_x, coef)]
    for 4 members of 40 normal supports at d 8), tenant i drawn from
    ``default_rng(seed * 1000 + i)``."""
    import numpy as np

    out = []
    for i in range(n_tenants):
        rng = np.random.default_rng(seed * 1000 + i)
        members = [(rng.normal(0.0, 1.0, (40, LOAD_DIM)).astype(np.float32),
                    rng.normal(0.0, 0.1, 40).astype(np.float32)) for _ in range(4)]
        out.append((f"t{i:02d}", load_class(i), members))
    return out


def load_registry(n_tenants, serve, quota, seed, device):
    """The bench's registry: each tenant a k 4 ensemble at gamma 0.2 under
    its class's SLO, with a 2-shard LRU."""
    from repro_torch.core import Ensemble, SVMModel
    from repro_torch.fleet import TenantRegistry, TenantSLO

    registry = TenantRegistry(device=device)
    for name, cls, members in load_tenants(n_tenants, seed):
        registry.register(name, Ensemble([SVMModel(sx, c, 0.2, device=device)
                                          for sx, c in members]),
                          slo=TenantSLO(quota=quota, **LOAD_CLASS_SLOS[cls]),
                          serve=serve, n_shards=2)
    return registry


def fleet_batches(fleet):
    """Scheduler batches over every tenant's shards: one scorer call each."""
    return sum(s.batches for stats in fleet.shard_stats().values() for s in stats)


def load_cell(n_tenants, load, *, horizon_ms, seed, pool_size, quota, device, tracer=None):
    """One (tenant count, offered load) cell: a fresh registry and fleet,
    the whole open-loop trace, the drained summary; (summary, requests,
    the fleet's scorer calls)."""
    from repro_torch.fleet import ServeFleet, nominal_capacity_qps, open_loop_trace

    serve, config = load_setup()
    registry = load_registry(n_tenants, serve, quota, seed, device)
    capacity = nominal_capacity_qps(config.n_servers, serve, config.cost)
    rate = load * capacity / n_tenants
    trace = open_loop_trace({name: rate for name in registry.names()}, horizon_ms=horizon_ms,
                            dim=LOAD_DIM, seed=seed, pool_size=pool_size)
    fleet = ServeFleet(registry, config, tracer=tracer)
    summary = fleet.run(trace, horizon_ms=horizon_ms)
    return summary, len(trace), fleet_batches(fleet)


def load_classes(tenants):
    """The per-tenant blocks summed into the two SLO classes (rates from
    the sums, p99 the worst), as the bench's ``_class_blocks``."""
    out = {}
    for cls in LOAD_CLASS_SLOS:
        blocks = [b for name, b in tenants.items() if load_class(int(name[1:])) == cls]
        if not blocks:
            continue
        submitted = sum(b["submitted"] for b in blocks)
        completed = sum(b["completed"] for b in blocks)
        met = sum(b["deadline_met"] for b in blocks)
        shed = sum(b["shed"] for b in blocks)
        out[cls] = {
            "tenants": len(blocks),
            "submitted": submitted,
            "goodput_qps": round(sum(b["goodput_qps"] for b in blocks), 3),
            "p99_ms": max(b["p99_ms"] for b in blocks),
            "shed_rate": round(shed / submitted, 6) if submitted else 0.0,
            "deadline_met_rate": round(met / completed, 6) if completed else 0.0,
        }
    return out


def load_curve(device, tenant_counts, loads, horizon_ms, seed, pool_size, quota):
    """``serve_load_bench.py``'s ``run`` on the port: its sweep with the
    in-bench bars (conservation everywhere; goodput at the highest load
    >= 80 % of the sweep's peak) and its determinism replay; (the JSON
    text the bench writes, the scorer calls made)."""
    import dataclasses

    from repro_torch.fleet import nominal_capacity_qps

    serve, config = load_setup()
    capacity = nominal_capacity_qps(config.n_servers, serve, config.cost)
    payload = {"config": {
        "tenant_counts": list(tenant_counts), "loads_x_capacity": list(loads),
        "horizon_ms": horizon_ms, "seed": seed, "pool_size": pool_size, "quota": quota,
        "dim": LOAD_DIM, "n_servers": config.n_servers,
        "max_global_queue": config.max_global_queue,
        "serve": {"max_batch": serve.max_batch, "buckets": list(serve.buckets),
                  "cache_size": serve.cache_size},
        "cost": dataclasses.asdict(config.cost), "slo_classes": LOAD_CLASS_SLOS,
        "nominal_capacity_qps": round(capacity, 3),
    }}
    cell = dict(horizon_ms=horizon_ms, seed=seed, pool_size=pool_size, quota=quota,
                device=device)
    sweeps, calls = {}, 0
    for n_tenants in tenant_counts:
        curve = []
        for load in loads:
            summary, n_req, batches = load_cell(n_tenants, load, **cell)
            calls += batches
            g = summary["global"]
            if not (g["conserved"] and all(b["conserved"] for b in summary["tenants"].values())):
                raise AssertionError(f"load curve: tenants={n_tenants} load={load}: "
                                     "conservation violated")
            curve.append({"n_tenants": n_tenants, "load_x_capacity": load, "requests": n_req,
                          **{k: g[k] for k in ("offered_qps", "goodput_qps", "p50_ms",
                                               "p95_ms", "p99_ms", "shed_rate",
                                               "deadline_met_rate", "batch_occupancy",
                                               "cache_hit_rate")},
                          "classes": load_classes(summary["tenants"])})
        peak = max(c["goodput_qps"] for c in curve)
        if not curve[-1]["goodput_qps"] >= 0.8 * peak:   # loads ascend: last = most overload
            raise AssertionError(f"load curve: tenants={n_tenants}: goodput collapsed "
                                 f"under overload ({curve[-1]['goodput_qps']} vs {peak})")
        sweeps[f"tenants={n_tenants}"] = curve
    payload["sweeps"] = sweeps
    replays = [load_cell(tenant_counts[0], loads[0], **cell) for _ in range(2)]
    calls += sum(r[2] for r in replays)
    a, b = (json.dumps(r[0], sort_keys=True) for r in replays)
    if a != b:
        raise AssertionError("load curve: fleet summary not byte-identical across replays")
    payload["determinism"] = {"repeat_identical": True, "n_tenants": tenant_counts[0],
                              "load_x_capacity": loads[0]}
    return json.dumps(payload, indent=2) + "\n", calls


def load_trace(device):
    """``serve_load_bench.py``'s ``run_trace`` on the port: one small
    overloaded cell traced on simulated-ms timestamps, twice; (the JSON
    text the bench writes, the scorer calls made)."""
    from repro_torch.obs import Tracer

    c = dict(LOAD_TRACE)
    n_tenants, load = c.pop("n_tenants"), c.pop("load")
    texts, calls = [], 0
    for _ in range(2):
        tracer = Tracer(process_name="fleet (simulated ms)")
        calls += load_cell(n_tenants, load, device=device, tracer=tracer, **c)[2]
        texts.append(tracer.to_json())
    if texts[0] != texts[1]:
        raise AssertionError("fleet trace: not byte-identical across replays")
    return texts[0] + "\n", calls


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def fleet_handoff(ops, model, label, total):
    """``serve_round_artifact``'s path on the card (encode -> checkpoint ->
    ``register_wire`` -> ``ServeFleet.run``, ``keep_results``): the
    summary, conservation, the scorer launched once per scheduler batch
    (and the other scorer never), each kept result bitwise a direct cuda
    score of its row (one call over all rows: the split plan never depends
    on b) and within AUC_TOL of the cpu plain scorer on the restored
    checkpoint."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import restore_payload
    from repro_torch.comm.wire import decode
    from repro_torch.fleet import deploy_round_artifact
    from repro_torch.serve import EnsembleScorer

    with tempfile.TemporaryDirectory(prefix="fleet_handoff_") as tmp:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fleet, trace, handoff = deploy_round_artifact(
            model, seed=HANDOFF["seed"], horizon_ms=HANDOFF["horizon_ms"], load=HANDOFF["load"],
            checkpoint_dir=tmp, keep_results=True, device="cuda")
        summary = fleet.run(trace, horizon_ms=HANDOFF["horizon_ms"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        cpu_scorer = EnsembleScorer(decode(restore_payload(tmp), device="cpu"), device="cpu")
    _add_counts(total, counts)
    kernel = "ensemble_score_q8" if handoff["codec"] == "int8" else "ensemble_score"
    other = "ensemble_score" if kernel == "ensemble_score_q8" else "ensemble_score_q8"
    batches = fleet_batches(fleet)
    scorer = fleet.registry.get("premium").scorer
    g = summary["global"]
    rids = sorted(fleet.results)
    rows = np.stack([trace[rid].row for rid in rids])
    kept = np.array([fleet.results[rid] for rid in rids], np.float32)
    direct = scorer(rows)
    plain = cpu_scorer(rows)
    out = {"artifact": label, "handoff": handoff, "global": g,
           "tenants": {n: {k: t[k] for k in ("submitted", "completed", "shed", "p99_ms",
                                             "goodput_qps")}
                       for n, t in summary["tenants"].items()},
           "k": scorer.k, "n_max": int(scorer.stacked.n_max), "d": int(scorer.stacked.d),
           "wall_seconds": wall, "scheduler_batches": batches, "kernels": counts,
           "results": len(rids), "results_bitwise_direct": bool(np.array_equal(kept, direct)),
           "max_abs_diff_cpu_plain": float(np.abs(kept - plain).max())}
    name = f"fleet handoff [{label}]"
    if not (g["conserved"] and all(t["conserved"] for t in summary["tenants"].values())):
        raise AssertionError(f"{name}: conservation violated")
    if not g["completed"] > 0 or len(rids) != g["completed"]:
        raise AssertionError(f"{name}: {len(rids)} kept results for {g['completed']} completed")
    if counts[kernel] != batches or counts[other] != 0:
        raise AssertionError(f"{name}: {kernel} launched {counts[kernel]} times ({other} "
                             f"{counts[other]}) for {batches} scheduler batches")
    if not out["results_bitwise_direct"]:
        raise AssertionError(f"{name}: kept results differ from direct cuda scores")
    if not (np.all(np.isfinite(kept)) and out["max_abs_diff_cpu_plain"] <= AUC_TOL):
        raise AssertionError(f"{name}: kept results {out['max_abs_diff_cpu_plain']} from "
                             "the cpu plain scorer")
    return out


def _median_seconds(fn, reps):
    """Median host seconds of ``reps`` warm calls of ``fn`` (each ends in
    a device-to-host copy of its scores, so each call is finished)."""
    import numpy as np

    fn()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs))


def serve_bench_ensemble(k, device):
    """``serve_bench.py``'s ensemble: k members of n/2..n ragged supports
    at d 32, gammas in [0.05, 0.5]."""
    import numpy as np

    from repro_torch.core import Ensemble, SVMModel

    c = SERVE_BENCH
    rng = np.random.default_rng(0)
    members = []
    for _ in range(k):
        ni = int(rng.integers(c["n"] // 2, c["n"] + 1))
        members.append(SVMModel(support_x=rng.normal(0, 1, (ni, c["d"])).astype(np.float32),
                                coef=rng.normal(0, 0.1, ni).astype(np.float32),
                                gamma=float(rng.uniform(0.05, 0.5)), device=device))
    return Ensemble(members)


def serve_bench_card(server_scorer):
    """``serve_bench.py``'s comparisons timed on the card, plus the round's
    own server scorer through ``MicroBatchScheduler`` at ``ServeConfig()``'s
    defaults: host seconds (median of warm calls) and, where a kernel
    runs, the device ms of one call (``device_time``)."""
    import numpy as np

    from repro_torch.serve import EnsembleScorer, ServeConfig

    c = SERVE_BENCH
    rng = np.random.default_rng(c["seed"])
    x = rng.normal(0, 1, (c["batch"], c["d"])).astype(np.float32)
    out = {"fused_vs_padded": []}
    for k in c["ks"]:
        ens = serve_bench_ensemble(k, "cuda")
        fused_s = _median_seconds(lambda: ens.predict(x), 5)
        padded_s = _median_seconds(lambda: ens.predict_padded(x), 5)
        diff = float(np.abs(ens.predict(x) - ens.predict_padded(x)).max())
        out["fused_vs_padded"].append({
            "k": k, "batch": c["batch"], "fused_ms": 1e3 * fused_s,
            "padded_ms": 1e3 * padded_s, "speedup": padded_s / fused_s,
            "fused_device_ms": device_time(ens.predict, (x,), 5)[0],
            "padded_device_ms": device_time(ens.predict_padded, (x,), 5)[0],
            "max_abs_diff": diff})
        if not diff <= AUC_TOL:
            raise AssertionError(f"serve bench k{k}: predict and predict_padded differ by {diff}")

    scorer = EnsembleScorer(serve_bench_ensemble(c["sched_k"], "cuda"), device="cuda")
    queries = [rng.normal(0, 1, (c["d"],)).astype(np.float32) for _ in range(c["sched_queries"])]

    def rps(config, reqs):
        return len(reqs) / _median_seconds(lambda: scorer.scheduler(config).run(reqs), 3)

    big = ServeConfig(max_batch=256, buckets=(256,), cache_size=0)
    one = ServeConfig(max_batch=1, buckets=(1,), cache_size=0)
    out["scheduler"] = {"k": c["sched_k"], "requests": len(queries),
                        "batched_256_rps": rps(big, queries), "single_rps": rps(one, queries),
                        "batch_256_device_ms": device_time(scorer, (np.stack(queries),), 5)[0]}
    out["scheduler"]["batched_over_single"] = (out["scheduler"]["batched_256_rps"]
                                               / out["scheduler"]["single_rps"])
    sched = scorer.scheduler(ServeConfig(max_batch=256, buckets=(256,), cache_size=512))
    sched.run(queries)   # fills the cache
    hits = sched.stats.answered_from_cache
    t0 = time.perf_counter()
    sched.run(queries)
    out["cached"] = {"rps": len(queries) / (time.perf_counter() - t0),
                     "hit_rate": (sched.stats.answered_from_cache - hits) / len(queries)}

    round_scorer = EnsembleScorer(server_scorer, device="cuda")
    reqs = [rng.normal(0, 1, (round_scorer.stacked.d,)).astype(np.float32)
            for _ in range(c["round_requests"])]
    config = ServeConfig()
    secs = _median_seconds(lambda: round_scorer.scheduler(config).run(reqs), 3)
    sched = round_scorer.scheduler(config)
    sched.run(reqs)
    out["round_server_scorer"] = {
        "k": round_scorer.k, "n_max": int(round_scorer.stacked.n_max),
        "d": int(round_scorer.stacked.d), "requests": len(reqs),
        "serve_config": {"max_batch": config.max_batch, "buckets": list(config.buckets),
                         "cache_size": config.cache_size},
        "seconds": secs, "rps": len(reqs) / secs, "batches": sched.stats.batches,
        "batch_device_ms": device_time(round_scorer, (np.stack(reqs[:config.max_batch]),),
                                       5)[0]}
    return out


def fleet_artifacts(make_dataset, run_protocol, DistillConfig, artifacts):
    """The emnist round's fp32 ``server_scorer`` and ``main_q8``'s int8
    student: ``main``'s and ``main_q8``'s when they ran in this call, else
    their rounds once more on cuda (no profile)."""
    missing = [p for p in ("main", "main_q8") if p not in artifacts]
    rounds = {}
    if missing:
        ds = make_dataset("emnist", seed=0, scale=1.0)
        kw = {"main": {}, "main_q8": {"codec": "int8",
                                     "distill": DistillConfig(proxy_size=4096, solver="cg")}}
        for p in missing:
            t0 = time.perf_counter()
            artifacts[p] = run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda",
                                        **kw[p])
            rounds[p] = time.perf_counter() - t0
    return artifacts["main"].server_scorer, artifacts["main_q8"].student, rounds


def phase_fleet(make_dataset, run_protocol, DistillConfig, ops, artifacts):
    """The serving path on the card: (1) the emnist round's fp32 server
    scorer and int8 student deployed through ``serve_round_artifact``'s
    path; (2) ``serve_load_bench.py``'s full sweep and (3) its trace
    baseline rebuilt with the scorers on cuda, byte for byte the committed
    JSON; (4) ``serve_bench.py``'s comparisons and the round scorer's
    requests/s. ``kernels``: the launches of (1)-(3)."""
    from repro_torch.comm.wire import QuantizedSVM

    total = {}
    fp32_model, q8_model, round_s = fleet_artifacts(make_dataset, run_protocol,
                                                    DistillConfig, artifacts)
    if not isinstance(q8_model, QuantizedSVM):
        raise AssertionError(f"fleet: main_q8's student is a {type(q8_model).__name__}")
    out = {"rounds_run_seconds": round_s,
           "handoff": [fleet_handoff(ops, fp32_model, "main server_scorer fp32", total),
                       fleet_handoff(ops, q8_model, "main_q8 student int8", total)]}
    for label, build, path in (
            ("load_curve", lambda: load_curve("cuda", **LOAD_FULL), "serve_load_bench.json"),
            ("trace", lambda: load_trace("cuda"), "fleet_trace_baseline.json")):
        want = (ROOT / "benchmarks" / path).read_text()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        text, calls = build()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        _add_counts(total, counts)
        out[label] = {"file": f"benchmarks/{path}", "bytes": len(text),
                      "byte_identical": text == want, "wall_seconds": wall,
                      "scorer_calls": calls, "kernels": counts}
        if text != want:
            raise AssertionError(f"fleet {label}: the port's JSON differs from "
                                 f"benchmarks/{path}")
        if counts["ensemble_score"] != calls:
            raise AssertionError(f"fleet {label}: ensemble_score launched "
                                 f"{counts['ensemble_score']} times for {calls} batches")
    out["serve_bench"] = serve_bench_card(fp32_model)
    out["kernels"] = total
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
                       "ideal predict b8192 k1 n2000", "population b4096 k50 n40 d16",
                       "fleet d8 b32 k4 n40"),
    "sdca": ("ideal g1 b2048 n2000", "ideal emnist g1 b2048 n2000", "group g256 b64",
             "group g128 b256", "group dirichlet g256 b64"),
    "gram_matvec": ("cg l4096 d32", "cg emnist l4096 d32", "cg l4096 d16"),
    "rbf_gram_q8": ("student predict b8192 n4096 d32", "student emnist b8192 n4096 d32"),
    "ensemble_score_q8": ("full b8192 k2821 n230", "k100 b8192 n230", "fleet d8 b32 k4 n40"),
    "flash_attention": ("serve b4 s2048 h32 k8 hd64 causal bfloat16",
                        "serve b4 s2048 h32 k8 hd64 causal float32"),
}
LIBRARY = {"flash_attention": sdpa_library}


def phase_timing(ops, device, rng, names):
    """Each kernel in turns with its plain version (``time_pair``), its
    device time (``device_time``), a ``fill_`` of its output and its bound
    (``obs.profile.kernel_bound``: ``kernel_cost``'s operations and bytes
    on the card's sheet for the first operand's type, the bound a kernel
    span carries) at the ``TIMING_CASES`` shapes."""
    import torch

    from repro_torch.obs.profile import kernel_bound, kernel_cost

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
            bound_s, bound_by = kernel_bound(name, args)
            ops_n, bytes_n = kernel_cost(name, spec.kernel, args)
            row = {
                "kernel": name, "case": label,
                "ms": sum(turns["kernel"]) / 2, "device_ms": dev_ms,
                "device_launches_recorded": dev_launches, "device_kernels": dev_names,
                "device_windows": windows,
                "plain_ms": sum(turns["plain"]) / 2,
                "library_ms": sum(turns["library"]) / 2 if library else None,
                "turns": turns, "reps": reps, "bound_ms": 1e3 * bound_s,
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


PROFILE_FRAC_MAX = 1.05   # a span's roofline share: the bound over event-timed seconds


def phase_profile(ops, device, rng, names, timing_rows, make_dataset, run_protocol, trace):
    """Every ``TIMING_CASES`` call once more through its dispatcher under a
    tracer: the traced result bitwise the untraced one, the span's
    ``flops`` and ``bytes_accessed`` > 0, ``0 < roofline_frac <=
    PROFILE_FRAC_MAX`` and ``roofline_bound_us`` the ``timing`` table's
    bound (one function computes both); then ``main``'s emnist round under
    a tracer: one ``kernel.<name>`` span per launch of every kernel."""
    import collections
    import math

    import torch

    from repro_torch.obs.profile import kernel_bound

    cases = {name: dict(c) for name, c in kernel_cases(rng, ops).items()}
    rows, failed = [], []
    for name, labels in TIMING_CASES.items():
        if name not in names:
            continue
        spec = ops.KERNEL_REGISTRY[name]
        for label in labels:
            args = case_args(cases[name][label])
            targs = to_device(args, device)
            untraced = spec.dispatch(*targs)
            tracer = trace.Tracer()
            with trace.use_tracer(tracer):
                traced = spec.dispatch(*targs)
            spans = [e for e in tracer.events if e["name"] == f"kernel.{name}"]
            a = spans[0]["args"] if len(spans) == 1 else {}
            bound_ms = timing_rows.get((name, label), 1e3 * kernel_bound(name, args)[0])
            row = {"kernel": name, "case": label, "spans": len(spans),
                   "bitwise": bool(torch.equal(untraced, traced)),
                   **{k: a.get(k) for k in ("dur_s", "flops", "bytes_accessed",
                                            "roofline_bound_us", "roofline_frac", "dominant")},
                   "timing_bound_ms": bound_ms}
            rows.append(row)
            ok = (len(spans) == 1 and row["bitwise"] and a["flops"] > 0
                  and a["bytes_accessed"] > 0 and 0 < a["roofline_frac"] <= PROFILE_FRAC_MAX
                  and math.isclose(a["roofline_bound_us"], 1e3 * bound_ms, rel_tol=1e-12))
            if not ok:
                failed.append(f"{name} [{label}]: {row}")
            del targs, untraced, traced
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("profile: " + "; ".join(failed))

    ds = make_dataset("emnist", seed=0, scale=1.0)
    tracer = trace.Tracer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    kspans = [e for e in tracer.events if e.get("cat") == "kernel"]
    by_name = collections.defaultdict(list)
    for e in kspans:
        by_name[e["name"][len("kernel."):]].append(e["args"])
    spans = {name: len(v) for name, v in by_name.items()}
    round_out = {
        "round_seconds_traced": wall, "kernel_spans": spans, "launches": counts,
        "kernel_seconds": {n: sum(a["dur_s"] for a in v) for n, v in by_name.items()},
        "bound_seconds": {n: sum(a["roofline_bound_us"] for a in v) / 1e6
                          for n, v in by_name.items()},
    }
    if any(spans.get(n, 0) != c for n, c in counts.items()) or set(spans) - set(counts):
        raise AssertionError(f"profile: kernel spans {spans} != launches {counts}")
    missing = [n for n in FP32_KERNELS if counts[n] <= 0]
    if missing:
        raise AssertionError(f"profile: the traced round launched no {missing}")
    return {"cases": rows, "main_round": round_out}


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
    artifacts = {}   # main, main_q8 -> the round's result, for the fleet phase
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
                out, artifacts[phase] = phase_main(make_dataset, run_protocol, ops, trace,
                                                   FP32_KERNELS, gram=True)
                counts[phase] = out["kernels"]
            elif phase == "main_q8":
                out, artifacts[phase] = phase_main(
                    make_dataset, run_protocol, ops, trace, FP32_KERNELS + Q8_KERNELS,
                    codec="int8", distill=DistillConfig(proxy_size=4096, solver="cg"))
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
            elif phase == "train":
                out = phase_train(ops, trace, device)
                counts[phase] = out["full"]["kernels"]
            elif phase == "fleet":
                out = phase_fleet(make_dataset, run_protocol, DistillConfig, ops, artifacts)
                counts[phase] = out["kernels"]
            elif phase == "timing":
                out = phase_timing(ops, device, np.random.default_rng(0), names)
                timing = {r["kernel"]: r for r in reversed(out["rows"])}
            else:
                bounds = {(r["kernel"], r["case"]): r["bound_ms"]
                          for r in detail.get("timing", {}).get("rows", [])}
                out = phase_profile(ops, device, np.random.default_rng(0), names, bounds,
                                    make_dataset, run_protocol, trace)
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
            "launches_path": path, "launches_fleet": counts.get("fleet", {}).get(name),
            "launches_train": counts.get("train", {}).get(name),
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
