#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It imports the port and nothing of JAX or of the reference package
``repro``, and runs eighteen phases, each printing one JSON line on stdout:

  build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
           for sm_90a, one ``nvcc`` per source, all started together (the
           kernel cases are drawn in a thread meanwhile); count the
           tensor-core (HMMA), ldmatrix (LDSM), cp.async (LDGSTS) and
           TMA tensor load (UTMALDG) instructions in the compiled code
           (``cuobjdump -sass``, one per library, all at once): the bf16
           and fp16 flash kernels, ``rbf_gram_q8``'s ``gram_q8``, the fp32
           Grams' ``gram`` and ``gram_matvec`` (its chunked route past d
           64) must have the first three, the scorers LDGSTS, SDCA (its
           cluster kernel's ring) UTMALDG;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes and the registry's two shapes, at the
           registry's tolerance; flash attention in fp32 (``flash_attention.cu``)
           and bf16 (the tensor-core ``flash_attention_tc.cu``) at head dims
           32, 64 and 128, and in fp32, bf16 and fp16 at Phi-3-mini's
           prefill (hd 96, window 2,047), Gemma-2B's attention (hd 256,
           8 heads on 1 KV head) and hd 512 (the chunked kernels), 1, 4 and
           6 query heads per KV head, causal,
           causal with a window, non-causal, ragged lengths, the serve
           shape and the ``families`` prefills (hd 128, 4 and 8 query
           heads per KV head; llava's 4 x 4,928 positions, causal;
           whisper's encoder, 4 x 1,500 frames, hd 64, non-causal and
           ragged against the 128-row tile); the scorers at k 1 / n 2,000, k 10 at b 8, k 100, k 2,821
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
           iterations); then a 10,000-device round of the same setting
           under the profiler (busy share); (c) the traced
           host peak (``tracemalloc``) of the streamed pass alone at 25,000
           and 100,000 devices, each in a spawned worker started as soon
           as the build is done, beside ``kernels``, ``parity`` and (a)
           ((b) waits for them): under 64 MiB and flat;
  main     ``run_protocol`` on the full-scale emnist federation on cuda
           (``benchmarks/fig1_mean_auc.py``'s setting): the seconds of each
           ``round.*`` span, the AUCs, and each kernel's launches in that
           run, all four of the fp32 round's kernels > 0; then the same
           round once more under ``torch.profiler`` for the device's busy
           share and the device time of ``batched_rbf_gram`` (its 39
           launches) and ``rbf_gram`` beside the bound of the round's own
           launch shapes (``ops.round_gram_launches``); then the same round
           with ``engine="sharded"`` in this process, a one-rank ``nccl``
           world started by ``launch.mesh.make_sim_mesh``: one shard,
           ``round_signature`` and every AUC bitwise the bucketed round's,
           ``batched_rbf_gram`` and ``sdca`` launched, its seconds and
           ``engine.gather`` spans beside the bucketed round's;
  main_q8  the same federation with the int8 codec and CG distillation on
           4,096 validation-pool proxy rows: spans (``distill.round``
           included), AUCs (the distilled student's included), the
           student's support count and codec, and each kernel's launches,
           all seven > 0, ``gram_matvec``'s equal to the CG iterations;
           then once more under the profiler;
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
  wide     the SVM kernels past their staged limits (the scorers past d
           220, ``gram_matvec`` past d 64, ``rbf_gram_q8`` past d 128,
           SDCA past bucket 12,384), its cpu half in a spawned process beside
           the card's work: (a) the four feature-dim kernels at d 129,
           220, 221, 256, 784 and 1,024 at the round's shapes (scorers b
           8,192, k 2,821, n 230; ``gram_matvec`` l 4,096;
           ``rbf_gram_q8`` b 8,192 against 4,096 int8 supports; drawn on
           the card) against their plain versions, two launches bitwise,
           and each chunked kernel's private entry against the staged
           kernel where both run (bitwise; ``gram_matvec``, whose chunked
           route runs the cross term on the tensor cores, within the tol);
           SDCA's cluster kernel on the pooled
           emnist ideal at buckets 12,416 and 16,384 against its plain
           version at 2 epochs (ms and ns a step; the cluster's CTAs), alone
           and in a group of 2 bitwise at 12,416, and through its private
           entry within the tol of the one-block kernel and the plain
           version at g256 b64 and the ideal's 2,048; then, launches counted from 0: (b)
           the scale-0.02 emnist rounds at d 784 (fp32) and d 256 (int8,
           CG distillation on 1,024 proxy rows) on cuda against the cpu
           (ledgers, ids and best k equal, AUCs within 1e-4); (c) the emnist
           round at d 784 in fp32 on cuda at a quarter of Table 1's scale
           (865 devices; the full 3,462 pushed the script past its time on
           a slow host; ``tools/wide_round.py`` runs them): seconds, spans,
           AUCs, launches, each kernel's summed launch times; (d) ``train_svm`` on the ideal's 16,384
           rows (bucket 16,384, the SDCA cluster) on cuda and on cpu, AUCs
           on the pooled test rows within 1e-4; every lifted kernel
           launched in (b)-(d);
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
  head_dims  flash attention at every head dim and float type the
           reference's kernel takes, and Phi-3-mini's widths
           (hf:microsoft/Phi-3-mini-4k-instruct: d 3,072, 32 heads of hd
           96, d_ff 8,192, vocab 32,064, window 2,047; the port's
           ``ModelConfig``, not a configuration of the repo): (a) hd 1, 8,
           24, 72, 80, 96, 100, 160, 192, 256, 320 and 512 in fp32, bf16
           and fp16, causal, causal with a window, non-causal, non-causal
           with a window on a ragged length, 1 and 4 query heads per KV
           head, 200 and 333 rows; mixed types (bf16 q with fp32 k and v,
           fp16 q with bf16 k), float64, a transposed q, a q 2 bytes off a
           16-byte boundary, and B x H = 70,400 at S 3, hd 8: each within
           its tolerance of the plain version (fp32 2e-5; bf16 and fp16
           1e-4 + 2^-7 or 2^-10 |plain|), two launches bitwise equal, one
           launch a call; (b) 2
           layers in fp32, the flash kernel on cuda against its plain
           version on cpu (in a spawned worker from the phase's start): 2
           prompts of 200 tokens, 8 greedy tokens, equal tokens and
           last-position logits within LM_LOGIT_TOL; (c) all 32 layers in
           bf16 (3.82 B parameters) through ``serve_prompts``: 4 prompts of
           2,048 tokens (the window masks key 0 at the last position), 32
           greedy tokens, exactly 32 flash launches and no other kernel,
           warm prefill seconds, decode ms a step, peak memory, and the
           NLL of 4 windows of 2,049 tokens through the kernel within 2^-7
           of plain attention's;
  train    the LM train step (``models.make_train_step``, ``launch/train.py``;
           no hand-written kernel runs in it: none has a backward, as no
           Pallas kernel of the reference has one): (a) llama3.2-1b at full
           width cut to 2 layers, fp32, the same parameters (drawn on the
           card, a copy moved to the cpu) 3 steps of ``make_optimizer(1e-3)``
           at batch 2, seq 64 on cuda and on cpu (its large host tensors on
           reused memory, ``reused_host_memory``): losses within 1e-4 (step 1) and 1e-3 relative;
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
           raise and leave the parameters as they were; (c) the LM mesh
           (``ShardCtx``, ``launch.mesh.make_debug_mesh``: a 1 x 1 mesh on a
           one-rank nccl world on cuda:0): ``launch.train.main --mesh
           debug``, 4 steps at batch 4, seq 1,024, against the same seed's
           ``--mesh none`` run (bitwise expected; else the forward's and the
           loss's bits named, and held within 2^-8 relative); the sharded
           prefill of 4 x 2,048 tokens and 8 decode steps with the flash
           kernel (``use_pallas``, through ``_attend``'s ``local_map``),
           their logits against the unsharded run's, the flash launches
           equal to the unsharded run's (and above 0), the kernel against
           its plain version at that prefill's shape; and the full-depth
           dry-run of llama3.2-1b ``train_4k`` on the 16 x 16 fake mesh
           (``python -m repro_torch.launch.dryrun``, its own process,
           beside (c)'s other parts), its record and seconds;
  deep     the deep one-shot round (``core/deepfed.py``, ``fed_run --mode
           lm``'s path): (a) llama3.2-1b at full width cut to 2 layers,
           fp32, 2 members (drawn on the card, copies moved to the cpu) 2
           local steps each at batch 2, seq 256, evaluated on 2 held-out
           windows (single member and ensemble), 2 ``kl`` distill steps
           into a student drawn once on the card, on cuda (the teacher and
           the evaluations through the fp32 flash kernel) and on cpu (on
           reused host memory), each part's seconds: local
           losses within 1e-4 (step 1) and 1e-3 relative, NLLs within 1e-4,
           distill losses within 1e-3, byte counts equal, the flash
           launches counted; (b) the full 16-layer bf16 llama3.2-1b: 4
           members 4 local steps each at batch 4, seq 512, single-member
           and ensemble NLLs on 8 held-out windows, 4 ``kl`` distill steps
           and the student's NLL, the teacher and the evaluations through
           the bf16 flash kernel: s a local step, tokens/s, the teacher's
           forward and a distill step's seconds, peak memory, the flash
           launches equal to the count from M, the layers, the distill
           steps and the windows, no other kernel, step 1's batch loss
           lower after the steps than before for every member; the
           ensemble NLL of one window through the kernel within 2^-7 of
           the plain attention's; a distill step and a local step under
           the profiler (busy share);
  families the MoE, SSM (Mamba2), hybrid (Jamba), VLM (LLaVA) and audio
           (Whisper) LMs (``models/layers.py::moe``, ``models/ssm.py``, the
           patch prefix, ``models/model.py::encode`` and the
           cross-attention), each part's seconds on a progress line: (a)
           at full width in fp32, the same parameters (drawn on the card, a
           copy moved to the cpu), ``forward_train`` on cuda and cpu:
           phi3.5-moe and mamba2 at 2 layers on 1 x 256 tokens, llava at 2
           layers on 64 random patches + 192 tokens, whisper whole (6 + 6
           layers) on 1,500 random frames and 64 tokens: logits within
           LM_LOGIT_TOL and every MoE layer's top-k expert ids equal; (b)
           bf16 with the flash kernel through ``serve_prompts``, 4 prompts
           of 2,048 tokens, 32 greedy tokens: phi3.5-moe at 16 of 32
           layers, mamba2-2.7b at all 64, jamba at its first 5 of 72
           (mamba/mlp, mamba/moe, mamba/mlp, mamba/moe, attn/mlp), llava at
           all 32 behind 2,880 zero patches, whisper whole with 416-token
           prompts behind 1,500 zero frames: parameters = ``param_count`` +
           ``uncounted_params``, prefill and decode seconds cold and warm,
           cache bytes, peak memory, busy share (a serve of the prompts
           and FAMILY_PROFILE_GEN tokens under the profiler, over a warm
           serve of the same), flash launches = self-attention layers, the
           encoder's included (one prefill), and no other kernel, the
           prompts' NLL through the kernel within 2^-7 of plain
           attention's, with the largest logit gap and, for the MoE, the
           tokens whose experts differ between the two runs by layer; the
           first MoE layer twice on a prefill-shaped input bitwise equal;
           (c) 2 fp32 layers (phi3.5-moe, llava and whisper through the
           fp32 kernel, mamba2; llava behind 64 random patches, whisper on
           1,500 random frames): 96-token prefill and 31 decode steps
           against ``forward_train`` at each position within LM_LOGIT_TOL
           (B x S = 256: dropless), and one full-width mamba2 mixer at
           chunk 256 on 512 tokens finite and within 1e-3 of its
           token-by-token recurrence; (d) bf16 train steps, no kernel:
           phi3.5-moe at 1 layer, mamba2 at 32, llava at 10 (64 random
           patches a row, lr 2e-5), whisper whole (1,500 random frames a
           row), 3 steps of 4 x 512 tokens at lr 3e-4: losses finite, aux > 0 for
           the MoE, step 1's batch loss lower after, s/step and peak
           memory;
  cli      ``repro_torch.launch.fed_run.main`` on cuda and on cpu: the
           sim round on 1,024 dirichlet devices, ks 10 and 50, dense
           distillation on 1,024 proxy rows and ``--serve-fleet``, then in
           int8 under a 30,000-byte budget with ``fisher`` and CG
           distillation, each with ``--trace``: equal ``comm`` blocks and
           ledgers, AUCs within 1e-4 (the distilled one where the CG
           converged), the fleet summaries byte for byte, the trace's
           ``round.*``, ``engine.*`` and fleet (pid 2) tracks, and the
           seven SVM kernels launched; then the fp32 run with ``--engine
           sharded --mesh 2`` on two ranks sharing the one card: two
           processes (``torch.multiprocessing``, ``spawn``), both on
           ``cuda:0``, each joining a ``gloo`` world itself (NCCL refuses
           two ranks on one GPU): rank 0's JSON equal to the bucketed
           cuda run's but for ``engine``, the mesh keys and the timings,
           ``mesh`` 2, and ``batched_rbf_gram`` and ``sdca`` launched on
           each rank (a rank that hangs past its deadline or exits
           non-zero fails the phase), then each rank's second run's
           seconds (warm); ``--mode lm`` at its defaults: the
           reference's keys, equal byte counts, finite NLLs;
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
           microseconds mostly the wrapper's host time; a version whose
           call takes a second or more, the plain SDCA at the ideal, is
           timed by one call), and the kernel's
           own device time a call from ``torch.profiler`` over a run of
           back-to-back calls (``device_ms``), at main-path shapes
           (``batched_rbf_gram`` at six of the round's 15; the lifted
           kernels also at d 784 and SDCA at bucket 16,384, the ``wide``
           phase's shapes, whose device time takes 4 calls a window), beside a
           ``fill_`` of the output (the card's own write rate) and the
           analytic bound from the port's ``obs.profile.kernel_bound``: the
           larger of operations over the card's peak for the inputs' type
           (``roofline.H100_SXM_FP32``, 67 TFLOP/s fp32 outside the tensor
           cores; ``H100_SXM``, 989 TFLOP/s bf16 dense) and bytes (each
           input read once, each output written once) over 3.35 TB/s, the
           H100 SXM's published peaks; flash attention (also at Phi-3-mini's
           prefill in bf16 and fp16, at Gemma-2B's in bf16 and through the
           chunked kernels at hd 512 in bf16, fp16 and fp32) also beside
           ``library_ms``, one call of
           ``torch.nn.functional.scaled_dot_product_attention`` on the same
           tensors (with a window, its mask as a boolean ``attn_mask``; a
           yardstick only: the port never calls it). SDCA's
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
``launches_fleet``, in ``train`` (b)'s steps as ``launches_train``, in
``train`` (c)'s sharded prefill and decode as ``launches_mesh``, in
``deep`` (b)'s round as ``launches_deep``, in ``head_dims`` (c)'s
counted serve as ``launches_head_dims``, in ``families`` (b)'s
counted serves as ``launches_families``, in the ``cli`` runs on
cuda as ``launches_cli``, in ``main``'s sharded round as
``launches_sharded`` and in ``wide`` (b)-(d) as ``launches_wide``;
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
import collections
import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from statistics import fmean as mean

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "kernels", "parity", "population", "main", "main_q8", "agg", "wide", "lm_parity",
          "serve", "head_dims", "train", "deep", "families", "cli", "fleet", "timing", "profile")
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
# (label, (B, S, H, K, hd), causal, window); the last three are the serve and
# families phases' prefills
FLASH_SHAPES = (
    ("hd32 rep1 causal", (2, 256, 4, 4, 32), True, 0),
    ("hd64 rep4 causal window100", (2, 300, 8, 2, 64), True, 100),
    ("hd128 rep6 non-causal", (1, 256, 12, 2, 128), False, 0),
    ("hd128 rep6 causal ragged333", (1, 333, 12, 2, 128), True, 0),
    ("hd64 rep4 non-causal window64 ragged201", (2, 201, 8, 2, 64), False, 64),
    ("serve b4 s2048 h32 k8 hd64 causal", (4, 2048, 32, 8, 64), True, 0),
    # the families phase's prefills: phi3.5-moe (GQA 4) and jamba (GQA 8), hd 128
    ("phi prefill b4 s2048 h32 k8 hd128 causal", (4, 2048, 32, 8, 128), True, 0),
    ("jamba prefill b4 s2048 h64 k8 hd128 causal", (4, 2048, 64, 8, 128), True, 0),
    # llava's 2,880 patches + 2,048 prompt tokens; whisper's encoder over its
    # 1,500 frames, non-causal and ragged against the 128-row tile
    ("llava prefill b4 s4928 h32 k8 hd128 causal", (4, 4928, 32, 8, 128), True, 0),
    ("whisper encoder b4 s1500 h8 k8 hd64 non-causal", (4, 1500, 8, 8, 64), False, 0),
)
# head dims outside the four the kernels took before: Phi-3-mini's prefill
# (hd 96, its window of 2,047 masking key 0 at the last position),
# Gemma-2B's attention (hf:google/gemma-2b: hd 256, 8 heads on 1 KV head)
# and hd 512 (the chunked kernels, past every one-pass width), checked in
# fp32, bf16 and fp16 and timed (the head_dims phase's sweep holds every
# other head dim)
FLASH_HD_SHAPES = (
    ("phi3-mini prefill b4 s2048 h32 k32 hd96 causal window2047", (4, 2048, 32, 32, 96), True,
     2047),
    ("gemma prefill b4 s2048 h8 k1 hd256 causal", (4, 2048, 8, 1, 256), True, 0),
    ("chunked b1 s2048 h8 k8 hd512 causal", (1, 2048, 8, 8, 512), True, 0),
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

    def flash(shape, causal, window, dtype, r=rng):
        B, S, H, K, hd = shape
        q, k, v = (torch.from_numpy(r.normal(size=(B, S, h, hd)).astype(np.float32))
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
        ] + [
            # drawn at first use from a generator of their own (the same
            # values in each type), so the cases above keep their data
            (f"{label} {dt}", Lazy(functools.partial(flash, shape, causal, window,
                                                     getattr(torch, dt),
                                                     np.random.default_rng(shape[-1]))))
            for dt in ("bfloat16", "float16", "float32")
            for label, shape, causal, window in FLASH_HD_SHAPES
        ],
    }
    # the wide phase's shapes at d 784 (``wide_inputs``, drawn on the card;
    # the scorers at a tenth of the members, 38-47 ms a call) and SDCA at
    # bucket 16,384 (the cluster kernel, built on the
    # card; 1 epoch, as the plain version takes ~4 s an epoch there), timed
    # and profiled; the wide phase checks them, the kernels phase skips them
    # (WIDE_PREFIX)
    for name, label, kw in (("ensemble_score", "b8192 k282 n230 d784", {"k": WIDE_TIMING_K}),
                            ("ensemble_score_q8", "b8192 k282 n230 d784", {"k": WIDE_TIMING_K}),
                            ("gram_matvec", "cg l4096 d784", {}),
                            ("rbf_gram_q8", "student b8192 n4096 d784", {})):
        cases[name].append((WIDE_PREFIX + label, Lazy(
            functools.partial(wide_inputs, name, WIDE_FULL_DIM, "cuda", **kw))))
    cases["sdca"].append((WIDE_PREFIX + "ideal emnist g1 b16384 e1", Lazy(
        lambda: ideal_problem_on("cuda", WIDE_IDEAL_SCALE, WIDE_SDCA[-1][0], 1))))
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


_CASES = {}   # "future": the cases being made in a thread while the build runs


def start_cases(ops) -> None:
    """Make ``shared_cases`` in a thread (~16 s of the host's time), beside
    the build phase, whose host mostly waits on nvcc and cuobjdump."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    _CASES["future"] = pool.submit(_make_cases, ops)
    pool.shutdown(wait=False)


@functools.lru_cache(maxsize=1)
def _make_cases(ops):
    import numpy as np

    return kernel_cases(np.random.default_rng(0), ops)


def shared_cases(ops):
    """``kernel_cases`` of a fresh ``default_rng(0)``, made once and shared
    by the kernels, timing and profile phases (``start_cases`` begins it
    during the build)."""
    future = _CASES.get("future")
    return future.result() if future is not None else _make_cases(ops)


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
    registry's tol in fp32; in bf16 and fp16, compared in fp32, at most
    BF16_ATOL + BF16_RTOL |plain| (FP16_RTOL in fp16) element by
    element."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    finite = bool(torch.isfinite(got).all())
    if got.dtype in (torch.bfloat16, torch.float16):
        atol, rtol = flash_tolerance(got.dtype)
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        return err, finite and ok, f"{atol} + 2^{int(math.log2(rtol))} |plain|"
    return err, finite and err <= spec.tol, spec.tol


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

# SASS opcodes counted in each library: tensor-core products, ldmatrix,
# cp.async, TMA tensor loads
SASS_OPS = ("HMMA", "LDSM", "LDGSTS", "UTMALDG")
SASS_REQUIRED = {"sdca": ("UTMALDG",), "flash_attention_tc": ("HMMA", "LDSM", "LDGSTS"),
                 "flash_attention_tc_f16": ("HMMA", "LDSM", "LDGSTS"), "ensemble_score": ("LDGSTS",),
                 "gram_matvec": ("HMMA", "LDSM", "LDGSTS"),
                 "gram_q8": ("HMMA", "LDSM", "LDGSTS"),
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
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(SASS_REQUIRED)) as pool:
        sass = dict(zip(SASS_REQUIRED, pool.map(lambda n: sass_counts(native, n), SASS_REQUIRED)))
    missing = [f"{name}: {op}" for name, ops in SASS_REQUIRED.items() for op in ops
               if sass[name][op] == 0]
    if missing:
        raise AssertionError(f"build: instructions missing from the compiled code: {missing}")
    return {"seconds": secs, "built": sorted(logs), "libs": libs, "sass": sass,
            "build_dir": str(native.build_dir().relative_to(ROOT))}, logs


def phase_kernels(ops, device, names):
    """Every case of every kernel in ``names`` against its plain version;
    all cases run, and the phase fails at the end if any disagreed.
    ``errs`` holds each kernel's largest fp32 error, ``errs[name +
    "/bf16"]`` its bf16 one."""
    import torch

    results, errs, failed = [], {}, []
    t0 = time.perf_counter()
    all_cases = {n: [(label, args) for label, args in c if not label.startswith(WIDE_PREFIX)]
                 for n, c in shared_cases(ops).items() if n in names}
    cases_seconds = time.perf_counter() - t0
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
            key = name + {torch.bfloat16: "/bf16", torch.float16: "/fp16"}.get(got.dtype, "")
            errs[key] = max(errs.get(key, 0.0), err)
            if not ok:
                failed.append(f"{name} [{label}]: max |kernel - plain| = {err} (tol {tol})")
            del got, want, targs
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    out = {"cases_seconds": cases_seconds, "cases": results,
           "determinism": determinism(ops, device, all_cases)}
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


SHARDED_KERNELS = ("batched_rbf_gram", "sdca")   # what each rank of the sharded tier runs


def sharded_round(ds, run_protocol, ops, trace, bucketed, bucketed_seconds):
    """``main``'s round again with ``engine="sharded"`` in this process, on
    a one-rank ``nccl`` world that ``make_sim_mesh`` starts: one shard,
    the bucketed round's ``round_signature`` and AUC bits, the fit and
    SDCA kernels launched."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.sim import make_shard_ctx

    n_shards = make_shard_ctx(device="cuda").n_shards
    tracer = trace.Tracer()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        res = run_protocol(ds, ks=MAIN_KS, random_trials=3, device="cuda", engine="sharded")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    spans = tracer.span_seconds()
    begun, gathers = [], []   # each engine.gather span's seconds, in order
    for e in tracer.events:
        if e["name"] == "engine.gather":
            if e["ph"] == "B":
                begun.append(e["ts"])
            else:
                gathers.append((e["ts"] - begun.pop()) / 1e6)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "n_shards": n_shards,
           "round_seconds": wall, "bucketed_round_seconds": bucketed_seconds,
           "spans": {k: v for k, v in sorted(spans.items())}, "gathers": len(gathers),
           "gather_seconds": {"first": gathers[0] if gathers else None,
                              "median_rest": float(np.median(gathers[1:])) if gathers[1:] else None,
                              "max_rest": max(gathers[1:], default=None),
                              "total": sum(gathers)},
           "signature_equal": round_signature(res) == round_signature(bucketed),
           "aucs_bitwise": auc_values(res).tobytes() == auc_values(bucketed).tobytes(),
           "kernels": counts}
    if n_shards != 1 or "nccl" not in out["backend"]:
        raise AssertionError(f"main [sharded]: {n_shards} shards on {out['backend']}, "
                             "want 1 on nccl")
    if not (out["signature_equal"] and out["aucs_bitwise"]):
        raise AssertionError("main [sharded]: the sharded round's ledger, ids, best k or "
                             "AUCs differ from the bucketed round's")
    idle = [k for k in SHARDED_KERNELS if counts[k] <= 0]
    if idle or not gathers:
        raise AssertionError(f"main [sharded]: kernels {idle} not launched, "
                             f"{len(gathers)} gathers: {counts}")
    return out


def phase_main(make_dataset, run_protocol, ops, trace, must_launch, gram=False,
               sharded=False, **kw):
    """One full-scale emnist round on cuda with ``kw`` (codec, distill),
    then the same round under the profiler. ``must_launch`` names the
    kernels that must have launched at least once in the measured round;
    with ``gram``, rows 1 and 3's device time in the profiled round beside
    the bound of its launches (``gram_round``); with ``sharded``, the
    round on the sharded tier (``sharded_round``)."""
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
    if sharded:
        out["sharded"] = sharded_round(ds, run_protocol, ops, trace, res, wall)
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
POP_PROFILE_DEVICES = 10_000   # the profiled round's population
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


def population_memory_worker(n_devices, chunk):
    """``population_memory`` in a spawned worker: its own process, so its
    own ``tracemalloc`` peak, on two torch threads (it runs beside the
    main process's phases)."""
    import torch

    from repro_torch import sim
    from repro_torch.utils.device import resolve_device

    torch.set_num_threads(2)
    return population_memory(sim, resolve_device("cuda"), n_devices, chunk)


def start_population_memory(memory_devices=POP_MEMORY_DEVICES):
    """(pool, futures): ``population_memory`` at each of ``memory_devices``
    in a spawned worker of its own. ``main`` starts them as soon as the
    kernels are built, so they run beside the phases that check values,
    not times (``kernels``, ``parity``, ``population`` (a))."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(memory_devices), mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(population_memory_worker, n, POP_SCALE["chunk_devices"])
                  for n in memory_devices]


def phase_population(ops, trace, DistillConfig, device, memory=None):
    """(a) parity, (b) the 100,000-device streamed dirichlet round at full
    width (d 16) on cuda with CG distillation on 4,096 ``scenario`` proxy
    rows, then a POP_PROFILE_DEVICES-device round of the same setting under
    the profiler, (c) the streamed pass's traced host memory at
    POP_MEMORY_DEVICES, from the workers of ``memory``
    (``start_population_memory``; started here when not given); (b)
    starts when they are done."""
    import numpy as np
    import torch

    from repro_torch import sim

    pool, futures = memory or start_population_memory()
    with pool:
        out = {"parity": population_parity(sim, trace, DistillConfig)}
        t0 = time.perf_counter()
        memory = [f.result() for f in futures]
        memory_wait = time.perf_counter() - t0

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
    # the busy share from a profiled round of POP_PROFILE_DEVICES devices:
    # the same per-device work as the timed round's, a tenth of its wall
    profiled = dataclasses.replace(cfg, n_devices=POP_PROFILE_DEVICES)
    scale["profile"], _ = profile_call(lambda: sim.run_population(profiled, device="cuda"))
    scale["profile"]["devices"] = POP_PROFILE_DEVICES
    out["scale"] = scale

    small, large = (m["host_peak_bytes"] for m in memory)
    out["memory"] = {"runs": memory, "budget_bytes": POP_MEMORY_BUDGET,
                     "flat": large < max(1.5 * small, small + 8 * 2**20),
                     "wait_after_parity_seconds": memory_wait}
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


# the wide phase: the SVM kernels past their staged limits (the scorers past
# d 220, gram_matvec past d 64, rbf_gram_q8 past d 128, SDCA past bucket
# 12,384), and the emnist round at d 784
WIDE_KERNELS = ("ensemble_score", "ensemble_score_q8", "gram_matvec", "rbf_gram_q8")
WIDE_PREFIX = "wide "                           # kernel_cases' labels of the wide shapes
WIDE_DS = (129, 220, 221, 256, 784, 1024)
# feature dims where a kernel's staged and chunked instantiations both run:
# the chunked one through its private entry against the staged one
WIDE_BOTH = {"ensemble_score": (64, 220), "ensemble_score_q8": (64, 220),
             "gram_matvec": (32, 64), "rbf_gram_q8": (64, 128)}
WIDE_IDEAL_SCALE = 0.1                          # an emnist federation pooling > 16,384 train rows
WIDE_SDCA = ((12_400, 12_416), (16_384, 16_384))   # (ideal rows, bucket) past 12,384
WIDE_SDCA_EPOCHS = 2                            # the plain SDCA's epochs on those buckets
WIDE_ROUND = dict(scale=0.02, ks=(1, 10, 50), random_trials=2)   # tests/test_torch_wide.py's
WIDE_ROUNDS = {"fp32 d784": dict(dim=784),
               "int8 cg d256": dict(dim=256, codec="int8",
                                    distill=dict(proxy_size=1024, solver="cg"))}
WIDE_FULL_DIM = 784                             # emnist's pixels
# a quarter of Table 1's 3,462 writers: at 1.0 the round took 29-38 s of
# the phase and put the script past its 1,200 s on a slow host
WIDE_FULL_SCALE = 0.25
WIDE_TIMING_K = 282                             # the scorers' wide timing rows: a tenth of k 2,821
WIDE_CPU_THREADS = 3                            # torch threads of each of the two cpu workers


def quantize_columns_on(sup):
    """Per-column affine int8 of each (n, d) slab of ``sup`` (..., n, d) on
    its device, as the codec's ``_quantize_columns`` computes it."""
    import torch

    lo, hi = sup.amin(-2, keepdim=True), sup.amax(-2, keepdim=True)
    scale = (hi - lo) / 254.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    zero = (hi + lo) / 2.0
    q = torch.clamp(torch.round((sup - zero) / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale.squeeze(-2).contiguous(), zero.squeeze(-2).contiguous()


def wide_inputs(name, d, device, seed=0, k=2821):
    """``name``'s arguments at the round's shapes with feature dim d, drawn
    on ``device`` (a host draw of the full ensemble at d 1,024 would take
    longer than the checks): the scorers at b 8,192, ``k`` 2,821, n 230
    (``kernel_cases``' "full" shape: normals, coefficients at a trained
    model's scale, gammas 1 / (d u), u in [0.5, 2]; int8 by the codec's
    per-column quantisation); ``gram_matvec`` at the CG's l 4,096 on
    normals at gamma 1 / (d var); ``rbf_gram_q8`` at the student's b 8,192
    against 4,096 int8 supports at gamma 1 / d."""
    import torch

    g = torch.Generator(device=device).manual_seed(1_000 * seed + d)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    if name in ("ensemble_score", "ensemble_score_q8"):
        b, n = 8192, 230
        x, sup = randn(b, d), randn(k, n, d)
        sign = torch.where(rand(k, n) < 0.5, -1.0, 1.0)
        coef = rand(k, n) * sign / (0.01 * n)
        gam = 1.0 / (d * (0.5 + 1.5 * rand(k)))
        if name == "ensemble_score":
            return x, sup, coef, gam
        q, scale, zero = quantize_columns_on(sup)
        del sup
        return x, q, scale, zero, coef, gam
    if name == "gram_matvec":
        xp = randn(4096, d)
        return xp, xp, randn(4096), float(1.0 / (d * float(xp.var())))
    x = randn(8192, d)
    q, scale, zero = quantize_columns_on(randn(4096, d))
    return x, q, scale, zero, 1.0 / d


def wide_private(name):
    """The chunked instantiation's private entry of a lifted kernel."""
    from repro_torch.kernels import ensemble_score, ensemble_score_q8, gram_matvec, rbf_gram_q8

    return {"ensemble_score": ensemble_score.ensemble_score_chunked_cuda,
            "ensemble_score_q8": ensemble_score_q8.ensemble_score_q8_chunked_cuda,
            "gram_matvec": gram_matvec.gram_matvec_chunked_cuda,
            "rbf_gram_q8": rbf_gram_q8.rbf_gram_q8_chunked_cuda}[name]


def wide_sweep(ops, device):
    """(a) Each lifted kernel at every WIDE_DS against its plain version
    (registry tol), one launch counted a call, two launches bitwise equal;
    and where both instantiations run (WIDE_BOTH), the chunked one through
    its private entry against the staged one: bitwise for the scorers and
    rbf_gram_q8, within the tol for gram_matvec, whose chunked route runs
    the cross term on the tensor cores (PERF.md section 6)."""
    import torch

    rows, failed = [], []
    for name in WIDE_KERNELS:
        spec = ops.KERNEL_REGISTRY[name]
        for d in sorted(set(WIDE_DS) | set(WIDE_BOTH[name])):
            args = wide_inputs(name, d, device)
            t0 = time.perf_counter()
            row = {"kernel": name, "d": d}
            if d in WIDE_DS:
                before = spec.counter.count
                got = spec.kernel(*args)
                torch.cuda.synchronize()
                row["launched"] = spec.counter.count - before
                want = spec.plain(*args)
                err, ok, tol = agreement(spec, got, want)
                row.update(max_abs_err=err, tol=tol,
                           bitwise_twice=bool(torch.equal(got, spec.kernel(*args))))
                if not (ok and row["bitwise_twice"] and row["launched"] == 1):
                    failed.append(f"{name} d{d}: {row}")
                del want
            else:
                got = spec.kernel(*args)
            if d in WIDE_BOTH[name]:
                chunked = wide_private(name)(*args)
                gap = float((chunked - got).abs().max())
                row["chunked_vs_staged_max_abs"] = gap
                if name == "gram_matvec" and not gap <= spec.tol:
                    failed.append(f"{name} d{d}: chunked {gap} from staged > {spec.tol}")
                if name != "gram_matvec" and not torch.equal(chunked, got):
                    failed.append(f"{name} d{d}: chunked != staged bitwise (gap {gap})")
                del chunked
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            del got, args
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("wide (a): " + "; ".join(failed))
    return rows


def ideal_problem_on(device, scale, cap, epochs):
    """``ops.make_ideal_sdca_problem``'s problem (``train_svm``'s padding
    of the pooled ideal's ``cap`` rows at ``scale``, the Gram by the plain
    version) built on ``device``: a host Gram of 16,384 rows takes
    seconds."""
    import torch

    from repro_torch.core.svm import SDCA_BUCKET, default_gamma
    from repro_torch.kernels.rbf_gram import rbf_gram_plain

    x, y, _, _ = wide_ideal_rows(scale, cap)
    n = len(y)
    b = max(-(-n // SDCA_BUCKET) * SDCA_BUCKET, SDCA_BUCKET)
    xg = torch.from_numpy(x).to(device)
    K = torch.zeros((1, b, b), dtype=torch.float32, device=device)
    K[0, :n, :n] = rbf_gram_plain(xg, xg, default_gamma(x))
    yp = torch.ones((1, b), dtype=torch.float32, device=device)
    yp[0, :n] = torch.from_numpy(y).to(device)
    return K, yp, torch.tensor([n], dtype=torch.int32, device=device), 0.01, epochs


WIDE_SDCA_CHECK_EPOCHS = 4   # the emnist ideal at b 2048 against the plain version
WIDE_SDCA_GROUP_CUT = 12_000  # the second member of the b 12,416 group: the Gram cut to 12,000 rows


def wide_sdca(ops, device):
    """SDCA past the shared-memory bucket, where the cluster kernel runs:
    the pooled emnist ideal at WIDE_SDCA's rows and buckets within the
    registry's 1e-5 of the plain version at WIDE_SDCA_EPOCHS epochs (padding
    0, twice bitwise), each bucket's ms a call (CUDA events, one warm
    launch) and ns a step; at bucket 12,416 a device's alphas the same bits
    alone and as either member of a group of 2 (the ideal and its Gram cut
    to WIDE_SDCA_GROUP_CUT rows); and the cluster kernel through its
    private entry within the tol of the one-block kernel and of the plain
    version where both run: the g256 b64 group (20 epochs) and the emnist
    ideal at bucket 2,048 (WIDE_SDCA_CHECK_EPOCHS epochs)."""
    import numpy as np
    import torch

    from repro_torch.kernels.sdca import CLUSTER, sdca_global_cuda

    spec = ops.KERNEL_REGISTRY["sdca"]
    rows, group = [], None
    for cap, bucket in WIDE_SDCA:
        t0 = time.perf_counter()
        args = ideal_problem_on(device, WIDE_IDEAL_SCALE, cap, WIDE_SDCA_EPOCHS)
        if tuple(args[0].shape) != (1, bucket, bucket):
            raise AssertionError(f"wide sdca: bucket {tuple(args[0].shape)} != {bucket}")
        got = spec.kernel(*args)
        again = spec.kernel(*args)
        ms = _time_ms(lambda: spec.kernel(*args), 1)
        want = spec.plain(*args)
        err, ok, tol = agreement(spec, got, want)
        pad = float(got[0, cap:].abs().max()) if cap < bucket else 0.0
        interior = int(((want > 0) & (want < 1)).sum())
        steps = WIDE_SDCA_EPOCHS * cap
        rows.append({"rows": cap, "bucket": bucket, "epochs": WIDE_SDCA_EPOCHS,
                     "cluster_ctas": CLUSTER, "ms": ms, "ns_per_step": 1e6 * ms / steps,
                     "max_abs_err": err, "tol": tol, "pad_max": pad,
                     "bitwise_twice": bool(torch.equal(got, again)),
                     "interior_alphas": interior, "seconds": time.perf_counter() - t0})
        if not ok or pad != 0.0 or not rows[-1]["bitwise_twice"]:
            raise AssertionError(f"wide sdca b{bucket}: {rows[-1]}")
        if group is None:   # the first bucket: alone and in a group of 2, one epoch
            K, y, n_real, lam, _ = args
            cut = torch.tensor([WIDE_SDCA_GROUP_CUT], dtype=torch.int32, device=device)
            alone = [spec.kernel(K, y, n, lam, 1)[0] for n in (n_real, cut)]
            pair = spec.kernel(K.expand(2, -1, -1).contiguous(), y.expand(2, -1).contiguous(),
                               torch.cat((n_real, cut)), lam, 1)
            group = {"bucket": bucket, "rows": [cap, WIDE_SDCA_GROUP_CUT],
                     "alone_equals_group": [bool(torch.equal(a, pair[i]))
                                            for i, a in enumerate(alone)]}
            del pair, alone
            if not all(group["alone_equals_group"]):
                raise AssertionError(f"wide sdca: alone != in a group of 2: {group}")
        del args, got, again, want
        torch.cuda.empty_cache()
    both = []
    rng = np.random.default_rng(0)
    for label, args in (("group g256 b64", ops.make_sdca_problem(
            rng, g=256, b=64, d=32, n_real=rng.integers(33, 65, size=256))),
            (f"ideal emnist g1 b2048 e{WIDE_SDCA_CHECK_EPOCHS}",
             ops.make_ideal_sdca_problem(seed=0, epochs=WIDE_SDCA_CHECK_EPOCHS))):
        targs = to_device(args, device)
        cluster = sdca_global_cuda(*targs)
        errs = {side: agreement(spec, cluster, ref)[:2] for side, ref in
                (("one_block", spec.kernel(*targs)), ("plain", spec.plain(*targs)))}
        both.append({"case": label, **{f"max_abs_err_vs_{k}": e for k, (e, _) in errs.items()}})
        if not all(ok for _, ok in errs.values()):
            raise AssertionError(f"wide sdca: the cluster kernel at [{label}]: {both[-1]}")
    return {"buckets": rows, "group_of_2": group, "cluster_where_both_run": both}


@functools.lru_cache(maxsize=1)
def wide_pool(scale):
    """The emnist federation at ``scale``: its devices' train splits pooled
    and their test splits pooled, as ``ops.ideal_rows`` pools them, made
    once a process (the SDCA buckets, the ideal and the timing case share
    it: a federation of 40,000 rows takes seconds on the host)."""
    import numpy as np

    from repro_torch.data import make_dataset
    from repro_torch.data.partition import derive_device_seed, split_train_test_val

    ds = make_dataset("emnist", seed=0, scale=scale)
    splits = [split_train_test_val(dev, seed=derive_device_seed(0, i))
              for i, dev in enumerate(ds.devices)]
    return tuple(np.concatenate([getattr(sp[part], a) for sp in splits])
                 for part in ("train", "test") for a in ("x", "y"))


def wide_ideal_rows(scale, cap):
    """``ops.ideal_rows(seed=0, scale, cap)``'s ``cap`` train rows (drawn as
    it draws them) and the federation's pooled test rows."""
    import numpy as np

    x, y, xt, yt = wide_pool(scale)
    if len(y) > cap:
        idx = np.random.default_rng(0).choice(len(y), cap, replace=False)
        x, y = x[idx], y[idx]
    return np.ascontiguousarray(x, np.float32), y, xt, yt


def wide_round(kw, round_kw, device):
    """One of WIDE_ROUNDS (``kw``) at ``round_kw`` (WIDE_ROUND) on
    ``device``: (result, seconds)."""
    from repro_torch.core.protocol import run_protocol
    from repro_torch.data.federated import make_emnist_like
    from repro_torch.distill import DistillConfig

    kw = dict(kw)
    dim, distill = kw.pop("dim"), kw.pop("distill", None)
    if distill:
        kw["distill"] = DistillConfig(**distill)
    ds = make_emnist_like(seed=0, scale=round_kw["scale"], dim=dim)
    t0 = time.perf_counter()
    res = run_protocol(ds, ks=round_kw["ks"], random_trials=round_kw["random_trials"],
                       device=device, **kw)
    return res, time.perf_counter() - t0


def wide_cpu_rounds(threads, rounds, round_kw):
    """``rounds`` (WIDE_ROUNDS) on the cpu, in a worker process beside the
    card's work: their signatures, AUCs and seconds."""
    import torch

    torch.set_num_threads(threads)
    out = {}
    for label, kw in rounds.items():
        res, secs = wide_round(kw, round_kw, "cpu")
        out[label] = {"signature": round_signature(res), "aucs": auc_values(res),
                      "seconds": secs}
    return out


def wide_cpu_ideal(threads, scale, cap):
    """The ideal's full solve on the cpu (``train_svm`` through the plain
    versions), in a worker process: its AUC on the pooled test rows, its
    coefficients and seconds."""
    import torch

    from repro_torch.core.svm import train_svm, validation_auc

    torch.set_num_threads(threads)
    x, y, xt, yt = wide_ideal_rows(scale, cap)
    t0 = time.perf_counter()
    model = train_svm(x, y, device="cpu")
    return {"auc": validation_auc(model, xt, yt), "coef": model.coef,
            "seconds": time.perf_counter() - t0}


def wide_federation(scale, dim):
    """The emnist federation at ``dim``, drawn in a thread while the card
    runs (a) (a worker process took longer to send its 1.25 GB back than
    to draw it): (dataset, seconds)."""
    from repro_torch.data.federated import make_emnist_like

    t0 = time.perf_counter()
    ds = make_emnist_like(seed=0, scale=scale, dim=dim)
    return ds, time.perf_counter() - t0


def wide_full_round(ops, trace, ds, device):
    """(c) of the wide phase: the emnist round on ``ds`` (d 784, fp32) on
    ``device``, traced: its wall seconds, spans, AUCs, best k, launches and
    each kernel's summed launch times (the tracer's CUDA events, inside
    the spans). Raises if an AUC is not finite or lies outside [0, 1].
    ``tools/wide_round.py`` runs it at Table 1's full scale."""
    import numpy as np
    import torch

    from repro_torch.core.protocol import run_protocol

    before = ops.launch_counts()
    tracer = trace.Tracer()
    t0 = time.perf_counter()
    with trace.use_tracer(tracer):
        res = run_protocol(ds, ks=MAIN_KS, random_trials=3, device=device)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    aucs = auc_values(res)
    kernel_s = collections.Counter()   # each launch's CUDA-event time, inside the spans
    for e in tracer.events:
        if e.get("cat") == "kernel":
            kernel_s[e["name"][len("kernel."):]] += e["args"]["dur_s"]
    out = {"dim": ds.devices[0].x.shape[1], "devices": ds.n_devices,
           "samples": int(sum(dv.n for dv in ds.devices)), "round_seconds": wall,
           "spans": {k: v for k, v in sorted(tracer.span_seconds().items())},
           "kernel_seconds": dict(sorted(kernel_s.items())),
           "local_mean_auc": res.local_mean_auc, "ideal_mean_auc": res.ideal_mean_auc,
           "full_ensemble_auc": res.full_ensemble_auc, "best": res.best,
           "launches": {k: after[k] - before[k] for k in after}}
    if not np.all(np.isfinite(aucs)) or aucs.min() < 0.0 or aucs.max() > 1.0:
        raise AssertionError("wide (c): AUCs not finite or outside [0, 1]")
    return out


def phase_wide(ops, trace, device):
    """The SVM path past the kernels' staged limits. From the start two
    spawned workers run the cpu rounds (``wide_cpu_rounds``) and the cpu
    ideal (``wide_cpu_ideal``), and from the sweep on a thread draws the
    d 784 federation for (c). (a) SDCA past bucket 12,384
    (``wide_sdca``: its last
    bucket is the ideal's 16,384 rows below, ``train_svm``'s SDCA problem,
    at 2 epochs against the plain version); ``wide_sweep``. Then,
    launches counted from
    0: (b) WIDE_ROUNDS on cuda
    against the cpu's (ledgers, ids and best k equal, AUCs within 1e-4);
    (c) ``wide_full_round`` on the emnist federation at d 784 and
    WIDE_FULL_SCALE; (d) ``train_svm`` on the ideal's
    16,384 rows on cuda (bucket 16,384: the SDCA cluster), its AUC on the
    pooled test rows within 1e-4 of the cpu solve's. Every lifted kernel
    must launch in (b)-(d)."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    from repro_torch.core.svm import SDCA_BUCKET, train_svm, validation_auc

    out = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as drawer:
        ideal_future = pool.submit(wide_cpu_ideal, WIDE_CPU_THREADS, WIDE_IDEAL_SCALE,
                                   WIDE_SDCA[-1][0])
        rounds_future = pool.submit(wide_cpu_rounds, WIDE_CPU_THREADS, WIDE_ROUNDS, WIDE_ROUND)
        # the plain SDCA's host-bound loop first, then the drawing thread
        # beside the sweep, which mostly waits on the card
        t0 = time.perf_counter()
        out["sdca"] = wide_sdca(ops, device)
        out["sdca_seconds"] = time.perf_counter() - t0
        fed_future = drawer.submit(wide_federation, WIDE_FULL_SCALE, WIDE_FULL_DIM)
        t0 = time.perf_counter()
        out["sweep"] = wide_sweep(ops, device)
        out["sweep_seconds"] = time.perf_counter() - t0
        x, y, xt, yt = wide_ideal_rows(WIDE_IDEAL_SCALE, WIDE_SDCA[-1][0])
        n = len(y)
        if n != WIDE_SDCA[-1][1] or n % SDCA_BUCKET:
            raise AssertionError(f"wide: the ideal has {n} rows, want {WIDE_SDCA[-1][1]}")

        # the main path: every lifted kernel launched, counted from 0
        ops.reset_launch_counts()
        cuda_rounds = {}
        for label, kw in WIDE_ROUNDS.items():
            cuda_rounds[label] = wide_round(kw, WIDE_ROUND, device)
        t0 = time.perf_counter()
        ds, gen_s = fed_future.result()
        wait_s = time.perf_counter() - t0
        out["full"] = {"scale": WIDE_FULL_SCALE, "generate_seconds": gen_s,
                       "generate_wait_seconds": wait_s,
                       **wide_full_round(ops, trace, ds, device)}
        del ds
        t0 = time.perf_counter()
        model = train_svm(x, y, device=device)
        ideal_auc = validation_auc(model, xt, yt)
        torch.cuda.synchronize(device)
        ideal_s = time.perf_counter() - t0
        out["kernels"] = ops.launch_counts()

        cpu = rounds_future.result()
        cpu["ideal"] = ideal_future.result()
    for label, (res, secs) in cuda_rounds.items():
        same = round_signature(res) == cpu[label]["signature"]
        diff = float(np.abs(auc_values(res) - cpu[label]["aucs"]).max())
        out[f"round {label}"] = {"cuda_seconds": secs, "cpu_seconds": cpu[label]["seconds"],
                                 "ledger_ids_best_k_equal": same, "max_auc_diff": diff,
                                 "best": res.best}
        if not same or not diff <= AUC_TOL:
            raise AssertionError(f"wide (b) {label}: cuda against cpu: {out[f'round {label}']}")
    gap = abs(ideal_auc - cpu["ideal"]["auc"])
    out["ideal"] = {"rows": n, "bucket": n, "cuda_auc": ideal_auc, "cpu_auc": cpu["ideal"]["auc"],
                    "auc_diff": gap, "coef_max_abs_diff": float(np.abs(
                        model.coef - cpu["ideal"]["coef"]).max()),
                    "cuda_seconds": ideal_s, "cpu_seconds": cpu["ideal"]["seconds"]}
    if not gap <= AUC_TOL:
        raise AssertionError(f"wide (d): the ideal's AUC {ideal_auc} on cuda, "
                             f"{cpu['ideal']['auc']} on cpu")
    idle = [k for k in WIDE_KERNELS + ("sdca",) if out["kernels"][k] <= 0]
    if idle:
        raise AssertionError(f"wide: lifted kernels never launched on the main path: {idle}")
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


def profile_call(fn, top=20, functions=(), cpu_ops=True):
    """``fn()`` under ``torch.profiler``: the device's busy seconds (the
    sum of every kernel and copy on the card; one stream, so they do not
    overlap) against the call's wall seconds, and the device time by
    kernel; with ``functions`` (names of ``DEVICE_FUNCTIONS``), each one's
    launches and device seconds, summed over its instantiations. The
    profiler slows the host, so this wall is longer than an unprofiled
    one's; the busy share is that of the profiled call. ``cpu_ops=False``
    records the card's activity alone (no host op events: a call of
    ~100,000 launches reads back in seconds, not minutes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu_ops else []
    t0 = time.perf_counter()
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    ranked = sorted(on_card, key=lambda e: -e.self_device_time_total)[:top]
    out = {
        "wall_seconds": wall, "device_seconds": busy,
        "device_launches": sum(e.count for e in on_card),
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
DEVICE_SLOW_MS = 100.0   # a call this long fills a window in DEVICE_SLOW_CALLS calls
DEVICE_SLOW_CALLS = 4
DEVICE_CHECK_MS = 1.0    # a call this long by events is device-bound: see device_time


def device_time(fn, args, reps, call_ms=0.0):
    """At least ``reps`` back-to-back calls of ``fn(*args)`` (warm) under
    the profiler, read as ``profile_call`` reads it: (device ms a call,
    the kernels' launches the profiler recorded, each kernel's device ms a
    call by name, the windows' calls). Nothing else runs on the card in the window; each kernel's
    device time over its own count, summed over the call's kernels, is the
    call's device time (the profiler does not record the window's first
    few launches, so the calls made are no divisor). A call of ``call_ms``
    >= DEVICE_SLOW_MS takes DEVICE_SLOW_CALLS calls a window (the wide
    shapes). A window that recorded no kernel, or one whose device time is
    under half the event-timed ``call_ms`` of a call of DEVICE_CHECK_MS or
    more (the profiler lost one of the call's kernels whole), is followed
    by one 4x longer; the largest reading stands."""
    calls = max(reps, DEVICE_SLOW_CALLS if call_ms >= DEVICE_SLOW_MS else DEVICE_CALLS)
    windows, best = [], None
    for _ in range(DEVICE_WINDOWS):
        prof, _ = profile_call(lambda: [fn(*args) for _ in range(calls)], top=8)
        kernels = prof["by_kernel"]
        windows.append(calls)
        if kernels:
            split = collections.Counter()   # names are cut at 100 characters: add any alike
            for k in kernels:
                split[k["name"]] += 1e3 * k["seconds"] / k["count"]
            ms = sum(split.values())
            if best is None or ms > best[0]:
                best = (ms, sum(k["count"] for k in kernels), dict(sorted(split.items())))
            if call_ms < DEVICE_CHECK_MS or ms >= 0.5 * call_ms:
                break
        calls *= 4
    if best is None:
        raise AssertionError(f"timing: the profiler recorded no kernel in windows of "
                             f"{windows} calls")
    return (*best, windows)


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
    from repro_torch.models import cache_nbytes, cache_spec, forward_prefill, init_cache
    from repro_torch.models import init_params, param_count

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
    cache_bytes = cache_nbytes(cache_spec(cfg, SERVE_BATCH, kv_len))

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


# the head_dims phase: flash attention at every head dim and float dtype
# the reference takes, and Phi-3-mini's widths (hd 96) served on the card
# (hf:microsoft/Phi-3-mini-4k-instruct, config.json; built here with the
# port's ModelConfig, not one of the repo's configurations)
PHI3_MINI = dict(name="phi3-mini-4k", family="dense", n_layers=32, d_model=3072, n_heads=32,
                 n_kv_heads=32, head_dim=96, d_ff=8192, vocab=32064, rope_theta=10000.0,
                 rms_eps=1e-5, sliding_window=2047,
                 source="hf:microsoft/Phi-3-mini-4k-instruct (config.json)")
HD_SWEEP = (1, 8, 24, 72, 80, 96, 100, 160, 192, 256, 320, 512)
HD_DTYPES = ("float32", "bfloat16", "float16")
# (label, (B, Sq, Skv, H, K), causal, window): 1 and 4 query heads per KV
# head, lengths off the 64- and 128-row tiles
HD_MASKS = (
    ("causal rep4 s200", (1, 200, 200, 4, 1), True, 0),
    ("causal window77 rep1 s333", (2, 333, 333, 2, 2), True, 77),
    ("non-causal rep1 s200", (1, 200, 200, 2, 2), False, 0),
    ("non-causal window50 rep4 s333 ragged", (1, 333, 333, 4, 1), False, 50),
)
HD_PARITY = dict(n_layers=2, batch=2, prompt=200, gen=8)   # (b): lm_parity's sizes
HD_CPU_THREADS = 4                                         # (b)'s cpu worker
# a 16-bit output keeps 8 (bf16) or 11 (fp16) significant bits: two fp32
# results a rounding error apart may round one step apart, at most 2^-7 or
# 2^-10 of the value; the absolute term covers the fp32 difference near 0
FP16_RTOL = 2.0 ** -10
# (c): the whole model's logits through the kernel against plain
# attention's, the largest gap over the largest |logit|. Both routes round
# every layer's output to bf16 (a step is 2^-8 to 2^-7 of a value), so 32
# layers apart they differ by a few steps at the logits' scale: the bar
# leaves room for a few more, and a layer whose attention output is lost
# moves the logits by far more
PHI3_LOGIT_RTOL = 2.0 ** -4


def flash_tolerance(dtype):
    """(atol, rtol) of the kernel against its plain version in the output
    type: fp32 (and fp64, computed in fp32) the registry's 2e-5; bf16 and
    fp16 1e-4 + 2^-7 or 2^-10 of the plain value."""
    import torch

    if dtype == torch.bfloat16:
        return BF16_ATOL, BF16_RTOL
    if dtype == torch.float16:
        return BF16_ATOL, FP16_RTOL
    return 2e-5, 0.0


def flash_case(ops, q, k, v, causal, window):
    """One call of the kernel against its plain version on the same card
    tensors: launches of the call, two launches bitwise equal, the largest
    error and whether every element is within its tolerance."""
    import torch

    spec = ops.KERNEL_REGISTRY["flash_attention"]
    before = spec.counter.count
    got = spec.kernel(q, k, v, causal, window)
    launches = spec.counter.count - before
    again = spec.kernel(q, k, v, causal, window)
    want = spec.plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    atol, rtol = flash_tolerance(got.dtype)
    diff = (got.float() - want.float()).abs()
    ok = (got.dtype == want.dtype == q.dtype and got.shape == want.shape
          and bool(torch.isfinite(got).all())
          and bool((diff <= atol + rtol * want.float().abs()).all()))
    return {"max_abs_err": float(diff.max()), "tol": [atol, rtol], "ok": ok,
            "bitwise_twice": bool(torch.equal(got, again)), "launches": launches}


def head_dim_sweep(ops, device):
    """(a) every hd of HD_SWEEP in fp32, bf16 and fp16 under every mask of
    HD_MASKS, then mixed types, float64, a transposed q, a bf16 q 2 bytes
    off a 16-byte boundary and B x H past 65,535; every case within its
    tol, two launches bitwise equal, one launch a call."""
    import numpy as np
    import torch

    rng = np.random.default_rng(30)

    def draw(B, S, h, hd):
        return torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32)).to(device)

    rows, failed = [], []

    def run(label, q, k, v, causal, window):
        row = {"case": label, "q": [str(q.dtype), list(q.shape)], "k": str(k.dtype),
               **flash_case(ops, q, k, v, causal, window)}
        rows.append(row)
        if not (row["ok"] and row["bitwise_twice"] and row["launches"] == 1):
            failed.append(f"{label}: {row}")

    for hd in HD_SWEEP:
        for mask, (B, Sq, Skv, H, K), causal, window in HD_MASKS:
            q32, k32, v32 = draw(B, Sq, H, hd), draw(B, Skv, K, hd), draw(B, Skv, K, hd)
            for dt in HD_DTYPES:
                dtype = getattr(torch, dt)
                run(f"hd{hd} {mask} {dt}", q32.to(dtype), k32.to(dtype), v32.to(dtype), causal,
                    window)
    for hd in (24, 96, 320):
        q32, k32, v32 = draw(1, 200, 4, hd), draw(1, 200, 2, hd), draw(1, 200, 2, hd)
        run(f"hd{hd} mixed bf16 q fp32 k v", q32.bfloat16(), k32, v32, True, 0)
        run(f"hd{hd} mixed fp16 q bf16 k fp32 v", q32.half(), k32.bfloat16(), v32, True, 33)
        run(f"hd{hd} float64", q32.double(), k32.double(), v32.double(), False, 0)
        # (B, H, S, hd) storage seen as (B, S, H, hd): a non-contiguous view
        qt = draw(1, 4, 200, hd).transpose(1, 2)
        if qt.is_contiguous():
            raise AssertionError("head_dims (a): the transposed q is contiguous")
        run(f"hd{hd} transposed q bf16", qt.bfloat16(), k32.bfloat16(), v32.bfloat16(), True, 0)
        for dt in ("bfloat16", "float16"):
            dtype = getattr(torch, dt)
            buf = torch.empty(q32.numel() + 8, dtype=dtype, device=device)
            off = buf[1:1 + q32.numel()].view(q32.shape)   # 2 bytes off 16
            off.copy_(q32.to(dtype))
            run(f"hd{hd} q 2 bytes off 16 {dt}", off, k32.to(dtype), v32.to(dtype), True, 0)
    # B x H = 1,100 x 64 = 70,400 (B, H past one grid dimension's 65,535)
    q32, k32, v32 = draw(1100, 3, 64, 8), draw(1100, 3, 16, 8), draw(1100, 3, 16, 8)
    for dt in HD_DTYPES:
        dtype = getattr(torch, dt)
        run(f"b1100 h64 k16 s3 hd8 {dt}", q32.to(dtype), k32.to(dtype), v32.to(dtype), True, 0)
    errs = {}
    for row in rows:
        key = row["q"][0].replace("torch.", "")
        errs[key] = max(errs.get(key, 0.0), row["max_abs_err"])
    if failed:
        raise AssertionError("head_dims (a): " + "; ".join(failed))
    return {"cases": len(rows), "max_abs_err": errs, "rows": rows}


def phi3_config(**kw):
    """Phi-3-mini's widths as the port's ModelConfig (PHI3_MINI), with the
    flash kernel (``use_pallas``)."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**{**PHI3_MINI, "use_pallas": True, **kw})


def phi3_serve_run(device, threads=0):
    """(b)'s one side: Phi-3-mini's widths at HD_PARITY's depth in fp32,
    parameters drawn on the cpu from seed 0 (so both sides hold the same
    values), 2 prompts of 200 tokens and 8 greedy tokens through
    ``serve_prompts``, then the prompts' prefill logits: (tokens, last
    logits, seconds, flash launches). The cpu side runs in a spawned
    worker (``threads`` torch threads) beside (a)."""
    import numpy as np
    import torch

    from repro_torch.data import make_federated_lm_data
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import forward_prefill, init_cache, init_params

    if threads:
        torch.set_num_threads(threads)
    p = HD_PARITY
    cfg = phi3_config(n_layers=p["n_layers"], dtype=torch.float32)
    clients = make_federated_lm_data(p["batch"], cfg.vocab, p["prompt"] + 8, seed=0)
    prompts = np.stack([c[:p["prompt"]] for c in clients]).astype(np.int32)
    params = init_params(cfg, seed=0, device="cpu").to(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        tokens, _ = serve_prompts(cfg, params, prompts, gen=p["gen"])
        logits, _ = forward_prefill(params, cfg, {"tokens": prompts},
                                    init_cache(cfg, p["batch"], p["prompt"], device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return (tokens, logits.float().cpu().numpy(), time.perf_counter() - t0,
            ops.launch_counts()["flash_attention"])


def phi3_full(ops, device):
    """(c) Phi-3-mini whole (32 layers, 3.82 B parameters) in bf16 with the
    flash kernel through ``serve_prompts``: 4 prompts of 2,048 tokens (the
    window of 2,047 masks key 0 at the last position), 32 greedy tokens,
    cold (counted: one flash launch a layer) and warm; then the NLL of 4
    windows of 2,049 tokens (2,048 fed: the window masks there too)
    through ``forward_train`` with the kernel and with plain attention."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import (cache_nbytes, cache_spec, forward_train, init_params, lm_loss,
                                    param_count)

    cfg = phi3_config()
    _free_card()
    steps = {}
    steps["init"], params = _sync_seconds(lambda: init_params(cfg, seed=0, device=device))
    n_params = sum(p.numel() for p in params.parameters())
    prompts = _prompts(cfg.vocab)
    kv_len = SERVE_PROMPT + SERVE_GEN + 1
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    wall, (tokens, sched) = _sync_seconds(lambda: serve_prompts(cfg, params, prompts, SERVE_GEN))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    steps["warm_serve"], (warm_tokens, warm_sched) = _sync_seconds(
        lambda: serve_prompts(cfg, params, prompts, SERVE_GEN))
    cold, warm = sched.score_fn.timings[0], warm_sched.score_fn.timings[0]
    windows = torch.from_numpy(_prompts(cfg.vocab, SERVE_PROMPT + 1)).to(device).long()
    nll, logits = {}, {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas=False))):
        with torch.no_grad():
            steps["nll_" + name], (logits[name], _) = _sync_seconds(
                lambda c=c: forward_train(params, c, {"tokens": windows[:, :-1]}))
        nll[name] = float(lm_loss(logits[name], windows[:, 1:]))
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(logits["kernel"], logits["plain"]))
    scale = max(float(b.float().abs().max()) for b in logits["plain"])
    del logits, params
    _free_card()
    out = {
        "config": {k: v for k, v in PHI3_MINI.items()}, "dtype": "bfloat16", "params": n_params,
        "param_count": param_count(cfg), "requests": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
        "gen": SERVE_GEN, "cache_bytes": cache_nbytes(cache_spec(cfg, SERVE_BATCH, kv_len)),
        "peak_memory_bytes": peak, "cold_serve_wall_seconds": wall, "step_seconds": steps,
        "cold": {"prefill_seconds": cold["prefill_seconds"],
                 "decode_ms_per_step": 1e3 * cold["decode_seconds"] / SERVE_GEN},
        "warm": {"prefill_seconds": warm["prefill_seconds"],
                 "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / warm["prefill_seconds"],
                 "decode_ms_per_step": 1e3 * warm["decode_seconds"] / SERVE_GEN},
        "kernels": counts, "nll_windows": list(windows.shape), "prompt_nll": nll,
        "kernel_vs_plain_logits_max_abs_diff": gap, "logits_scale": scale,
        "logits_tol": PHI3_LOGIT_RTOL * scale, "tokens_head": tokens[:, :8].tolist(),
    }
    if n_params != param_count(cfg):
        raise AssertionError(f"head_dims (c): {n_params} parameters, config says "
                             f"{param_count(cfg)}")
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"head_dims (c): tokens {tokens.shape} outside the vocabulary")
    if not np.array_equal(warm_tokens, tokens):
        raise AssertionError("head_dims (c): a repeat of the serve generated other tokens")
    if counts["flash_attention"] != cfg.n_layers or sum(counts.values()) != cfg.n_layers:
        raise AssertionError(f"head_dims (c): launches {counts}, want {cfg.n_layers} flash "
                             "(one a layer) and no other")
    if not all(math.isfinite(v) for v in nll.values()) or \
            not abs(nll["kernel"] - nll["plain"]) <= BF16_RTOL * abs(nll["plain"]):
        raise AssertionError(f"head_dims (c): NLL through the kernel {nll['kernel']} against "
                             f"plain attention {nll['plain']}")
    if not gap <= PHI3_LOGIT_RTOL * scale:
        raise AssertionError(f"head_dims (c): logits through the kernel {gap} off plain "
                             f"attention's, over {PHI3_LOGIT_RTOL} of their scale {scale}")
    return out


def phase_head_dims(ops, device):
    """Flash attention at every head dim and float type, and Phi-3-mini's
    widths. A spawned worker runs (b)'s cpu side from the start. (a)
    ``head_dim_sweep``; (b)
    Phi-3-mini's widths at 2 layers in fp32, the flash kernel on cuda
    against its plain version on cpu (``phi3_serve_run``): tokens equal,
    last-position logits within LM_LOGIT_TOL; (c) ``phi3_full``."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    out = {}
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_future = pool.submit(phi3_serve_run, "cpu", HD_CPU_THREADS)
        t0 = time.perf_counter()
        out["sweep"] = head_dim_sweep(ops, device)
        out["sweep_seconds"] = time.perf_counter() - t0
        tokens, logits, secs, launches = phi3_serve_run(device)
        t0 = time.perf_counter()
        cpu_tokens, cpu_logits, cpu_secs, cpu_launches = cpu_future.result()
        wait_s = time.perf_counter() - t0
    diff = float(np.abs(logits - cpu_logits).max())
    p = HD_PARITY
    out["parity"] = {
        "n_layers": p["n_layers"], "dtype": "float32", "prompts": [p["batch"], p["prompt"]],
        "gen": p["gen"], "tokens_equal": bool(np.array_equal(tokens, cpu_tokens)),
        "max_logit_diff": diff, "tol": LM_LOGIT_TOL,
        "seconds": {"cuda": secs, "cpu": cpu_secs, "cpu_wait": wait_s},
        "flash_launches": {"cuda": launches, "cpu": cpu_launches}, "tokens": tokens.tolist()}
    if not out["parity"]["tokens_equal"]:
        raise AssertionError(f"head_dims (b): cuda tokens {tokens.tolist()} != cpu tokens "
                             f"{cpu_tokens.tolist()}")
    if not (np.all(np.isfinite(logits)) and diff <= LM_LOGIT_TOL):
        raise AssertionError(f"head_dims (b): logits differ by {diff} > {LM_LOGIT_TOL}")
    # one prefill in serve_prompts and one more after it, each a launch a layer
    if cpu_launches != 0 or launches != 2 * p["n_layers"]:
        raise AssertionError(f"head_dims (b): flash launches {launches} on cuda, "
                             f"{cpu_launches} on cpu")
    out["full"] = phi3_full(ops, device)
    out["kernels"] = out["full"]["kernels"]
    torch.cuda.empty_cache()
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
    (drawn on the card, a copy moved to the cpu) take 3 steps of
    ``make_optimizer(1e-3)`` on the same windows on cuda and on cpu, the
    cpu run's large tensors reusing host memory (``reused_host_memory``)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, make_train_step, param_tree

    tp = TRAIN_PARITY
    cfg = get_config(TRAIN_ARCH).replace(n_layers=tp["n_layers"], dtype=torch.float32)
    windows = _windows(cfg.vocab, tp["batch"], tp["seq"], tp["steps"])
    params = init_params(cfg, seed=0, device=device, trainable=True)
    copies = {"cuda": params, "cpu": copy.deepcopy(params).cpu()}
    runs = {}
    for dev, p in copies.items():
        opt = make_optimizer(tp["lr"])
        state = opt.init(param_tree(p))
        step = make_train_step(cfg, opt)
        ops.reset_launch_counts()
        losses, t0 = [], time.perf_counter()
        with reused_host_memory() if dev == "cpu" else contextlib.nullcontext():
            for w in windows:
                t = torch.from_numpy(w).to(p.embed.device)
                p, state, m = step(p, state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
                losses.append(float(m["loss"]))
            del state
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
    return {"parity": train_parity(ops, device), "full": train_full(ops, trace, device),
            "mesh": train_mesh(ops, trace, device)}


# train (c): the LM mesh on one card, a 1 x 1 mesh; the serve part at
# the serve phase's shape, 8 greedy tokens
MESH_TRAIN = ["--steps", "4", "--batch", "4", "--seq", "1024"]
MESH_GEN = 8
MESH_DRYRUN_TIMEOUT = 300


def _main_steps(trace, argv):
    """(seconds of each step, losses) of ``launch.train.main`` on cuda."""
    from repro_torch.launch.train import main as train_main

    tracer = trace.Tracer()
    with trace.use_tracer(tracer):
        train_main(["--arch", TRAIN_ARCH, *argv], device="cuda")
    return step_spans(tracer)


def _serve_run(params, cfg, prompts, feed, device, ctx=None):
    """Prefill ``prompts`` and decode ``MESH_GEN`` tokens (the greedy ones,
    or ``feed``'s); (logits of each step, the tokens fed)."""
    import torch

    from repro_torch.models import (cache_logical_axes, init_cache, make_decode_step,
                                    make_prefill_step)
    from repro_torch.sharding.rules import distribute

    kw = {} if ctx is None else {"ctx": ctx}
    B, P = prompts.shape
    kv_len = P + MESH_GEN + 1
    cache = init_cache(cfg, B, kv_len, device=device)
    if ctx is not None:
        cache["blocks"] = distribute(cache["blocks"], ctx.mesh,
                                     cache_logical_axes(cfg, B, kv_len)["blocks"], ctx.rules)
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    logits, cache = make_prefill_step(cfg, **kw)(params, {"tokens": prompts}, cache)
    out, fed = [whole(logits)], []
    decode = make_decode_step(cfg, **kw)
    for i in range(MESH_GEN):
        tok = feed[i] if feed is not None else torch.argmax(out[-1], dim=-1)[:, None]
        fed.append(tok)
        logits, cache = decode(params, tok, cache)
        out.append(whole(logits))
    torch.cuda.synchronize()
    return out, fed


def train_mesh(ops, trace, device):
    """(c) the LM mesh on a 1 x 1 mesh: ``--mesh debug`` training against
    ``--mesh none``, the sharded prefill and decode through the flash
    kernel against the unsharded ones, and the full-depth dry-run, which
    runs in its own process (its fake world must not meet this one's)
    while the rest of (c) runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_data
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ShardCtx, forward_train, init_params, lm_loss
    from repro_torch.models.params import distribute_params
    from repro_torch.sharding.rules import ShardingRules, distribute

    t0 = time.perf_counter()
    dry_dir = Path(os.environ.get("TMPDIR", "/tmp")) / f"chip_smoke_dryrun_{os.getpid()}"
    dry_dir.mkdir(parents=True, exist_ok=True)
    dry_json = dry_dir / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    dry = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                            TRAIN_ARCH, "--shape", "train_4k", "--out", str(dry_json)],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        # (a) --mesh debug against --mesh none, the same seed and windows
        base_secs, base = _main_steps(trace, MESH_TRAIN)
        mesh_secs, mesh_losses = _main_steps(trace, MESH_TRAIN + ["--mesh", "debug"])
        rel = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, base)]
        a = {"argv": MESH_TRAIN, "losses": {"none": base, "debug": mesh_losses},
             "bitwise": mesh_losses == base, "loss_rel_diff": rel,
             "step_seconds": {"none": base_secs, "debug": mesh_secs}}
        mesh = make_debug_mesh(device=device)
        rules = ShardingRules()
        ctx = ShardCtx(mesh, rules)
        cfg = get_config(TRAIN_ARCH)
        if not a["bitwise"]:
            # which part of step 1 parts them: the forward's logits or the loss
            w = torch.from_numpy(_windows(cfg.vocab, 4, 1024, 1)[0]).to(device)
            batch = {"tokens": w[:, :-1], "labels": w[:, 1:]}
            plain = init_params(cfg, seed=0, device=device)
            sharded = distribute_params(init_params(cfg, seed=0, device=device), cfg, mesh, rules)
            with torch.no_grad():
                lp, _ = forward_train(plain, cfg, batch)
                with ctx.scope():
                    ls, _ = forward_train(sharded, cfg, distribute(
                        batch, mesh, {"tokens": ("batch", "seq"), "labels": ("batch", "seq")},
                        rules), ctx=ctx)
                    loss_s = lm_loss(ls, batch["labels"]).full_tensor()
                a["step1_logits_bitwise"] = bool(torch.equal(ls.full_tensor(), lp))
                a["step1_loss_bitwise"] = bool(torch.equal(loss_s, lm_loss(lp, batch["labels"])))
            del plain, sharded
            if max(rel) > 2.0 ** -8:
                raise AssertionError(f"train (c): --mesh debug losses {mesh_losses} against "
                                     f"--mesh none {base}")
        out["train"] = a
        torch.cuda.empty_cache()

        # (b) the sharded prefill and decode with the flash kernel
        pcfg = cfg.replace(use_pallas=True)
        clients = make_federated_lm_data(SERVE_BATCH, cfg.vocab, SERVE_PROMPT + 8, seed=0)
        prompts = torch.from_numpy(np.stack([c[:SERVE_PROMPT] for c in clients])
                                   .astype(np.int64)).to(device)
        params = init_params(pcfg, seed=0, device=device)
        ops.reset_launch_counts()
        want, fed = _serve_run(params, pcfg, prompts, None, device)
        plain_counts = ops.launch_counts()
        del params
        params = distribute_params(init_params(pcfg, seed=0, device=device), pcfg, mesh, rules)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        got, _ = _serve_run(params, pcfg, prompts, fed, device, ctx)
        mesh_seconds = time.perf_counter() - t1
        counts = ops.launch_counts()
        gaps = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
        scale = max(float(w.float().abs().max()) for w in want)
        # the flash kernel against its plain version at the prefill's shape
        spec = ops.KERNEL_REGISTRY["flash_attention"]
        gen = torch.Generator(device=device).manual_seed(0)
        H, K, hd = pcfg.n_heads, pcfg.n_kv_heads, pcfg.head_dim
        q = torch.randn((SERVE_BATCH, SERVE_PROMPT, H, hd), generator=gen, device=device)
        k, v = (torch.randn((SERVE_BATCH, SERVE_PROMPT, K, hd), generator=gen, device=device)
                for _ in range(2))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        with torch.no_grad():
            kern = spec.kernel(q, k, v, True, 0)
            ref = spec.plain(q, k, v, True, 0)
        kernel_err, kernel_ok, kernel_tol = agreement(spec, kern, ref)
        del params
        torch.cuda.empty_cache()
        out["serve"] = {
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": MESH_GEN,
            "logits_bitwise": all(g.equal(w) for g, w in zip(got, want)),
            "logits_max_abs_diff": gaps, "logits_scale": scale,
            "flash_launches": counts["flash_attention"],
            "flash_launches_unsharded": plain_counts["flash_attention"],
            "sharded_seconds": mesh_seconds, "kernels": counts,
            "flash_kernel_vs_plain_max_abs_err": kernel_err,
            "flash_kernel_tol": kernel_tol}
        if counts["flash_attention"] <= 0 or \
                counts["flash_attention"] != plain_counts["flash_attention"]:
            raise AssertionError(f"train (c): flash launched {counts['flash_attention']} times "
                                 f"sharded, {plain_counts['flash_attention']} unsharded")
        if max(gaps) > 2.0 ** -8 * scale:
            raise AssertionError(f"train (c): sharded logits {gaps} off the unsharded ones")
        if not kernel_ok:
            raise AssertionError(f"train (c): flash kernel {kernel_err} off its plain version")
        try:
            stdout, stderr = dry.communicate(timeout=MESH_DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise AssertionError("train (c): the dry-run did not end in "
                                 f"{MESH_DRYRUN_TIMEOUT} s") from None
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    (rec,) = json.loads(dry_json.read_text()).values() if dry_json.exists() else (None,)
    out["dryrun"] = {"returncode": dry.returncode, "seconds": time.perf_counter() - t0,
                     "record": rec, "stderr_tail": stderr[-1500:]}
    if dry.returncode != 0 or rec is None or rec["status"] != "ok":
        raise AssertionError(f"train (c): dry-run rc {dry.returncode}: {stdout[-500:]} "
                             f"{stderr[-1500:]}")
    if not (rec["hlo_flops_per_chip"] > 0 and rec["collectives"]["total"] > 0):
        raise AssertionError(f"train (c): dry-run record {rec}")
    out["part_seconds"] = time.perf_counter() - t0
    out["kernels"] = counts
    return out


# the deep phase: the deep one-shot round (``core/deepfed.py``, ``fed_run
# --mode lm``): M members trained one after another by ``make_train_step``
# (no kernel runs there: none has a backward), the teacher's and the
# evaluations' forwards through the flash kernel (``use_pallas``)
DEEP_ARCH = SERVE_ARCH
# (a): full width, 2 fp32 layers, cuda against cpu
DEEP_PARITY = dict(n_layers=2, members=2, batch=2, seq=256, local_steps=2, distill_steps=2,
                   eval_windows=2, lr=1e-3)
# local losses: step 1 from equal parameters, later steps after the
# optimizer's arithmetic in another order on each device (``train`` (a)'s)
DEEP_LOSS_RTOL = TRAIN_LOSS_RTOL
DEEP_NLL_RTOL, DEEP_DISTILL_RTOL = 1e-4, 1e-3
# (b): the full 16-layer bf16 model, the CLI's 4 clients; lr as ``train`` (b)
DEEP_FULL = dict(members=4, batch=4, seq=512, local_steps=4, distill_steps=4, lr=3e-4)
DEEP_TOKENS = 8192   # tokens a client: windows of 4 x 513 at random starts


def deep_windows(vocab, members, batch, seq, local_steps, n_eval, n_proxy):
    """``fed_run --mode lm``'s token windows: each client's local windows
    (M, steps, B, S+1), then the held-out (2M) and proxy (M) windows drawn
    from the clients in turn."""
    import numpy as np

    from repro_torch.data import make_federated_lm_data, token_batches

    clients = make_federated_lm_data(members, vocab, DEEP_TOKENS, seed=0)
    local = np.stack([np.stack([next(it) for _ in range(local_steps)])
                      for it in (token_batches(c, batch, seq, seed=1) for c in clients)])
    test = np.stack([next(token_batches(clients[i % members], batch, seq, seed=7))
                     for i in range(n_eval)])
    proxy = np.stack([next(token_batches(clients[i % members], batch, seq, seed=13))
                      for i in range(n_proxy)])
    return local, test, proxy


@contextlib.contextmanager
def drawn_once(deepfed, params):
    """``deepfed.init_params`` returning a copy of ``params`` (one draw, on
    the card) on the device asked for (``init_params``' generator is per
    device), so the student starts from the same parameters on cuda and on
    cpu."""
    import copy

    def drawn(cfg, seed=0, device="cuda", trainable=False):
        return copy.deepcopy(params).to(device).requires_grad_(trainable)

    saved = deepfed.init_params
    deepfed.init_params = drawn
    try:
        yield
    finally:
        deepfed.init_params = saved


@contextlib.contextmanager
def reused_host_memory():
    """Large host allocations from the heap while the context is open
    (glibc's ``mallopt``: no ``mmap`` of its own for each large block, and
    freed blocks kept for the next), so that a cpu run's many fresh
    gigabyte tensors (the functional AdamW's moments and updates over the
    128,256-row embedding and head) reuse memory instead of paying fresh
    page faults; the freed heap goes back to the system on leaving. Where
    the C library has no ``mallopt``, nothing changes."""
    import ctypes
    import ctypes.util

    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    mallopt = getattr(libc, "mallopt", None)
    m_trim_threshold, m_mmap_max = -1, -4   # glibc's parameter numbers
    if mallopt is None or not mallopt(m_mmap_max, 0):
        yield
        return
    mallopt(m_trim_threshold, 2**31 - 1)
    try:
        yield
    finally:
        mallopt(m_mmap_max, 65536)   # glibc's defaults
        mallopt(m_trim_threshold, 128 * 1024)
        libc.malloc_trim(0)


def deep_flash_launches(cfg, members, distill_steps, eval_windows):
    """One flash launch a layer for each teacher forward (M a distill step)
    and each evaluation forward (single member, M ensemble members and the
    student on each held-out window)."""
    return cfg.n_layers * (distill_steps * members + eval_windows * (1 + members + 1))


def _deep_parity_run(ops, deepfed, cfg, teacher, mem, student0, local, test, proxy, dev):
    """One device's half of ``deep_parity``: local training, the member and
    ensemble NLLs, distillation into a copy of ``student0`` and its NLL,
    with each part's seconds."""
    dp = DEEP_PARITY
    M = len(mem)
    ops.reset_launch_counts()
    parts, t0 = {}, time.perf_counter()
    parts["local"], (mem, losses) = _sync_seconds(
        lambda: deepfed.make_local_train(cfg, lr=dp["lr"])(mem, local))
    parts["eval"], (single, ens) = _sync_seconds(
        lambda: (deepfed.ensemble_eval_loss(mem[:1], teacher, test),
                 deepfed.ensemble_eval_loss(mem, teacher, test)))
    with drawn_once(deepfed, student0):
        parts["distill"], (student, dl) = _sync_seconds(
            lambda: deepfed.distill_to_student(cfg, teacher, mem, proxy,
                                               steps=dp["distill_steps"], lr=dp["lr"],
                                               loss_kind="kl", device=dev))
    parts["student_eval"], student_nll = _sync_seconds(
        lambda: deepfed.ensemble_eval_loss([student], teacher, test))
    counts = ops.launch_counts()
    return {
        "local_losses": losses.cpu().tolist(), "single_member_nll": single,
        "ensemble_nll": ens, "distill_losses": dl, "student_nll": student_nll,
        "comm": deepfed.one_shot_comm_bytes(mem, M, student, n_devices=M),
        "fedavg10": deepfed.fedavg_comm_bytes(student, 10, M),
        "seconds": time.perf_counter() - t0, "part_seconds": parts,
        "flash_launches": counts["flash_attention"],
        "other_launches": sum(counts.values()) - counts["flash_attention"]}


def deep_parity(ops, device):
    """(a) llama3.2-1b at full width, 2 fp32 layers: the same members and
    student (drawn on the card, copies moved to the cpu) train, are
    evaluated and distilled on cuda and on cpu; the teacher and the
    evaluations through the fp32 flash kernel on cuda, its plain version on
    cpu. The cpu run's large tensors reuse host memory
    (``reused_host_memory``)."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import deepfed
    from repro_torch.models import init_params

    dp = DEEP_PARITY
    M = dp["members"]
    cfg = get_config(DEEP_ARCH).replace(n_layers=dp["n_layers"], dtype=torch.float32)
    teacher = cfg.replace(use_pallas=True)
    local, test, proxy = deep_windows(cfg.vocab, M, dp["batch"], dp["seq"], dp["local_steps"],
                                      dp["eval_windows"], dp["distill_steps"])
    members = deepfed.stacked_init(cfg, M, seed=0, device=device)
    copies = {"cuda": members, "cpu": [copy.deepcopy(m).cpu() for m in members]}
    student0 = init_params(cfg, seed=0, device=device)
    runs = {}
    for name, mem in copies.items():
        dev = mem[0].embed.device
        host = reused_host_memory() if dev.type == "cpu" else contextlib.nullcontext()
        with host:
            runs[name] = _deep_parity_run(ops, deepfed, cfg, teacher, mem, student0,
                                          local, test, proxy, dev)
    del members, copies, student0
    card, cpu = runs["cuda"], runs["cpu"]
    rel = lambda a, b: abs(a - b) / abs(b)
    local_rel = [[rel(a, b) for a, b in zip(x, y)]
                 for x, y in zip(card["local_losses"], cpu["local_losses"])]
    nll_rel = {k: rel(card[k], cpu[k]) for k in ("single_member_nll", "ensemble_nll",
                                                 "student_nll")}
    distill_rel = [rel(a, b) for a, b in zip(card["distill_losses"], cpu["distill_losses"])]
    flash = deep_flash_launches(cfg, M, dp["distill_steps"], dp["eval_windows"])
    out = {"arch": DEEP_ARCH, "dtype": "float32", **dp, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "host_threads": torch.get_num_threads(),
           "host_cpus": len(os.sched_getaffinity(0)), "runs": runs,
           "local_loss_rel_diff": local_rel,
           "nll_rel_diff": nll_rel, "distill_loss_rel_diff": distill_rel,
           "tol": {"local": list(DEEP_LOSS_RTOL), "nll": DEEP_NLL_RTOL,
                   "distill": DEEP_DISTILL_RTOL},
           "flash_launches_want": flash}
    for i, row in enumerate(local_rel):
        tols = [DEEP_LOSS_RTOL[0]] + [DEEP_LOSS_RTOL[1]] * (len(row) - 1)
        if not all(r <= t for r, t in zip(row, tols)):
            raise AssertionError(f"deep (a): member {i}'s cuda and cpu losses differ by {row}")
    if not max(nll_rel["single_member_nll"], nll_rel["ensemble_nll"]) <= DEEP_NLL_RTOL:
        raise AssertionError(f"deep (a): cuda and cpu NLLs differ by {nll_rel}")
    if not (max(distill_rel) <= DEEP_DISTILL_RTOL and math.isfinite(card["student_nll"])):
        raise AssertionError(f"deep (a): distill losses differ by {distill_rel} "
                             f"(student NLL {card['student_nll']})")
    if card["comm"] != cpu["comm"] or card["fedavg10"] != cpu["fedavg10"]:
        raise AssertionError(f"deep (a): byte counts differ: {card['comm']} {cpu['comm']}")
    if (card["flash_launches"], cpu["flash_launches"]) != (flash, 0) or card["other_launches"]:
        raise AssertionError(f"deep (a): flash launches cuda {card['flash_launches']}, cpu "
                             f"{cpu['flash_launches']}, want {flash} and 0; other kernels "
                             f"{card['other_launches']}")
    return out


def _lm_batch(window, device):
    import torch

    t = torch.from_numpy(window).to(device).long()
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _sync_seconds(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, result


def deep_full(ops, device):
    """(b) the full 16-layer bf16 llama3.2-1b: 4 members trained one after
    another, evaluated (single member and ensemble) on 8 held-out windows,
    distilled into a student (``kl``) whose NLL is taken on the same
    windows, as ``fed_run --mode lm`` runs them, the teacher and the
    evaluations through the bf16 flash kernel. Then, outside the counted
    run: the teacher's forward timed alone, the ensemble NLL of one window
    through the kernel against the plain attention, and one distill step
    and one local step under the profiler."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import deepfed
    from repro_torch.models import make_eval_step, param_count

    df = DEEP_FULL
    M, steps = df["members"], df["distill_steps"]
    cfg = get_config(DEEP_ARCH)
    teacher = cfg.replace(use_pallas=True)
    local, test, proxy = deep_windows(cfg.vocab, M, df["batch"], df["seq"], df["local_steps"],
                                      2 * M, M)
    init_s, members = _sync_seconds(lambda: deepfed.stacked_init(cfg, M, seed=0, device=device))
    evaluate = make_eval_step(cfg)
    before = [float(evaluate(p, _lm_batch(local[m, 0], device))) for m, p in enumerate(members)]
    train = deepfed.make_local_train(cfg, lr=df["lr"])

    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    local_s, (members, losses) = _sync_seconds(lambda: train(members, local))
    after = [float(evaluate(p, _lm_batch(local[m, 0], device))) for m, p in enumerate(members)]
    eval_s, (single, ens) = _sync_seconds(lambda: (
        deepfed.ensemble_eval_loss(members[:1], teacher, test),
        deepfed.ensemble_eval_loss(members, teacher, test)))
    distill_s, (student, dl) = _sync_seconds(lambda: deepfed.distill_to_student(
        cfg, teacher, members, proxy, steps=steps, lr=df["lr"], loss_kind="kl", device=device))
    student_nll = deepfed.ensemble_eval_loss([student], teacher, test)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    comm = deepfed.one_shot_comm_bytes(members, M, student, n_devices=M)
    del student

    # the teacher's forward on a proxy window alone (warm)
    proxy_batch = _lm_batch(proxy[0], device)
    teacher_s = sorted(_sync_seconds(lambda: deepfed.ensemble_log_probs(
        members, teacher, proxy_batch["tokens"]))[0] for _ in range(3))[1]
    # kernel against plain attention: the ensemble on one held-out window
    batch = _lm_batch(test[0], device)
    nlls, lps = {}, {}
    for name, c in (("kernel", teacher), ("plain", cfg)):
        lp = deepfed.ensemble_log_probs(members, c, batch["tokens"])
        nlls[name] = float(-torch.gather(lp, -1, batch["labels"][..., None]).mean())
        lps[name] = lp
        del lp
    gap = float((lps["kernel"] - lps["plain"]).abs().max())
    del lps
    distill_profile, _ = profile_call(lambda: deepfed.distill_to_student(
        cfg, teacher, members, proxy[:1], steps=1, lr=df["lr"], device=device))
    local_profile, _ = profile_call(lambda: train(members[:1], local[:1, :1]))
    torch.cuda.empty_cache()

    tokens = df["batch"] * df["seq"]
    s_local = local_s / (M * df["local_steps"])
    flash = deep_flash_launches(cfg, M, steps, len(test))
    host_losses = losses.float().cpu().tolist()
    out = {
        "arch": DEEP_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": "bfloat16", "params": param_count(cfg), **df,
        "tokens_per_step": tokens, "init_seconds": init_s,
        "local_seconds": local_s, "seconds_per_local_step": s_local,
        "local_tokens_per_s": tokens / s_local, "local_losses": host_losses,
        "first_batch_loss": {"before": before, "after": after},
        "eval_seconds": eval_s, "distill_seconds": distill_s,
        "seconds_per_distill_step": distill_s / steps,
        "teacher_forward_seconds": teacher_s, "distill_losses": dl,
        "nll": {"single_member": single, "ensemble": ens, "student": student_nll},
        "kernel_vs_plain": {"nll": nlls, "nll_rel_diff": abs(nlls["kernel"] - nlls["plain"])
                            / abs(nlls["plain"]), "tol": BF16_RTOL,
                            "max_log_prob_gap": gap},
        "comm": comm, "peak_memory_bytes": peak,
        "flash_launches_want": flash, "kernels": counts,
        "distill_step_profile": distill_profile, "local_step_profile": local_profile,
        # the profiler's own start and stop dwarf a step's wall (``train``
        # (b)), so a busy share is the profiled call's device seconds over
        # an unprofiled step's; the profiled distill call also draws its
        # student, the local one also zeroes its member's moments
        "device_busy_share": {
            "local_step": local_profile["device_seconds"] / s_local,
            "distill_step": distill_profile["device_seconds"] / (distill_s / steps)},
    }
    finite = [single, ens, student_nll] + dl + [x for row in host_losses for x in row]
    if not all(math.isfinite(x) for x in finite):
        raise AssertionError(f"deep (b): a loss or NLL is not finite: {out['nll']}")
    if not all(b > a for b, a in zip(before, after)):
        raise AssertionError(f"deep (b): step 1's batch loss before {before}, after {after}")
    if counts["flash_attention"] != flash or sum(counts.values()) != flash:
        raise AssertionError(f"deep (b): launches {counts}, want {flash} flash and no other")
    if not out["kernel_vs_plain"]["nll_rel_diff"] <= BF16_RTOL:
        raise AssertionError(f"deep (b): ensemble NLL through the kernel {nlls['kernel']} "
                             f"against plain {nlls['plain']}")
    return out


def phase_deep(ops, device):
    return {"parity": deep_parity(ops, device), "full": deep_full(ops, device)}


# the families phase: the MoE, SSM (Mamba2), hybrid (Jamba), VLM (LLaVA)
# and audio (Whisper) LMs (``models/layers.py::moe``, ``models/ssm.py``,
# the patch prefix, ``models/model.py::encode`` and the cross-attention)
# through the port's entry points; flash attention runs on the attention
# layers of phi, jamba and llava and on whisper's encoder (non-causal) and
# decoder self-attention
FAMILY_MOE, FAMILY_SSM, FAMILY_HYBRID = ("phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                         "jamba-1.5-large-398b")
FAMILY_VLM, FAMILY_AUDIO = "llava-next-mistral-7b", "whisper-base"
# (a): full width, fp32, cuda against cpu: phi and mamba2 at 2 layers on 1 x
# 256 tokens; llava at 2 layers on 1 x (64 random patches + 192 tokens);
# whisper at full depth (6 + 6 layers) on one clip of 1,500 random frames
# and 64 tokens
FAMILY_PARITY = {FAMILY_MOE: dict(n_layers=2, tokens=256),
                 FAMILY_SSM: dict(n_layers=2, tokens=256),
                 FAMILY_VLM: dict(n_layers=2, tokens=192, patches=64),
                 FAMILY_AUDIO: dict(n_layers=6, tokens=64, frames=1500)}
# the stub frontends' random patch and frame embeddings: normals at the
# token embedding's init scale
FAMILY_INPUT_STD = 0.02
# (b): the depth cut of each model for one 80 GB card in bf16 (jamba's
# first 5 layers: (mamba, mlp), (mamba, moe), (mamba, mlp), (mamba, moe),
# (attn, mlp)); llava and whisper whole; serve_prompts as ``serve``'s, 4 x
# 2,048-token prompts (llava's behind its 2,880 zero patches), 32 greedy
# tokens; whisper's prompts 416 tokens, so that prompt and generation fill
# its 448-token decoder, behind 1,500 zero frames
FAMILY_SERVE_LAYERS = {FAMILY_MOE: 16, FAMILY_SSM: 64, FAMILY_HYBRID: 5, FAMILY_VLM: 32,
                       FAMILY_AUDIO: 6}
FAMILY_SERVE_PROMPT = {FAMILY_AUDIO: 416}
# the profiled serve's greedy tokens: the prefill and a window of decode
# steps (the profiler's cost grows with the launches, ~1,000 a decode step
# of mamba2's 64 layers: its 32-token serve took 35.5 s profiled, 4.4 warm)
FAMILY_PROFILE_GEN = 8
# (c): 2 fp32 layers; B * S = 2 * 128 <= 256, so every MoE call is dropless;
# llava's 64 random patches sit in the cache in front of the prompt,
# whisper's decoder reads its 1,500 frames' keys and values from the cache
FAMILY_CACHE = dict(n_layers=2, batch=2, prompt=96, gen=32, patches=64, frames=1500)
FAMILY_SSD = dict(tokens=512, chunk=256, tol=1e-3)
# (d): bf16 train steps without the kernels (they have no backward). The
# functional AdamW holds the old and new fp32 moments and the fp32 updates
# at once, ~26 bytes a parameter: phi at 2 layers (2.86 B) ran out of the
# card's 80 GB in its first update, so it trains 1 layer (1.56 B); mamba2 at
# the depth whose activations (the SSD's (B, L, L, H) fp32 terms, saved for
# the backward) fit beside its moments; llava at 10 of 32 layers (262 M +
# 218 M a layer = 2.44 B, ~64 GB at 26 bytes a parameter, beside the
# activations of 64 patches + 512 tokens a row; 11 layers would be ~70 GB);
# whisper whole (6 + 6 layers) on 1,500 frames a row. llava trains at 2e-5,
# LLaVA's own rate for fine-tuning its language model: at 3e-4 its batch
# loss rose over the 3 steps (10.83 -> 11.10), as llama3.2-1b's full bf16
# model's did at 1e-3
FAMILY_TRAIN = dict(steps=3, batch=4, seq=512, lr=3e-4)
FAMILY_TRAIN_LAYERS = {FAMILY_MOE: 1, FAMILY_SSM: 32, FAMILY_VLM: 10, FAMILY_AUDIO: 6}
FAMILY_TRAIN_LR = {FAMILY_VLM: 2e-5}
FAMILY_TRAIN_INPUTS = {FAMILY_VLM: dict(patches=64), FAMILY_AUDIO: dict(frames=1500)}


@contextlib.contextmanager
def record_routing(layers, keep_inputs=False):
    """Record each ``layers.moe`` call's top-k expert ids and probabilities
    (as the call computes them), and with ``keep_inputs`` its input, while
    the context is open."""
    calls = []
    moe = layers.moe

    def recording(x, p, cfg, **kw):
        probs, _ = layers._route(x.reshape(-1, x.shape[-1]), p, cfg)
        vals, ids = layers.top_k(probs, cfg.top_k + 1)
        calls.append({"ids": ids[:, :cfg.top_k].cpu(), "probs": vals.cpu(),
                      "input": x.detach().clone() if keep_inputs else None})
        return moe(x, p, cfg, **kw)

    layers.moe = recording
    try:
        yield calls
    finally:
        layers.moe = moe


def routing_flips(a_calls, b_calls):
    """Per MoE call, the tokens whose set of top-k experts differs between
    two recordings."""
    return [int((a["ids"].sort(dim=-1).values != b["ids"].sort(dim=-1).values)
                .any(dim=-1).sum()) for a, b in zip(a_calls, b_calls)]


def _free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def family_inputs(cfg, batch, patches=0, frames=0, zeros=False, device="cpu", seed=3):
    """The stub frontends' inputs for ``batch`` rows: ``patches`` patch
    embeddings (the VLM's prefix) and ``frames`` frame embeddings (the
    encoder's input), normals at FAMILY_INPUT_STD drawn on the cpu (the
    same on every device), or zeros as the serve and train drivers give."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, n in (("patches", patches), ("frames", frames)):
        if n:
            shape = (batch, n, cfg.d_model)
            t = (torch.zeros(shape) if zeros
                 else FAMILY_INPUT_STD * torch.randn(shape, generator=gen))
            out[key] = t.to(device)
    return out


def families_parity(device):
    """(a) each FAMILY_PARITY model at full width in fp32: the same
    parameters (drawn on the card, a copy moved to the cpu) through
    ``forward_train`` on the same tokens (and patches or frames) on cpu and
    on cuda: logits within LM_LOGIT_TOL, every MoE layer's top-k expert ids
    equal (the tokens whose ids differ are counted, with the gap between
    their k-th and next expert's probability, before the check fails)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_data
    from repro_torch.models import forward_train, init_params
    from repro_torch.models import layers

    out = {}
    for arch, fp in FAMILY_PARITY.items():
        cfg = get_config(arch).replace(n_layers=fp["n_layers"], dtype=torch.float32)
        tokens = make_federated_lm_data(1, cfg.vocab, fp["tokens"] + 8, seed=0)[0]
        tokens = torch.from_numpy(tokens[None, :fp["tokens"]].astype(np.int64))
        extra = family_inputs(cfg, 1, fp.get("patches", 0), fp.get("frames", 0))
        on_card = init_params(cfg, seed=0, device=device)
        copies = {"cpu": copy.deepcopy(on_card).cpu(), "cuda": on_card}
        runs = {}
        for name, params in copies.items():
            dev = params.embed.device
            batch = {"tokens": tokens.to(dev), **{k: v.to(dev) for k, v in extra.items()}}
            t0 = time.perf_counter()
            with torch.no_grad(), record_routing(layers) as calls:
                logits, aux = forward_train(params, cfg, batch)
            runs[name] = {"logits": logits.cpu(), "aux": float(aux), "routing": calls,
                          "seconds": time.perf_counter() - t0}
            del logits
        del on_card, copies, params
        _free_card()
        cpu, card = runs["cpu"], runs["cuda"]
        diff = float((card["logits"] - cpu["logits"]).abs().max())
        flipped, gaps = 0, []
        for a, b in zip(card["routing"], cpu["routing"]):
            bad = (a["ids"] != b["ids"]).any(dim=-1)
            flipped += int(bad.sum())
            k = cfg.top_k
            gaps += (b["probs"][bad, k - 1] - b["probs"][bad, k]).tolist()
        out[arch] = {
            "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "d_model": cfg.d_model, "tokens": fp["tokens"],
            "inputs": {k: list(v.shape) for k, v in extra.items()},
            "logits_shape": list(card["logits"].shape),
            "max_logit_diff": diff, "tol": LM_LOGIT_TOL,
            "aux": {k: r["aux"] for k, r in runs.items()},
            "moe_layers": len(card["routing"]), "routing_tokens_differing": flipped,
            "routing_gaps_of_differing": gaps,
            "seconds": {k: r["seconds"] for k, r in runs.items()}}
        if card["logits"].shape != (1, fp["tokens"], cfg.vocab):
            raise AssertionError(f"families (a) {arch}: logits {tuple(card['logits'].shape)}")
        if not (torch.isfinite(card["logits"]).all() and diff <= LM_LOGIT_TOL):
            raise AssertionError(f"families (a) {arch}: logits differ by {diff}")
        if flipped or len(card["routing"]) != len(cpu["routing"]):
            raise AssertionError(f"families (a) {arch}: {flipped} tokens route to other "
                                 f"experts on cuda (probability gaps {gaps})")
    return out


def _prompts(vocab, prompt_len=SERVE_PROMPT):
    import numpy as np

    from repro_torch.data import make_federated_lm_data

    clients = make_federated_lm_data(SERVE_BATCH, vocab, prompt_len + 8, seed=0)
    return np.stack([c[:prompt_len] for c in clients]).astype(np.int32)


def moe_bitwise(params, cfg, device):
    """The first MoE layer of ``params`` twice on the same bf16 input of the
    serve prefill's shape (4 x 2,048 tokens: capacity binds): equal bits."""
    import torch

    from repro_torch.models import layers

    kinds = cfg.sublayer_kinds()
    i = next(j for j in range(cfg.n_layers) if kinds[j % len(kinds)][1] == "moe")
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model), generator=gen, device=device)
    x = x.to(cfg.dtype)
    with torch.no_grad():
        first, aux1 = layers.moe(x, params.blocks[i].ffn, cfg)
        second, aux2 = layers.moe(x, params.blocks[i].ffn, cfg)
    return {"layer": i, "capacity": layers.moe_capacity(cfg, x.shape[0] * x.shape[1]),
            "bitwise_equal": bool(torch.equal(first, second) and torch.equal(aux1, aux2))}


def families_serve(ops, device, arch):
    """(b) one model at its depth cut in bf16 with the flash kernel through
    ``serve_prompts``: 4 prompts of 2,048 tokens (whisper's 416), 32
    greedy tokens (cold, counted; warm; under the profiler); the prompts'
    NLL through ``forward_train`` with the kernel and with plain attention
    (behind the serve's zero patches or frames), an end-to-end check and
    not the kernel's (the kernels phase holds the kernel element by element
    at these prefill shapes), with the largest logit gap reported beside
    it and, for a MoE, the tokens routed to other experts in the two runs
    and the gap between the runs' inputs of each MoE layer; the MoE layer
    twice, bitwise."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_prompts
    from repro_torch.models import (cache_nbytes, cache_spec, forward_train, init_params,
                                    layers, lm_loss, param_count, uncounted_params)

    cfg = get_config(arch).replace(n_layers=FAMILY_SERVE_LAYERS[arch], use_pallas=True)
    prompt_len = FAMILY_SERVE_PROMPT.get(arch, SERVE_PROMPT)
    # one flash launch a self-attention layer, the encoder's included
    attn_layers = cfg.mixer_kinds().count("attn") + cfg.encoder_layers
    # the previous model's serve leaves its parameters in a reference cycle
    # until a collection: without one here its bytes count in this peak
    _free_card()
    steps = {}   # seconds of each step of this part, on the host's clock
    steps["init"], params = _sync_seconds(lambda: init_params(cfg, seed=0, device=device))
    n_params = sum(p.numel() for p in params.parameters())
    prompts = _prompts(cfg.vocab, prompt_len)
    kv_len = cfg.n_patches + prompt_len + SERVE_GEN + 1
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    wall, (tokens, sched) = _sync_seconds(lambda: serve_prompts(cfg, params, prompts, SERVE_GEN))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    steps["warm_serve"], (warm_tokens, warm_sched) = _sync_seconds(
        lambda: serve_prompts(cfg, params, prompts, SERVE_GEN))
    steps["warm_window_serve"], (window_tokens, _) = _sync_seconds(
        lambda: serve_prompts(cfg, params, prompts, FAMILY_PROFILE_GEN))
    steps["profiled_serve"], (profile, (again, _)) = _sync_seconds(lambda: profile_call(
        lambda: serve_prompts(cfg, params, prompts, FAMILY_PROFILE_GEN), cpu_ops=False))
    cold, warm = sched.score_fn.timings[0], warm_sched.score_fn.timings[0]

    def rates(timing):
        pre_s, dec_s = timing["prefill_seconds"], timing["decode_seconds"]
        return {"prefill_seconds": pre_s,
                "prefill_tokens_per_s": SERVE_BATCH * prompt_len / pre_s,
                "decode_seconds": dec_s,
                "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / dec_s,
                "decode_ms_per_step": 1e3 * dec_s / SERVE_GEN}

    batch = torch.from_numpy(prompts).to(device).long()
    # the serve's zero patches or frames in front of the prompts
    stub = family_inputs(cfg, SERVE_BATCH, cfg.n_patches, cfg.encoder_seq * cfg.is_encdec,
                         zeros=True, device=device)
    nll, logits, routing = {}, {}, {}
    for name, c in (("kernel", cfg), ("plain", cfg.replace(use_pallas=False))):
        if name == "plain" and not attn_layers:
            break
        with torch.no_grad(), record_routing(layers, keep_inputs=True) as calls:
            steps["nll_" + name], (logits[name], _) = _sync_seconds(
                lambda c=c: forward_train(params, c, {"tokens": batch[:, :-1], **stub}))
        nll[name] = float(lm_loss(logits[name], batch[:, 1:]))
        routing[name] = calls
    # the largest logit gap, row by row (jamba's logits are 1 GB each)
    logit_gap = (max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(logits["kernel"], logits["plain"]))
                 if attn_layers else None)
    flips = input_gaps = None
    if cfg.n_experts and attn_layers:
        flips = routing_flips(routing["kernel"], routing["plain"])
        input_gaps = [float((a["input"].float() - b["input"].float()).abs().max())
                      for a, b in zip(routing["kernel"], routing["plain"])]
    del logits, routing
    steps["moe_twice"], moe = _sync_seconds(
        lambda: moe_bitwise(params, cfg, device) if cfg.n_experts else None)
    out = {
        "arch": arch, "n_layers": cfg.n_layers, "of_layers": get_config(arch).n_layers,
        "encoder_layers": cfg.encoder_layers,
        "kinds": [list(k) for k in cfg.sublayer_kinds()], "d_model": cfg.d_model,
        "dtype": "bfloat16", "params": n_params, "param_count": param_count(cfg),
        "uncounted_params": uncounted_params(cfg), "step_seconds": steps,
        "requests": SERVE_BATCH, "prompt_len": prompt_len, "gen": SERVE_GEN,
        "stub_inputs": {k: list(v.shape) for k, v in stub.items()},
        "kv_len": kv_len, "cache_bytes": cache_nbytes(cache_spec(cfg, SERVE_BATCH, kv_len)),
        "peak_memory_bytes": peak, "cold": rates(cold), "warm": rates(warm),
        "cold_serve_wall_seconds": wall, "kernels": counts,
        "flash_launches_want": attn_layers, "prompt_nll": nll,
        "kernel_vs_plain_logits_max_abs_diff": logit_gap,
        # a MoE's tokens whose top-k experts differ between the kernel's and
        # plain attention's runs, by MoE layer, and the largest gap between
        # the two runs' inputs to each MoE layer
        "kernel_vs_plain_routing_flips": flips,
        "kernel_vs_plain_moe_input_max_abs_diff": input_gaps,
        "moe_twice": moe, "tokens_head": tokens[:, :8].tolist(),
        # the profiler's own cost dwarfs a serve's wall (as in ``deep`` (b)),
        # so the busy share is the profiled serve's device seconds over the
        # wall of an unprofiled warm serve of the same FAMILY_PROFILE_GEN
        # tokens; the profiled call's own share beside it
        "profile_gen": FAMILY_PROFILE_GEN,
        "device_busy_share": profile["device_seconds"] / steps["warm_window_serve"],
        "device_busy_share_profiled": profile["device_busy_share"],
        "profile": {k: profile[k] for k in ("wall_seconds", "device_seconds",
                                            "device_launches", "by_kernel")},
    }
    del params, stub
    _free_card()
    if n_params != param_count(cfg) + uncounted_params(cfg):
        raise AssertionError(f"families (b) {arch}: {n_params} parameters, param_count "
                             f"{param_count(cfg)} + uncounted {uncounted_params(cfg)}")
    if tokens.shape != (SERVE_BATCH, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"families (b) {arch}: tokens {tokens.shape} outside the vocabulary")
    if not (np.array_equal(again, window_tokens) and np.array_equal(warm_tokens, tokens)):
        raise AssertionError(f"families (b) {arch}: a repeat of the serve generated other tokens")
    if counts["flash_attention"] != attn_layers or sum(counts.values()) != attn_layers:
        raise AssertionError(f"families (b) {arch}: launches {counts}, want {attn_layers} "
                             "flash (one per self-attention layer, one prefill) and no other")
    if not all(math.isfinite(v) for v in nll.values()):
        raise AssertionError(f"families (b) {arch}: prompt NLL {nll}")
    if attn_layers and not abs(nll["kernel"] - nll["plain"]) <= BF16_RTOL * abs(nll["plain"]):
        raise AssertionError(f"families (b) {arch}: NLL through the kernel {nll['kernel']} "
                             f"against plain attention {nll['plain']}")
    if moe is not None and not moe["bitwise_equal"]:
        raise AssertionError(f"families (b) {arch}: two runs of the MoE layer differ")
    return out


def families_cache(device):
    """(c) phi3.5-moe (through the fp32 flash kernel), mamba2, llava (64
    random patches in front of the prompt) and whisper (1,500 random
    frames; the decoder's cross-attention reads ``xk`` and ``xv`` from the
    cache) at full width, 2 fp32 layers: prefill 96 tokens, then decode the
    next 32 of the same sequence; each step's logits against
    ``forward_train``'s at that position. Then one mamba2 mixer at chunk 256
    on 1 x 512 tokens: finite, and its chunked output against the
    token-by-token recurrence (decode steps through the same mixer)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import make_federated_lm_data
    from repro_torch.models import (forward_decode, forward_prefill, forward_train,
                                    init_cache, init_params)
    from repro_torch.models.ssm import mamba_mixer

    fc = FAMILY_CACHE
    total = fc["prompt"] + fc["gen"]
    out = {}
    for arch in (FAMILY_MOE, FAMILY_SSM, FAMILY_VLM, FAMILY_AUDIO):
        cfg = get_config(arch).replace(n_layers=fc["n_layers"], dtype=torch.float32,
                                       use_pallas=True)
        params = init_params(cfg, seed=0, device=device)
        seqs = make_federated_lm_data(fc["batch"], cfg.vocab, total + 8, seed=1)
        seq = torch.from_numpy(np.stack([s[:total] for s in seqs]).astype(np.int64)).to(device)
        extra = family_inputs(cfg, fc["batch"], fc["patches"] * bool(cfg.n_patches),
                              fc["frames"] * cfg.is_encdec, device=device)
        prefix = extra["patches"].shape[1] if "patches" in extra else 0
        with torch.no_grad():
            full, _ = forward_train(params, cfg, {"tokens": seq, **extra})
            cache = init_cache(cfg, fc["batch"], prefix + total + 1, device=device)
            logits, cache = forward_prefill(
                params, cfg, {"tokens": seq[:, :fc["prompt"]], **extra}, cache)
            gaps = [float((logits - full[:, fc["prompt"] - 1]).abs().max())]
            for t in range(fc["prompt"], total - 1):
                logits, cache = forward_decode(params, cfg, seq[:, t:t + 1], cache)
                gaps.append(float((logits - full[:, t]).abs().max()))
        out[arch] = {"batch": fc["batch"], "prompt": fc["prompt"], "decode_steps": len(gaps) - 1,
                     "inputs": {k: list(v.shape) for k, v in extra.items()},
                     "cache_step": cache["step"],
                     "max_logit_diff": max(gaps), "tol": LM_LOGIT_TOL,
                     "finite": bool(torch.isfinite(full).all())}
        del params, cache, full, extra
        _free_card()
        if not (out[arch]["finite"] and max(gaps) <= LM_LOGIT_TOL):
            raise AssertionError(f"families (c) {arch}: decode against the full forward "
                                 f"{gaps}")
        if out[arch]["cache_step"] != prefix + total - 1:
            raise AssertionError(f"families (c) {arch}: cache step {out[arch]['cache_step']}")
    fs = FAMILY_SSD
    cfg = get_config(FAMILY_SSM).replace(n_layers=1, dtype=torch.float32,
                                         ssm_chunk=fs["chunk"])
    mixer = init_params(cfg, seed=0, device=device).blocks[0].mixer
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    x = torch.randn((1, fs["tokens"], cfg.d_model), generator=gen, device=device)
    with torch.no_grad():
        chunked, _ = mamba_mixer(x, mixer, cfg)
        cache = init_cache(cfg, 1, fs["tokens"], device=device)["blocks"][0]["mamba"]
        steps = [mamba_mixer(x[:, t:t + 1], mixer, cfg, cache=cache, decode=True)[0]
                 for t in range(fs["tokens"])]
        stepped = torch.cat(steps, dim=1)
        dt = F.softplus(x @ mixer.in_dt + mixer.dt_bias)
        log_decay = (dt * -torch.exp(mixer.a_log))[:, :fs["chunk"]].sum(dim=1)
    gap = float((chunked - stepped).abs().max())
    out["ssd_chunk256"] = {"tokens": fs["tokens"], "chunk": fs["chunk"],
                           "finite": bool(torch.isfinite(chunked).all()),
                           "max_abs_diff_vs_recurrence": gap, "tol": fs["tol"],
                           "max_abs_out": float(stepped.abs().max()),
                           "first_chunk_log_decay_min": float(log_decay.min())}
    del mixer
    _free_card()
    if not (out["ssd_chunk256"]["finite"] and gap <= fs["tol"]):
        raise AssertionError(f"families (c): chunk-256 SSD against its recurrence {gap}")
    return out


def families_train(ops, device):
    """(d) each FAMILY_TRAIN_LAYERS model at its depth, full width in bf16,
    ``make_train_step`` with ``launch.train``'s optimizer, 3 steps of 4 x
    512 tokens at lr 3e-4 (llava's at 2e-5 behind 64 random patches,
    whisper's with 1,500 random frames): losses and aux finite, aux > 0 for the MoE,
    step 1's batch loss lower after the steps than before, no kernel
    launched; s/step (steps 2-3) and peak memory."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_optimizer
    from repro_torch.models import init_params, make_eval_step, make_train_step, param_tree

    ft = FAMILY_TRAIN
    out = {}
    for arch, n_layers in FAMILY_TRAIN_LAYERS.items():
        cfg = get_config(arch).replace(n_layers=n_layers)
        windows = _windows(cfg.vocab, ft["batch"], ft["seq"], ft["steps"])
        params = init_params(cfg, seed=0, device=device, trainable=True)
        lr = FAMILY_TRAIN_LR.get(arch, ft["lr"])
        opt = make_optimizer(lr)
        state = opt.init(param_tree(params))
        step, evaluate = make_train_step(cfg, opt), make_eval_step(cfg)
        extra = family_inputs(cfg, ft["batch"], device=device,
                              **FAMILY_TRAIN_INPUTS.get(arch, {}))
        first = {**_lm_batch(windows[0], device), **extra}
        before = float(evaluate(params, first))
        torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launch_counts()
        secs, metrics = [], []
        for w in windows:
            s, (params, state, m) = _sync_seconds(
                lambda w=w: step(params, state, {**_lm_batch(w, device), **extra}))
            secs.append(s)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated(device)
        launched = sum(ops.launch_counts().values())
        after = float(evaluate(params, first))
        out[arch] = {"n_layers": n_layers, "of_layers": get_config(arch).n_layers,
                     "encoder_layers": cfg.encoder_layers,
                     "params": sum(p.numel() for p in params.parameters()),
                     "inputs": {k: list(v.shape) for k, v in extra.items()},
                     "dtype": "bfloat16", **ft, "lr": lr, "seconds_per_step": secs,
                     "seconds_per_step_warm": mean(secs[1:]),
                     "tokens_per_s_warm": ft["batch"] * ft["seq"] / mean(secs[1:]),
                     "metrics": metrics, "first_batch_loss": {"before": before, "after": after},
                     "peak_memory_bytes": peak, "kernel_launches": launched}
        del params, state, extra, first
        _free_card()
        values = [v for m in metrics for v in m.values()] + [before, after]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"families (d) {arch}: a loss is not finite: {metrics}")
        if cfg.n_experts and not all(m["aux"] > 0 for m in metrics):
            raise AssertionError(f"families (d) {arch}: aux {metrics}")
        if not after < before or launched:
            raise AssertionError(f"families (d) {arch}: step 1's batch loss {before} -> "
                                 f"{after}, kernels launched {launched}")
    return out


def phase_families(ops, device):
    """(a)-(d) in turn; each part's seconds on a progress line of its own,
    so a part that fails leaves the earlier parts' times."""
    parts = (("parity", lambda: families_parity(device)),
             ("serve", lambda: {arch: families_serve(ops, device, arch)
                                for arch in FAMILY_SERVE_LAYERS}),
             ("cache", lambda: families_cache(device)),
             ("train", lambda: families_train(ops, device)))
    out, seconds = {}, {}
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
        emit({"phase": "families", "part": name, "seconds": seconds[name]})
    out["part_seconds"] = seconds
    out["kernels"] = {name: sum(r["kernels"][name] for r in out["serve"].values())
                      for name in ops.KERNEL_REGISTRY}
    return out


# the cli phase: ``repro_torch.launch.fed_run.main`` as a user runs it, on
# cuda and on cpu: two sim rounds (fp32 with dense distillation and the
# fleet; int8 under a budget with fisher and CG distillation) and --mode lm
CLI_COMMON = ["--mode", "sim", "--scenario", "dirichlet", "--devices", "1024", "--k", "10", "50",
              "--distill-proxy", "1024"]
CLI_RUNS = {
    "fp32": (CLI_COMMON + ["--distill-solver", "dense", "--serve-fleet"],
             ("batched_rbf_gram", "sdca", "ensemble_score", "rbf_gram")),
    "int8": (CLI_COMMON + ["--codec", "int8", "--budget-bytes", "30000", "--aggregator",
                           "fisher", "--distill-solver", "cg"], Q8_KERNELS),
}
# ``repro.launch.fed_run``'s --mode lm report (tests/test_torch_fed_run.py
# holds the port's keys to the reference's on the cpu)
LM_REPORT_KEYS = ("arch", "clients", "single_member_nll", "ensemble_nll", "student_nll",
                  "one_shot_comm_bytes", "fedavg10_comm_bytes", "comm_reduction_vs_fedavg10")
CG_MAXITER = 256   # DistillConfig().maxiter


def cli_main(fed_run, ops, argv, device, trace_path=None):
    """(report, the run's launches, its trace or None, seconds); the
    report's printout kept off this script's stdout."""
    import io

    argv = list(argv) + (["--trace", str(trace_path)] if trace_path else [])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = fed_run.main(argv, device=device)
    seconds = time.perf_counter() - t0
    doc = json.loads(Path(trace_path).read_text()) if trace_path else None
    return report, ops.launch_counts(), doc, seconds


def sim_aucs(report, distilled=True):
    vals = {"mean_local_auc": report["mean_local_auc"], "mean_val_auc": report["mean_val_auc"]}
    for s, by_k in report["ensemble_auc"].items():
        if s != "distilled" or distilled:
            vals.update({f"{s}_k{k}": v for k, v in by_k.items()})
    return vals


# the cli phase's sharded run: CLI_RUNS[SHARDED_CLI_RUN] with ``--engine
# sharded`` on SHARDED_CLI_RANKS ranks sharing the one card
SHARDED_CLI_RUN = "fp32"
SHARDED_CLI_RANKS = 2
SHARDED_CLI_GROUP_TIMEOUT = datetime.timedelta(seconds=120)   # a collective waiting longer fails
SHARDED_CLI_DEADLINE = datetime.timedelta(seconds=300)        # a rank running longer is killed
SHARDED_CLI_SKIP = ("engine", "mesh", "mesh_requested", "train_seconds", "devices_per_second")


def comparable_report(report):
    """``fed_run``'s sim JSON without what a sharded run may change: the
    engine, the mesh keys, the timings and the process's metrics registry."""
    out = {k: v for k, v in report.items() if k not in SHARDED_CLI_SKIP + ("obs",)}
    out["obs"] = {k: v for k, v in report["obs"]["sections"].items() if k != "metrics"}
    return json.loads(json.dumps(out))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_cli_rank(rank, world, port, argv, out_dir):
    """One spawned rank of the cli phase's sharded run: join the ``gloo``
    world on localhost, run ``fed_run.main`` on cuda:0 twice (the second
    run's seconds without the process's start-up) and write the first
    run's JSON and launches, both runs' seconds (or the traceback) under
    ``out_dir``."""
    out = Path(out_dir)
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.kernels import ops
        from repro_torch.launch import fed_run
        from repro_torch.utils.device import resolve_device

        device = resolve_device("cuda:0")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=SHARDED_CLI_GROUP_TIMEOUT)
        report, counts, _, seconds = cli_main(fed_run, ops, argv, device)
        warm, _, _, warm_seconds = cli_main(fed_run, ops, argv, device)   # started up
        torch.cuda.synchronize()
        (out / f"rank{rank}.json").write_text(json.dumps(
            {"report": report, "kernels": counts, "seconds": seconds, "device": str(device),
             "backend": dist.get_backend(), "warm_seconds": warm_seconds,
             "warm_train_seconds": warm["train_seconds"]}))
        dist.barrier()   # no rank tears the world down under another's feet
        dist.destroy_process_group()
    except BaseException:
        import traceback

        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def sharded_cli(bucketed_report):
    """``CLI_RUNS[SHARDED_CLI_RUN]`` with ``--engine sharded --mesh 2`` on two
    spawned ranks sharing cuda:0 over ``gloo``: every rank's ``mesh`` 2,
    rank 0's JSON ``comparable_report``-equal to the bucketed cuda run's,
    the fit and SDCA kernels launched on each rank."""
    import tempfile

    import torch.multiprocessing as mp

    n = SHARDED_CLI_RANKS
    argv = CLI_RUNS[SHARDED_CLI_RUN][0] + ["--engine", "sharded", "--mesh", str(n)]
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fed_run_sharded_") as tmp:
        port = free_port()
        procs = [ctx.Process(target=sharded_cli_rank, args=(r, n, port, argv, tmp))
                 for r in range(n)]
        for proc in procs:
            proc.start()
        timeout = SHARDED_CLI_DEADLINE.total_seconds()
        for proc in procs:
            proc.join(timeout)
            if proc.is_alive():
                timeout = 0.0   # one rank hung: the others are checked, not waited for
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        codes = [proc.exitcode for proc in procs]
        errors = {r: (Path(tmp) / f"rank{r}.err").read_text()[-3000:] for r in range(n)
                  if (Path(tmp) / f"rank{r}.err").exists()}
        if hung or codes != [0] * n:
            raise AssertionError(f"cli [sharded]: hung ranks {hung}, exit codes {codes}, "
                                 f"errors {errors}")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]
    want = comparable_report(bucketed_report)
    out = {"argv": argv, "ranks": n, "seconds": time.perf_counter() - t0,
           "rank_seconds": [r["seconds"] for r in ranks], "devices": [r["device"] for r in ranks],
           "backend": ranks[0]["backend"], "mesh": [r["report"]["mesh"] for r in ranks],
           "bucketed_train_seconds": bucketed_report["train_seconds"],
           "train_seconds": [r["report"]["train_seconds"] for r in ranks],
           "warm_rank_seconds": [r["warm_seconds"] for r in ranks],
           "warm_train_seconds": [r["warm_train_seconds"] for r in ranks],
           "rank0_equal": comparable_report(ranks[0]["report"]) == want,
           "every_rank_equal": all(comparable_report(r["report"]) == want for r in ranks),
           "kernels": [r["kernels"] for r in ranks]}
    if out["mesh"] != [n] * n or not out["rank0_equal"]:
        raise AssertionError(f"cli [sharded]: mesh {out['mesh']}, rank 0's JSON equal to the "
                             f"bucketed run's: {out['rank0_equal']}")
    idle = [(r, k) for r, c in enumerate(out["kernels"]) for k in SHARDED_KERNELS if not c.get(k)]
    if idle:
        raise AssertionError(f"cli [sharded]: (rank, kernel) {idle} not launched: "
                             f"{out['kernels']}")
    return out


def phase_cli(ops, device):
    """Each ``CLI_RUNS`` round through ``fed_run.main`` with ``--trace`` on
    cuda and on cpu (the plain versions): equal ``comm`` blocks and ledger
    sections, equal headcounts, AUCs within AUC_TOL (the distilled one only
    where the CG converged on both), the fleet summaries byte for byte; the
    trace parses and has ``round.*`` and ``engine.*`` spans and the fleet's
    process track (pid 2); each run's kernels launched on cuda. Then
    ``--mode lm`` at its defaults on both: the reference's keys, equal byte
    counts, finite NLLs."""
    import tempfile

    from repro_torch.launch import fed_run

    out, total, bucketed = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="fed_run_") as tmp:
        for name, (argv, kernels) in CLI_RUNS.items():
            runs = {dev: cli_main(fed_run, ops, argv, dev, Path(tmp) / f"{name}_{dev}.json")
                    for dev in ("cuda", "cpu")}
            (card, counts, doc, card_s), (cpu, _, cpu_doc, cpu_s) = runs["cuda"], runs["cpu"]
            bucketed[name] = card
            _add_counts(total, counts)
            cg = {dev: [e["args"]["iterations"] for e in d["traceEvents"]
                        if e["name"] == "distill.cg"]
                  for dev, d in (("cuda", doc), ("cpu", cpu_doc))}
            converged = all(it < CG_MAXITER for its in cg.values() for it in its)
            a, b = sim_aucs(card, converged), sim_aucs(cpu, converged)
            diff = max(abs(a[k] - b[k]) for k in b) if set(a) == set(b) else math.inf
            with_student = sim_aucs(card), sim_aucs(cpu)
            names = {e["name"] for e in doc["traceEvents"]}
            fleet_track = any(e["ph"] == "M" and e["pid"] == 2 for e in doc["traceEvents"])
            fleet_events = sum(1 for e in doc["traceEvents"]
                               if e.get("cat") == "fleet" and e["pid"] == 2)
            fleet_equal = (json.dumps(card.get("fleet"), sort_keys=True)
                           == json.dumps(cpu.get("fleet"), sort_keys=True))
            out[name] = {
                "argv": argv, "seconds": {"cuda": card_s, "cpu": cpu_s},
                "devices": card["devices"], "eligible": card["eligible"], "best": card["best"],
                "ensemble_auc": {s: {str(k): v for k, v in d.items()}
                                 for s, d in card["ensemble_auc"].items()},
                "comm_equal": card["comm"] == cpu["comm"],
                "ledger_equal": card["obs"]["sections"]["comm"] == cpu["obs"]["sections"]["comm"],
                "headcounts_equal": (card["available"], card["eligible"])
                == (cpu["available"], cpu["eligible"]),
                "max_auc_diff_held": diff, "cg_iterations": cg, "cg_converged": converged,
                "max_auc_diff_with_student": max(abs(with_student[0][k] - with_student[1][k])
                                                 for k in with_student[1]),
                "fleet_equal": fleet_equal, "trace_events": len(doc["traceEvents"]),
                "trace_fleet_events": fleet_events, "kernels": counts,
            }
            held = {k: out[name][k] for k in ("comm_equal", "ledger_equal", "headcounts_equal")}
            if not (all(held.values()) and diff <= AUC_TOL):
                raise AssertionError(f"cli [{name}]: cuda and cpu reports differ: {held}, "
                                     f"AUCs {diff} apart")
            fleet_ok = fleet_equal and fleet_track and fleet_events > 0
            if "--serve-fleet" in argv and not (fleet_ok and card["fleet"]["global"]["conserved"]):
                raise AssertionError(f"cli [{name}]: fleet summaries equal {fleet_equal}, "
                                     f"fleet track {fleet_track}, {fleet_events} fleet events")
            if not (any(n.startswith("round.") for n in names)
                    and any(n.startswith("engine.") for n in names)):
                raise AssertionError(f"cli [{name}]: trace spans {sorted(names)[:40]}")
            idle = [k for k in kernels if not counts.get(k)]
            if idle:
                raise AssertionError(f"cli [{name}]: kernels {idle} not launched: {counts}")
        out["sharded"] = sharded_cli(bucketed[SHARDED_CLI_RUN])
        lm = {dev: cli_main(fed_run, ops, [], dev) for dev in ("cuda", "cpu")}
    (card, counts, _, card_s), (cpu, _, _, cpu_s) = lm["cuda"], lm["cpu"]
    _add_counts(total, counts)
    nll_keys = ("single_member_nll", "ensemble_nll", "student_nll")
    out["lm"] = {"seconds": {"cuda": card_s, "cpu": cpu_s},
                 "keys_equal": tuple(card) == LM_REPORT_KEYS == tuple(cpu),
                 "nll": {dev: {k: r[0][k] for k in nll_keys} for dev, r in lm.items()},
                 "comm": card["one_shot_comm_bytes"], "kernels": counts}
    if not out["lm"]["keys_equal"]:
        raise AssertionError(f"cli [lm]: report keys {list(card)}, want {list(LM_REPORT_KEYS)}")
    for key in ("one_shot_comm_bytes", "fedavg10_comm_bytes", "comm_reduction_vs_fedavg10"):
        if card[key] != cpu[key]:
            raise AssertionError(f"cli [lm]: {key} {card[key]} on cuda, {cpu[key]} on cpu")
    if not all(math.isfinite(r[0][k]) for r in lm.values() for k in nll_keys):
        raise AssertionError(f"cli [lm]: NLLs {out['lm']['nll']}")
    out["kernels"] = total
    return out


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


# a call at least this long is timed by one call alone (its warm-up, or else
# its sizing call): turns guard against the host's drift between short
# runs, which one second outlasts, and a first call's set-up is lost in it
# (the plain SDCA at the ideal takes ~9 s a call)
SLOW_CALL_MS = 1000.0


def time_pair(kernel, plain, args, budget_ms=40.0, library=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    each turn a run of back-to-back calls (L2 warm) sized to ~budget_ms
    from one call made after a warm-up call; with ``library``, its two
    turns go between the kernel's (plain, kernel, library, library,
    kernel, plain). A version whose warm-up or sizing call took
    SLOW_CALL_MS or more takes no turns: that call is its one
    measurement."""
    import torch

    fns = {"plain": plain, "kernel": kernel}
    order = ["plain", "kernel", "kernel", "plain"]
    if library is not None:
        fns["library"] = library
        order[2:2] = ["library", "library"]
    reps, turns = {}, {}
    for label, fn in fns.items():
        first = _time_ms(lambda: fn(*args), 1)   # warm-up: a first call pays set-up
        if label == "library":   # SDPA's first call at a shape may also pick and build its backend
            first = _time_ms(lambda: fn(*args), 1)
        if first >= SLOW_CALL_MS:   # set-up is lost in a call this long: its one measurement
            reps[label], turns[label] = 1, [first]
            continue
        once = _time_ms(lambda: fn(*args), 1)   # then size the run
        reps[label] = max(1, min(200, int(budget_ms / max(once, 1e-3))))
        turns[label] = [once] if once >= SLOW_CALL_MS else []
    for label in order:
        if turns[label] and turns[label][0] >= SLOW_CALL_MS:
            continue
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


@functools.lru_cache(maxsize=4)
def window_mask(Sq, Skv, causal, window, device):
    """The keys each query sees under the causal and window masks, (Sq, Skv)
    bool, made once a shape."""
    import torch

    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = kp > qp - window
    return mask & (kp <= qp) if causal else mask


def sdpa_library(q, k, v, causal, window):
    """The yardstick for flash attention: one PyTorch call on the same
    tensors, in its (B, heads, S, hd) layout (transposed views); with a
    window, the masks as a boolean ``attn_mask`` (made once a shape)."""
    import torch.nn.functional as F

    kw = {"is_causal": causal}
    if window:
        kw = {"attn_mask": window_mask(q.shape[1], k.shape[1], causal, window, q.device)}
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), enable_gqa=True,
                                          **kw).transpose(1, 2)


TIMING_CASES = {
    # first case of each kernel is the one the summary line reports
    "batched_rbf_gram": ("fit g256 b64", "fit g256 b128", "fit g128 b256", "score g256 q16 b64",
                         "score g256 q56 b64", "score g128 q184 b256",
                         "fit dirichlet g256 b64 d16"),
    "rbf_gram": ("ideal 2000x2000x32",),
    "ensemble_score": ("full b8192 k2821 n230", "k100 b8192 n230",
                       "ideal predict b8192 k1 n2000", "population b4096 k50 n40 d16",
                       "fleet d8 b32 k4 n40", "wide b8192 k282 n230 d784"),
    "sdca": ("ideal g1 b2048 n2000", "ideal emnist g1 b2048 n2000", "group g256 b64",
             "group g128 b256", "group dirichlet g256 b64", "wide ideal emnist g1 b16384 e1"),
    "gram_matvec": ("cg l4096 d32", "cg emnist l4096 d32", "cg l4096 d16", "wide cg l4096 d784"),
    "rbf_gram_q8": ("student predict b8192 n4096 d32", "student emnist b8192 n4096 d32",
                    "wide student b8192 n4096 d784"),
    "ensemble_score_q8": ("full b8192 k2821 n230", "k100 b8192 n230", "fleet d8 b32 k4 n40",
                          "wide b8192 k282 n230 d784"),
    "flash_attention": ("serve b4 s2048 h32 k8 hd64 causal bfloat16",
                        "serve b4 s2048 h32 k8 hd64 causal float32",
                        "llava prefill b4 s4928 h32 k8 hd128 causal bfloat16",
                        "whisper encoder b4 s1500 h8 k8 hd64 non-causal bfloat16",
                        "phi3-mini prefill b4 s2048 h32 k32 hd96 causal window2047 bfloat16",
                        "phi3-mini prefill b4 s2048 h32 k32 hd96 causal window2047 float16",
                        "gemma prefill b4 s2048 h8 k1 hd256 causal bfloat16",
                        "chunked b1 s2048 h8 k8 hd512 causal bfloat16",
                        "chunked b1 s2048 h8 k8 hd512 causal float16",
                        "chunked b1 s2048 h8 k8 hd512 causal float32"),
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

    cases = {name: dict(c) for name, c in shared_cases(ops).items()}
    rows = []
    for name, labels in TIMING_CASES.items():
        if name not in names:
            continue
        spec = ops.KERNEL_REGISTRY[name]
        for label in labels:
            t_row = time.perf_counter()
            args = case_args(cases[name][label])
            targs = to_device(args, device)
            library = LIBRARY.get(name)
            turns, reps = time_pair(spec.kernel, spec.plain, targs, library=library)
            try:
                dev_ms, dev_launches, dev_split, windows = device_time(
                    spec.kernel, targs, reps["kernel"], mean(turns["kernel"]))
            except AssertionError as e:
                raise AssertionError(f"{name} [{label}]: {e}") from e
            bound_s, bound_by = kernel_bound(name, args)
            ops_n, bytes_n = kernel_cost(name, spec.kernel, args)
            row = {
                "kernel": name, "case": label,
                "ms": mean(turns["kernel"]), "device_ms": dev_ms,
                "device_launches_recorded": dev_launches, "device_kernels": dev_split,
                "device_windows": windows,
                "plain_ms": mean(turns["plain"]),
                "library_ms": mean(turns["library"]) if library else None,
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
            row["seconds"] = time.perf_counter() - t_row   # the row's wall, set-up included
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


def phase_profile(ops, device, names, timing_rows, make_dataset, run_protocol, trace):
    """Every ``TIMING_CASES`` call once more through its dispatcher under a
    tracer: the traced result bitwise the untraced one, the span's
    ``flops`` and ``bytes_accessed`` > 0, ``0 < roofline_frac <=
    PROFILE_FRAC_MAX`` and ``roofline_bound_us`` the ``timing`` table's
    bound (one function computes both); then ``main``'s emnist round under
    a tracer: one ``kernel.<name>`` span per launch of every kernel."""
    import math

    import torch

    from repro_torch.obs.profile import kernel_bound

    cases = {name: dict(c) for name, c in shared_cases(ops).items()}
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
    pop_memory = None   # population (c)'s workers, once started
    if "build" in phases and {"kernels", "timing", "profile"} & set(phases):
        start_cases(ops)
    for phase in PHASES:
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        try:
            if phase == "build":
                out, logs = phase_build(native)
                detail["nvcc"] = logs
                if "population" in phases:   # its traced passes, beside the next phases
                    pop_memory = start_population_memory()
            elif phase == "kernels":
                out, errs = phase_kernels(ops, device, names)
            elif phase == "parity":
                out = phase_parity(make_dataset, run_protocol, DistillConfig)
            elif phase == "main":
                out, artifacts[phase] = phase_main(make_dataset, run_protocol, ops, trace,
                                                   FP32_KERNELS, gram=True, sharded=True)
                counts[phase] = out["kernels"]
                counts["sharded"] = out["sharded"]["kernels"]
            elif phase == "main_q8":
                out, artifacts[phase] = phase_main(
                    make_dataset, run_protocol, ops, trace, FP32_KERNELS + Q8_KERNELS,
                    codec="int8", distill=DistillConfig(proxy_size=4096, solver="cg"))
                counts[phase] = out["kernels"]
            elif phase == "population":
                out = phase_population(ops, trace, DistillConfig, device, pop_memory)
                counts[phase] = out["kernels"]
            elif phase == "agg":
                out = phase_agg(make_dataset, run_protocol, ops, trace, DistillConfig, device)
                counts[phase] = out["kernels"]
            elif phase == "wide":
                out = phase_wide(ops, trace, device)
                counts[phase] = out["kernels"]
            elif phase == "lm_parity":
                out = phase_lm_parity(ops, device)
            elif phase == "serve":
                out = phase_serve(ops, device)
                counts[phase] = out["kernels"]
            elif phase == "head_dims":
                out = phase_head_dims(ops, device)
                counts[phase] = out["kernels"]
            elif phase == "train":
                out = phase_train(ops, trace, device)
                counts[phase] = out["full"]["kernels"]
                counts["mesh"] = out["mesh"]["kernels"]
            elif phase == "deep":
                out = phase_deep(ops, device)
                counts[phase] = out["full"]["kernels"]
            elif phase == "families":
                out = phase_families(ops, device)
                counts[phase] = out["kernels"]
            elif phase == "cli":
                out = phase_cli(ops, device)
                counts[phase] = out["kernels"]
            elif phase == "fleet":
                out = phase_fleet(make_dataset, run_protocol, DistillConfig, ops, artifacts)
                counts[phase] = out["kernels"]
            elif phase == "timing":
                out = phase_timing(ops, device, np.random.default_rng(0), names)
                timing = {r["kernel"]: r for r in reversed(out["rows"])}
            else:
                bounds = {(r["kernel"], r["case"]): r["bound_ms"]
                          for r in detail.get("timing", {}).get("rows", [])}
                out = phase_profile(ops, device, names, bounds,
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
        if phase == "head_dims":   # the sweep's rows go to --out only
            out = {**out, "sweep": {k: v for k, v in out["sweep"].items() if k != "rows"}}
        emit(out)

    import torch.distributed as dist

    if dist.is_initialized():   # main's sharded round started a one-rank world
        dist.destroy_process_group()

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
            "launches_mesh": counts.get("mesh", {}).get(name),
            "launches_deep": counts.get("deep", {}).get(name),
            "launches_families": counts.get("families", {}).get(name),
            "launches_cli": counts.get("cli", {}).get(name),
            "launches_sharded": counts.get("sharded", {}).get(name),
            "launches_wide": counts.get("wide", {}).get(name),
            "launches_head_dims": counts.get("head_dims", {}).get(name),
            "max_abs_err": errs.get(name), "ms": row.get("ms"), "device_ms": row.get("device_ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"), "library_ms": row.get("library_ms"),
        }
        for kind in ("bf16", "fp16"):
            if f"{name}/{kind}" in errs:
                entry[f"max_abs_err_{kind}"] = errs[f"{name}/{kind}"]
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
