"""Design choices of the port's redesigned CUDA kernels, checked on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What can be held here is the plan and the arithmetic they follow:

- ``ensemble_score``'s split plan (``kernels/ensemble_score.py::split_plan``)
  covers every (member, support tile) work item exactly once and is chosen
  without the query count, so a query's score cannot depend on b; its
  chunked kernel's walk (two items a step, 64 features a step) visits every
  (item, chunk) once and adds each thread's terms in the staged kernel's
  order, and its three-slot ``cp.async`` ring, modelled step by step, never
  reads a slot before its copies land nor refills it before its last read;
- the bf16 tensor-core flash kernel's arithmetic (``csrc/flash_attention_tc.cu``),
  emulated in plain PyTorch: bf16 products summed in fp32, the online softmax
  in the log2 domain over 64-key tiles, P split into two bf16 parts for P V.
  The emulation stays within the on-card bf16 tolerance of the plain version
  and of the JAX reference's oracle;
- the chunked flash kernels past hd 256 (``csrc/flash_chunked.cuh``): the
  cluster's partition of hd sums every column into S once and writes every
  column of o once (at hd 257 to 2,100), the plan mirrors the header, the
  tensor-core kernel's arithmetic (each CTA's part of S, the parts added in
  rank order, then the one-pass kernel's softmax and P_hi + P_lo), emulated,
  holds the bf16 tolerance against the plain version and the oracle at hd
  320, 333 and 512, and both kernels' shared-memory formulas mirror the
  sources;
- the tiled, delayed-update SDCA kernel's order (``csrc/sdca.cu``), emulated in
  plain PyTorch (``tests/test_torch_sdca_order.py``): fp64 tile matvecs summed lane by
  lane over 4-column groups, then by a butterfly across the lanes, one tile
  ahead of the steps; fp64 in-tile updates; past bucket 12,384 the cluster
  kernel's, each of 16 ranks summing its slice of columns that way and the
  ranks' sums added in rank order. Both emulations stay within the
  registry's 1e-5 of the plain version on the pooled-data ideal of the emnist
  federation, whose alphas are not all 0 or 1, and on the engine's group
  shapes; the slices cover every column once, the copy ring's schedule waits
  on no later phase, and the cluster's constants and shared memory mirror
  the source;
- the ``gram_matvec`` kernel (``csrc/gram_matvec.cu``): its split plan
  covers every support tile once, its tile constants mirror the source, and
  its per-pair arithmetic and order of summation, emulated in plain PyTorch
  (fp32 FMA chains over ascending features, expf, fp64 sums thread by
  thread, then group by group, then split by split), stay within the registry's 1e-5
  of the plain version on the CG's l = 4096 inputs: random normals and the
  round's own validation-pool proxy rows; its chunked route past d 64: the
  prologue's three bf16 planes give back each value to within 2^-24 of
  itself and its norms are those of the chunked kernel it replaced, the
  scratch and constants mirror the source, and the six plane products a
  64-feature step (hi.hi in an accumulator of its own, adds rounded to
  nearest or truncated), fp64 across steps, with the route's order of
  sums over supports, stay within the tolerance (below);
- the ``rbf_gram_q8`` kernel (``csrc/gram_q8.cu``): int8 values are exact
  in bf16, three bf16 planes carry x * scale to fp32 accuracy, its split
  plan covers every support tile once, its tile constants mirror the
  source, and its arithmetic, emulated in plain PyTorch (the planes times q
  as exact products summed into an fp32 accumulator one 16-feature mma at a
  time, hi, mid, lo, then x . zero, the fp32 norms and the epilogue), stays
  within the registry's 1e-5 of the plain version on the registry's two
  cases, normal data and the round's own int8 student
  (``ops.make_q8_student_problem``), with the accumulator rounded to
  nearest or truncated toward zero; its chunked route past d 128: the
  prologue's planes, q image and norms are bitwise what that emulation
  multiplies and adds, its split plan covers every support tile once in
  one wave, its mbarrier ring frees every slot once and only after the
  products that read it, and its constants and scratch mirror the source;
- the fp32 RBF Gram kernel (``csrc/gram.cu``, ``batched_rbf_gram`` and
  ``rbf_gram``): its host plan (``kernels/batched_gram.py::tile_plan``)
  takes (m, n, d) alone, covers every output once and computes at most a
  fifth of rows or columns past m or n at the round's 15 launch shapes, its
  constants mirror the source, and its arithmetic, emulated in plain
  PyTorch (both operands in three bf16 planes, the six products in the
  kernel's order into an fp32 accumulator rounded to nearest or truncated,
  the norms as four fmaf chains a row), stays within the registry's 1e-5 of
  the plain version on the round's own fit group
  (``ops.make_fit_group_problem``, whose first call in the bucketed round
  it is), the ideal's 2,000 rows, normals and the registry's cases;
- the wide paths: mirrors of the four launchers' choices keep the staged
  kernels where they ran before (the scorers to d 220, ``gram_matvec`` to
  d 64, ``rbf_gram_q8`` to d 128, SDCA to bucket 12,352 of the 64-row
  quantum; every shape of today's paths) and fit the chunked and global-memory
  instantiations at every d to 4,096 and bucket to 65,536; the chunked
  orders at d 64, 220 and 784 on emnist rows: ``rbf_gram_q8``'s the
  staged order's bits, ``gram_matvec``'s chunked route (tensor-core plane
  products, fp64 across 64-feature steps) within the registry's 1e-5 of
  the plain version and of the staged order, where the staged kernel's
  one fp32 chain drifts past it at d 784.
"""
import functools
import importlib.util
import inspect
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.utils.seeds import derive_stream_seed
from repro_torch.kernels import batched_gram as bg
from repro_torch.kernels import ensemble_score as ens
from repro_torch.kernels import gram_matvec as gmv
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram_q8 as q8
from repro_torch.kernels import sdca as sdca_mod
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain

from test_torch_sdca_order import (SDCA_CH, sdca_cluster_emulated, sdca_cluster_smem_bytes,
                                   sdca_ring_stages, sdca_tiled_emulated)

# one intra-op thread: pytest-xdist workers run whole files side by side,
# and torch's default of a thread a core would oversubscribe the host
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4   # chip_smoke.py's bf16 tolerance
BQ, BK = 128, 64                         # query rows and keys per tile, as the kernel
LOG2E = 1.4426950408889634


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(11, purpose, index))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py as a module (it imports nothing but the standard library)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flash_shapes():
    """chip_smoke.py's FLASH_SHAPES."""
    return _chip_smoke().FLASH_SHAPES


# ----------------------------------------------------------------------
# the scorer's split plan
# ----------------------------------------------------------------------

def test_split_plan_does_not_take_the_query_count():
    assert list(inspect.signature(ens.split_plan).parameters) == ["k", "n_max"]


@pytest.mark.parametrize("n_max", [48, 77, 230, 2000])
@pytest.mark.parametrize("k", [1, 3, 100, 2821])
def test_split_plan_covers_every_item_once(k, n_max):
    plan = ens.split_plan(k, n_max)
    assert plan.tiles == -(-n_max // ens.SUPPORT_TILE)
    assert 1 <= plan.splits <= ens.SPLIT_TARGET
    seen = [item for s in range(plan.splits) for item in plan.work(s)]
    want = [(t, j) for t in range(k) for j in range(plan.tiles)]
    assert seen == want                      # each once, member-major, in split order
    assert all(plan.work(s) for s in range(plan.splits))   # no empty split
    assert plan.work(plan.splits) == []
    # one item a split while the items are few; else close to the target
    if plan.items <= ens.SPLIT_TARGET:
        assert plan.per_split == 1 and plan.splits == plan.items
    else:
        assert 2 * plan.splits > ens.SPLIT_TARGET


# the chunked scorer's walk (csrc/ensemble_score.cu, partials_chunked_kernel)
ENS_DC = 64      # its DC: features a step
ENS_WROWS = 8    # its WROWS: the support rows of a warp (two groups of TS = 4)


def _ens_source():
    return (ROOT / "src/repro_torch/kernels/csrc/ensemble_score.cu").read_text()


def chunked_walk(plan, split, d):
    """The chunked kernel's steps for split ``split`` at feature dim d, in
    order: (the step's items, its first feature, its width). Its items go
    in pairs, an odd last one alone; each pair's chunks in order."""
    dp = -(-d // 4) * 4
    chunks = -(-dp // ENS_DC)
    i0 = split * plan.per_split
    i1 = min(i0 + plan.per_split, plan.items)
    for s in range((i1 - i0 + 1) // 2 * chunks):
        p, k = divmod(s, chunks)
        yield ([i for i in (i0 + 2 * p, i0 + 2 * p + 1) if i < i1], k * ENS_DC,
               min(ENS_DC, dp - k * ENS_DC))


def _item_rows(plan, n_max, item):
    return min(ens.SUPPORT_TILE, n_max - (item % plan.tiles) * ens.SUPPORT_TILE)


def _group_terms(plan, n_max, grp, items):
    """(member, support) terms of support group ``grp`` over ``items`` in
    order, each item's four supports where the group's warp has real rows
    of it (the warp skips it else)."""
    out = []
    for it in items:
        t, tile = divmod(it, plan.tiles)
        if ENS_WROWS * (grp // 2) < _item_rows(plan, n_max, it):
            out += [(t, tile * ens.SUPPORT_TILE + 4 * grp + s) for s in range(4)]
    return out


@pytest.mark.parametrize("d", [64, 221, 784])
@pytest.mark.parametrize("k, n_max", [(1, 48), (3, 77), (7, 230), (282, 230), (301, 20),
                                      (540, 77)])
def test_chunked_scorer_walk_covers_every_chunk_once_in_the_staged_order(k, n_max, d):
    """Every (member, tile, chunk) once, each item's chunks in feature
    order over its split's steps, the splits the plan's; and each thread's
    per-query sum takes its (member, support) terms in the staged kernel's
    order: at a pair's last chunk item A's four supports, then B's."""
    src = _ens_source()
    for line in ("  const int steps = (i1 - i0 + 1) / 2 * chunks;",
                 "    const int p = s / chunks, k = s - p * chunks, width = min(DC, dp - k * DC);",
                 "    const Item A = item(i0 + 2 * p), B = item(i0 + 2 * p + 1);",
                 "    const bool doA = r0 < A.rows, doB = r0 < B.rows;",
                 "    if (k == chunks - 1) {  // the pair's last chunk: A's exp, then B's\n"
                 "      if (doA) rbf(a, 0);\n      if (doB) rbf(bb, 1);"):
        assert line in src, line
    plan = ens.split_plan(k, n_max)
    dp = -(-d // 4) * 4
    starts = list(range(0, dp, ENS_DC))
    seen = []
    for split in range(plan.splits):
        steps = list(chunked_walk(plan, split, d))
        visits = [(it, c0) for items, c0, _ in steps for it in items]
        items = sorted({it for it, _ in visits})
        assert [divmod(it, plan.tiles) for it in items] == plan.work(split)
        for it in items:
            assert [c0 for i, c0 in visits if i == it] == starts
        assert all(w % 4 == 0 and 0 < w <= ENS_DC and c0 + w <= dp for _, c0, w in steps)
        seen += items
        last = [items for items, c0, w in steps if c0 + w == dp]
        for grp in range(16):
            chunked = _group_terms(plan, n_max, grp, [it for pair in last for it in pair])
            assert chunked == _group_terms(plan, n_max, grp, items)   # the staged kernel's walk
    assert seen == list(range(plan.items))


@pytest.mark.parametrize("int8", [False, True])
def test_chunked_scorer_ring_holds_each_step_until_it_is_read(int8):
    """The chunked kernel's three-slot ring, modelled step by step: the
    copies committed at step s (after its barrier) are step s + 2's
    queries' chunk and (fp32) items' chunks, or (int8) step s + 3's raw
    chunks; a step waits with cp.async.wait_group<STAGES - 2>, so it sees
    the groups committed two or more steps before. Every read finds the
    step it wants landed, and no copy overwrites a slot before its last
    read (int8: raw slot v read by the dequantisation at step v - 1, tile
    v & 1 written there and read at step v)."""
    src = _ens_source()
    for line in ("    cp_async_wait<STAGES - 2>();\n    __syncthreads();",
                 "    prefetch(s + 2);", "    if (u < steps) stage_x(u);",
                 "    if (u + INT8 < steps) stage_items(u + INT8);",
                 "  if (INT8 && steps > 0) stage_items(0);\n  prefetch(0);\n  cp_async_commit();\n"
                 "  prefetch(1);\n  cp_async_commit();",
                 "    if (INT8 && s + 1 < steps) dequantise_step(s + 1);"):
        assert line in src, line
    stages = ENS_STAGES
    for steps in range(1, 14):
        slots = {}   # (buffer, slot) -> (step held, committed at, read last at)
        pending = []   # (committed at, buffer, slot, step)

        def prefetch(u, at):
            if u < steps:
                pending.append((at, "x", u % stages, u))
            v = u + int8
            if v < steps:
                pending.append((at, "raw" if int8 else "items", v % stages, v))

        def land(upto):   # wait_group: every group committed at or before `upto`
            for g in [g for g in pending if g[0] <= upto]:
                pending.remove(g)
                at, buf, slot, step = g
                slots[(buf, slot)] = step

        def read(buf, slot, step):
            assert slots.get((buf, slot)) == step, (steps, buf, slot, step, slots)
            assert not [g for g in pending if (g[1], g[2]) == (buf, slot)], (buf, slot, step)

        if int8:
            pending.append((-2, "raw", 0, 0))
        prefetch(0, -2)
        prefetch(1, -1)
        tiles = {}
        if int8:
            land(-2)
            read("raw", 0, 0)
            tiles[0] = 0
        for s in range(steps):
            land(s - 2)
            prefetch(s + 2, s)   # after the barrier: every thread is done with step s - 1
            if int8 and s + 1 < steps:
                read("raw", (s + 1) % stages, s + 1)
                tiles[(s + 1) % 2] = s + 1
            read("x", s % stages, s)
            if int8:
                assert tiles[s % 2] == s
            else:
                read("items", s % stages, s)


# ----------------------------------------------------------------------
# the bf16 tensor-core flash kernel's arithmetic
# ----------------------------------------------------------------------

def _tile_range(q0, q_last, Skv, causal, window, bq=BQ, bk=BK):
    """The kernel's kv tiles of bk keys for a query tile of bq rows
    (flash_attention_tc.cu's tile_range<TBQ, TBK>)."""
    t_lo, t_hi = 0, -(-Skv // bk)
    if not (window > 0 and q_last - window + 1 >= Skv):
        if causal:
            t_hi = min(t_hi, q_last // bk + 1)
        if window > 0:
            t_lo = max(0, q0 - window + 1) // bk
    return t_lo, t_hi


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_tc_emulated(q, k, v, causal=True, window=0):
    """The tensor-core kernel's arithmetic in plain PyTorch, one 128-row
    query tile at a time: fp32 scores from the bf16 inputs, scaled into the log2
    domain and masked (-inf past Skv, -1e9 for causal and window), the
    online softmax over 64-key tiles with exp2, P V as P_hi V + P_lo V with
    P_hi = bf16(p) and P_lo = bf16(p - P_hi), the output acc / max(l, 1e-20)
    rounded once to bf16."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = H // K
    scale2 = np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)
    qf = q.float().permute(0, 2, 1, 3)                                    # (B, H, Sq, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)      # (B, H, Skv, hd)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        t_lo, t_hi = _tile_range(q0, int(rows[-1]), Skv, causal, window)
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), hd))
        for t in range(t_lo, t_hi):
            keys = torch.arange(t * BK, min(t * BK + BK, Skv))
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows], kf[:, :, keys]) * scale2
            kp, qp = keys[None, :], rows[:, None]
            masked = torch.zeros((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                masked |= kp > qp
            if window > 0:
                masked |= kp <= qp - window
            s = torch.where(masked, torch.tensor(NEG_INF), s)
            # the kernel's tile is 64 keys wide: keys past Skv are -inf, p = 0
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = corr * l + p.sum(-1)
            p_hi = _bf16(p)
            p_lo = _bf16(p - p_hi)
            vt = vf[:, :, keys]
            acc = corr[..., None] * acc + (p_hi @ vt + p_lo @ vt)
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _flash_cases():
    cases = [("registry", ops.KERNEL_REGISTRY["flash_attention"].make_inputs, True, 0),
             ("ragged", ops.KERNEL_REGISTRY["flash_attention"].make_ragged, True, 0),
             ("ragged non-causal window16", ops.KERNEL_REGISTRY["flash_attention"].make_ragged,
              False, 16)]
    for label, (B, S, H, K, hd), causal, window in _flash_shapes():
        if label.startswith("serve"):   # the full serve shape runs on the card only
            continue
        cases.append((label, (B, S, H, K, hd), causal, window))
    return cases


FLASH_CASES = _flash_cases()


def _flash_inputs(case, rng):
    _, shape, causal, window = case
    if callable(shape):
        q, k, v = shape(rng)
    else:
        B, S, H, K, hd = shape
        q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, K, K))
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal, window


@pytest.mark.parametrize("case", range(len(FLASH_CASES)),
                         ids=[c[0].replace(" ", "-") for c in FLASH_CASES])
def test_flash_tc_arithmetic_holds_the_bf16_tolerance(case):
    """The emulated kernel against the plain version (both in bf16, compared
    in fp32) at chip_smoke.py's bf16 tolerance, 1e-4 + 2^-7 |plain|, and
    against the reference's oracle on the same bf16 values at the same
    tolerance."""
    (q, k, v), causal, window = _flash_inputs(FLASH_CASES[case], _rng("flash-tc", case))
    got = flash_tc_emulated(q, k, v, causal, window).float()
    want = flash_attention_plain(q, k, v, causal, window).float()
    assert bool(((got - want).abs() <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    oracle = np.asarray(ref.flash_attention_ref(  # repro: allow[kernel-registry-bypass] reason=parity test against the reference's oracle, as tests/test_kernels.py does
        *(t.float().numpy() for t in (q, k, v)), causal=causal, window=window))
    assert np.all(np.abs(got.numpy() - oracle) <= BF16_ATOL + BF16_RTOL * np.abs(oracle))


def test_two_part_p_keeps_sixteen_bits():
    """P_hi + P_lo is within 2^-16 of p relative, where one bf16 is only
    within 2^-8: the reason the kernel runs P V twice."""
    p = torch.from_numpy(_rng("p-split").random(100_000).astype(np.float32))
    p_hi = _bf16(p)
    two = p_hi + _bf16(p - p_hi)
    assert float(((two - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((p_hi - p).abs() / p).max()) > 2.0 ** -10


# ----------------------------------------------------------------------
# the chunked flash kernels past hd 256: the cluster's partition of hd,
# the tensor-core kernel's arithmetic, the shared-memory formulas
# ----------------------------------------------------------------------

CSRC = ROOT / "src/repro_torch/kernels/csrc"
CW = 256          # flash_attention.CHUNK: the columns of q, k, v and o a CTA stages
MAX_CLUSTER = 8   # flash_chunked.cuh's MAX_CLUSTER, the portable cluster size
CH_BQ, CH_BK = 128, 32   # flash_attention_tc.cu's chunked tile: BQ rows, CBK keys a step


def chunk_plan(hd, cw=CW):
    """flash_chunked.cuh's plan: (nc CTAs a cluster, each CTA's slice ss of
    hd, nsub CW-wide sub-chunks of a slice = steps a kv tile = groups of O)."""
    nc = min(MAX_CLUSTER, -(-hd // cw))
    ss = -(-(-(-hd // nc)) // 16) * 16
    return nc, ss, -(-ss // cw)


def chunk_ctas(hd, cw=CW):
    """Every CTA of one query tile's clusters, as the kernels index them:
    (group, rank) -> (the hd columns it sums into S, its step order; the
    columns of o it writes)."""
    nc, ss, nsub = chunk_plan(hd, cw)
    ctas = {}
    for grp in range(nsub):
        for rank in range(nc):
            sc0 = rank * ss
            se = min(sc0 + ss, hd)
            s_cols = [c for j in range(nsub) for c in range(sc0 + j * cw, min(sc0 + (j + 1) * cw, se))]
            oc0 = sc0 + grp * cw
            ctas[grp, rank] = (s_cols, list(range(oc0, min(oc0 + cw, se))))
    return ctas


CHUNK_HDS = [257, 320, 333, 512, 1000, 2100]


@pytest.mark.parametrize("hd", CHUNK_HDS)
def test_chunked_partition_sums_each_column_once_and_writes_each_output_once(hd):
    """Each cluster (one O group of a query tile) sums every hd column into
    S exactly once, split over its CTAs; every column of o is written by
    exactly one CTA; every rank holds a column. Up to hd 2,048 (8 CTAs of
    256 columns) a query tile is one cluster, so S is summed once a (query
    tile, kv tile); past it once per O group."""
    nc, ss, nsub = chunk_plan(hd)
    ctas = chunk_ctas(hd)
    for grp in range(nsub):
        s_cols = [c for rank in range(nc) for c in ctas[grp, rank][0]]
        assert sorted(s_cols) == list(range(hd))
        assert all(ctas[grp, rank][0] for rank in range(nc))
    o_cols = [c for cols in ctas.values() for c in cols[1]]
    assert sorted(o_cols) == list(range(hd))
    assert ss % 16 == 0 and nc <= MAX_CLUSTER
    assert (nsub == 1) == (hd <= MAX_CLUSTER * CW)
    # rows: the query tiles partition the rows, so each (row, column) of o
    # is one CTA's
    rows = [r for q0 in range(0, 333, CH_BQ) for r in range(q0, min(q0 + CH_BQ, 333))]
    assert rows == list(range(333))


def test_chunked_plan_mirrors_the_header():
    """chunk_plan is flash_chunked.cuh's plan, term for term, and both
    kernels launch with it at CW = flash_attention.CHUNK."""
    from repro_torch.kernels import flash_attention as fa

    src = (CSRC / "flash_chunked.cuh").read_text()
    for line in ("constexpr int MAX_CLUSTER = 8;",
                 "  p.nc = (hd + cw - 1) / cw;",
                 "  if (p.nc > MAX_CLUSTER) p.nc = MAX_CLUSTER;",
                 "  const int per = (hd + p.nc - 1) / p.nc;",
                 "  p.ss = (per + 15) / 16 * 16;",
                 "  p.nsub = (p.ss + cw - 1) / cw;"):
        assert line in src
    assert fa.CHUNK == CW
    for name in ("flash_attention", "flash_attention_tc"):
        text = (CSRC / f"{name}.cu").read_text()
        assert "flash_chunked::plan(hd, CW)" in text
        assert "const int sc0 = rank * ss, se = min(sc0 + ss, hd);" in text
        assert "const int oc0 = sc0 + grp * CW, oce = min(oc0 + CW, se);" in text


def flash_tc_chunked_emulated(q, k, v, causal=True, window=0):
    """The chunked tensor-core kernel's arithmetic in plain PyTorch: per
    query tile of CH_BQ rows and kv tile of CH_BK keys, each CTA's part of
    the scores (its slice's columns, fp32 products of the bf16 inputs) is
    summed, and the parts are added in rank order, ((p0 + p1) + p2) + ...;
    then the online softmax in the log2 domain (masks as in the one-pass
    kernel), P V as P_hi V + P_lo V, the output acc / max(l, 1e-20) rounded
    once to bf16."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    rep = H // K
    scale2 = np.float32(1.0 / math.sqrt(hd)) * np.float32(LOG2E)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    ctas = chunk_ctas(hd)
    nc, _, nsub = chunk_plan(hd)
    assert nsub == 1, "the emulation covers hd up to 2,048, one sub-chunk a slice"
    slices = [torch.tensor(ctas[0, rank][0]) for rank in range(nc)]
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32)
    for q0 in range(0, Sq, CH_BQ):
        rows = torch.arange(q0, min(q0 + CH_BQ, Sq))
        t_lo, t_hi = _tile_range(q0, int(rows[-1]), Skv, causal, window, CH_BQ, CH_BK)
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), hd))
        for t in range(t_lo, t_hi):
            keys = torch.arange(t * CH_BK, min(t * CH_BK + CH_BK, Skv))
            s = None
            for cols in slices:   # the parts in rank order
                part = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows][..., cols],
                                    kf[:, :, keys][..., cols])
                s = part if s is None else s + part
            s = s * scale2
            kp, qp = keys[None, :], rows[:, None]
            masked = torch.zeros((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                masked |= kp > qp
            if window > 0:
                masked |= kp <= qp - window
            s = torch.where(masked, torch.tensor(NEG_INF), s)
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = corr * l + p.sum(-1)
            p_hi = _bf16(p)
            p_lo = _bf16(p - p_hi)
            vt = vf[:, :, keys]
            acc = corr[..., None] * acc + (p_hi @ vt + p_lo @ vt)
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


CHUNKED_EMULATED = [(hd, mask) for hd in (320, 333, 512) for mask in range(4)]


@pytest.mark.parametrize("hd,mask", CHUNKED_EMULATED,
                         ids=[f"hd{hd}-mask{m}" for hd, m in CHUNKED_EMULATED])
def test_flash_tc_chunked_arithmetic_holds_the_bf16_tolerance(hd, mask):
    """The emulated chunked kernel against the plain version and the
    reference's oracle at the bf16 tolerance, 1e-4 + 2^-7 |plain|, under
    chip_smoke.py's four head-dim masks (1 and 4 query heads per KV head,
    causal, windows, 200 and 333 rows)."""
    label, (B, Sq, Skv, H, K), causal, window = _chip_smoke().HD_MASKS[mask]
    rng = _rng("flash-chunked-" + label, hd)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, hd)).astype(np.float32)).to(torch.bfloat16)
               for S, h in ((Sq, H), (Skv, K), (Skv, K)))
    got = flash_tc_chunked_emulated(q, k, v, causal, window).float()
    want = flash_attention_plain(q, k, v, causal, window).float()
    assert bool(((got - want).abs() <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    oracle = np.asarray(ref.flash_attention_ref(  # repro: allow[kernel-registry-bypass] reason=parity test against the reference's oracle, as tests/test_kernels.py does
        *(t.float().numpy() for t in (q, k, v)), causal=causal, window=window))
    assert np.all(np.abs(got.numpy() - oracle) <= BF16_ATOL + BF16_RTOL * np.abs(oracle))


def test_chunked_smem_formulas_match_the_sources():
    """The chunked kernels' shared memory, term for term with the sources:
    the tensor-core kernel's q slice, three steps of K and V and its warps'
    parts of S; the fp32 kernel's q slice, two K buffers, one V, the four
    warp pairs' parts of S, P^T and the rows' corrections. Each fits a
    block's 227 KB, one block an SM."""
    tc = (CSRC / "flash_attention_tc.cu").read_text()
    f32 = (CSRC / "flash_attention.cu").read_text()
    ld = CW + 8
    tc_bytes = 2 * (CH_BQ * ld + 3 * 2 * CH_BK * ld) + 4 * CH_BQ * CH_BK
    assert "constexpr int BQ = 128;" in tc and f"constexpr int CBK = {CH_BK};" in tc
    assert "constexpr int CSTAGES = 3;" in tc
    assert "  static constexpr int STAGE = 2 * CBK * LD;" in tc
    assert "  static constexpr int BYTES = 2 * (BQ * LD + CSTAGES * STAGE) + 4 * BQ * CBK;" in tc
    assert "__launch_bounds__(THREADS, 1)\nflash_tc_chunked_kernel(" in tc
    bq, bk, groups, cld, tld = 64, 32, 4, CW + 4, 64 + 4
    f32_bytes = 4 * (bq * cld + 3 * bk * cld + groups * bq * bk + bk * tld + bq)
    for line in ("constexpr int CBK = 32;", "constexpr int GROUPS = 4;",
                 "constexpr int CLD = CW + 4;", "constexpr int TLD = BQ + 4;",
                 "  return BQ * CLD + 3 * CBK * CLD + GROUPS * BQ * CBK + CBK * TLD + BQ;"):
        assert line in f32, line
    assert "__launch_bounds__(THREADS, 1)\nflash_chunked_kernel(" in f32
    for b in (tc_bytes, f32_bytes):
        assert b <= MAX_SMEM
        assert 2 * (b + 1024) > 233_472   # one block an SM
    assert (tc_bytes, f32_bytes) == (185_344, 208_128)


# ----------------------------------------------------------------------
# the tiled, delayed-update SDCA kernel's order
# ----------------------------------------------------------------------

def _sdca_plain(args):
    K, y, n_real, lam, epochs = args
    return sdca_mod.sdca_plain(torch.from_numpy(K), torch.from_numpy(y),
                               torch.from_numpy(n_real), lam, epochs)


@functools.lru_cache(maxsize=None)
def _ideal(seed):
    """The emnist ideal's SDCA problem and the plain version's alpha."""
    args = ops.make_ideal_sdca_problem(seed=seed)
    return args, _sdca_plain(args)


def test_sdca_tile_constants_match_the_kernel():
    src = (ROOT / "src/repro_torch/kernels/csrc/sdca.cu").read_text()
    assert f"constexpr int TILE = {sdca_mod.TILE};" in src
    assert f"constexpr int GROUP = {sdca_mod.GROUP};" in src


def test_sdca_emnist_ideal_has_interior_alphas():
    """The on-card check at the ideal's shape can fail only where alphas end
    strictly inside (0, 1); random normal data at gamma 1/32 leaves none."""
    (K, _, n_real, _, _), alpha = _ideal(0)
    assert K.shape == (1, 2048, 2048) and int(n_real[0]) == 2000
    a = alpha[0, :2000]
    assert int(((a > 0) & (a < 1)).sum()) >= 50
    assert float(alpha[0, 2000:].abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_sdca_tiled_order_holds_the_tolerance_on_the_emnist_ideal(seed):
    args, want = _ideal(seed)
    got = sdca_tiled_emulated(*args)
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["sdca"].tol


@pytest.mark.parametrize("g,b,lo,hi", [(16, 64, 33, 64), (4, 256, 193, 256)],
                         ids=["g16-b64", "g4-b256"])
def test_sdca_tiled_order_holds_the_tolerance_on_group_shapes(g, b, lo, hi):
    """Not bit for bit: the plain version sums each step's dot in fp32, the
    kernel in fp64, so (float)w and the fp32 sum may round apart wherever the
    tile covers the bucket or not; most of these alphas end inside (0, 1)."""
    rng = _rng("sdca-group", b)
    args = ops.make_sdca_problem(rng, g=g, b=b, d=32, n_real=rng.integers(lo, hi + 1, size=g))
    got, want = sdca_tiled_emulated(*args), _sdca_plain(args)
    assert int(((want > 0) & (want < 1)).sum()) > 0
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["sdca"].tol


@pytest.mark.parametrize("seed", [0, 1])
def test_sdca_cluster_order_holds_the_tolerance_on_the_emnist_ideal(seed):
    """The cluster kernel's sums (16 slices of 128 columns at n 2,000) on the
    emnist ideal: within the registry's tol of the plain version and of the
    one-block kernel's order."""
    args, want = _ideal(seed)
    got = sdca_cluster_emulated(*args)
    tol = ops.KERNEL_REGISTRY["sdca"].tol
    assert float((got - want).abs().max()) <= tol
    assert float((got - sdca_tiled_emulated(*args)).abs().max()) <= tol


@pytest.mark.parametrize("g,b,lo,hi", [(16, 64, 33, 64), (4, 256, 193, 256), (3, 320, 130, 301)],
                         ids=["g16-b64", "g4-b256", "g3-b320"])
def test_sdca_cluster_order_holds_the_tolerance_on_group_shapes(g, b, lo, hi):
    """The engine's group shapes, where the ranks past 1 or 2 own no
    column (n <= 256: slices of 128), and a bucket whose last owning rank holds a
    slice of 4 to 45 columns (n 130 to 301)."""
    rng = _rng("sdca-cluster-group", b)
    args = ops.make_sdca_problem(rng, g=g, b=b, d=32, n_real=rng.integers(lo, hi + 1, size=g))
    assert max(-(-int(n) // sdca_mod.slice_cols(int(n))) for n in args[2]) < sdca_mod.CLUSTER
    got, want = sdca_cluster_emulated(*args), _sdca_plain(args)
    assert int(((want > 0) & (want < 1)).sum()) > 0
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["sdca"].tol


# ----------------------------------------------------------------------
# the gram_matvec kernel's plan, constants and order
# ----------------------------------------------------------------------

def test_gram_matvec_constants_match_the_kernel():
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_matvec.cu").read_text()
    # 16 row lanes x 16 support groups of 8 x 4 register tiles
    for line in (f"constexpr int BQ = {gmv.ROWS};", "constexpr int TQ = 8;",
                 "constexpr int TS = 4;", "constexpr int GROUPS = 16;", "constexpr int TILE = GROUPS * TS;",
                 "constexpr int BLOCKS_PER_SM = 2;"):
        assert line in src, line
    assert gmv.TILE == 16 * 4
    # one wave of two resident blocks an SM, as __launch_bounds__ promises
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in src and gmv.TARGET_BLOCKS == 2 * 132
    # the chunked route: one block an SM, warps of 32 x 32, three planes and
    # their six products in the emulation's order, 64-feature steps
    assert "__launch_bounds__(THREADS, 1)\ngram_matvec_chunked(" in src
    assert gmv.CHUNKED_TARGET_BLOCKS == 132
    for line in (f"constexpr int DC = {gmv.CHUNK};", f"constexpr int PLANES = {gmv.PLANES};",
                 f"constexpr int PRODUCTS = {len(GRAM_PRODUCTS)};",
                 f"constexpr int KSTEP = {Q8_KSTEP};",
                 f"constexpr int CWM = {GMV_WARPS[0]}, CWN = {GMV_WARPS[1]};",
                 "constexpr int STAGES = 3;"):
        assert line in src, line
    assert "constexpr int PA[PRODUCTS] = {" + ", ".join(str(i) for i, _ in GRAM_PRODUCTS) + "};" in src
    assert "constexpr int PB[PRODUCTS] = {" + ", ".join(str(j) for _, j in GRAM_PRODUCTS) + "};" in src
    assert "const int a = q == PRODUCTS - 1;  // hi.hi into its own accumulator" in src
    assert "static_cast<double>(acc[1][mt][nt][e] + acc[0][mt][nt][e]);" in src
    # the scratch the wrapper allocates is the launcher's layout
    assert "constexpr int padded_dim(int d) { return (d + DC - 1) / DC * DC; }" in src
    assert "constexpr int padded_rows(int rows) { return (rows + BQ - 1) / BQ * BQ; }" in src
    assert ("int scratch_rows(int m, int n, bool same) "
            "{ return padded_rows(m) + (same ? 0 : padded_rows(n)); }") in src
    assert "__nv_bfloat16* pl2 = same ? pl1 : pl1 + PLANES * ps1;" in src


@pytest.mark.parametrize("m,n,d", [(1, 1, 65), (4096, 4096, 784), (600, 600, 129),
                                   (1000, 777, 300), (130, 4097, 1024)])
def test_gram_matvec_chunked_scratch(m, n, d):
    """``chunked_scratch``: three planes of every operand's rows (x2's
    after x1's unless x2 is x1) rounded up to 128 rows and to 64
    features, one norm a row; at the CG's l 4,096 d 784, 20.4 MB."""
    for same in ((False, True) if m == n else (False,)):
        elems, rows = gmv.chunked_scratch(m, n, d, same)
        want_rows = -(-m // 128) * 128 + (0 if same else -(-n // 128) * 128)
        assert rows == want_rows and rows % gmv.ROWS == 0
        assert elems == 3 * want_rows * (-(-d // 64) * 64)
        # every tile of the split plan reads rows of x2 that the scratch holds
        per_split, splits = gmv.split_plan(m, n, gmv.CHUNKED_TARGET_BLOCKS)
        assert splits * per_split * gmv.TILE >= n and -(-n // gmv.TILE) * gmv.TILE <= (
            rows if same else rows - -(-m // 128) * 128)
    if (m, n, d) == (4096, 4096, 784):
        assert 2 * gmv.chunked_scratch(m, n, d, True)[0] == 20_447_232


@pytest.mark.parametrize("target", [gmv.TARGET_BLOCKS, gmv.CHUNKED_TARGET_BLOCKS])
@pytest.mark.parametrize("m,n", [(1, 1), (48, 40), (77, 131), (4096, 4096), (130, 4097),
                                 (5000, 64), (100, 10_000), (33_000, 200), (4096, 575)])
def test_gram_matvec_split_plan_covers_every_support_once(m, n, target):
    per_split, splits = gmv.split_plan(m, n, target)
    assert splits >= 1 and per_split >= 1
    tiles = -(-n // gmv.TILE)
    # split s takes tiles s * per_split .. min((s + 1) * per_split, tiles) - 1
    owned = [list(range(s * per_split, min((s + 1) * per_split, tiles))) for s in range(splits)]
    assert all(owned)                                   # no empty split
    assert [t for ts in owned for t in ts] == list(range(tiles))
    supports = [j for ts in owned for t in ts
                for j in range(t * gmv.TILE, min((t + 1) * gmv.TILE, n))]
    assert supports == list(range(n))
    # within one wave where the supports allow more than one split, and one
    # tile fewer a split would take more splits than that
    row_blocks = -(-m // gmv.ROWS)
    want = max(1, target // row_blocks)
    assert splits <= want
    assert per_split == 1 or -(-tiles // (per_split - 1)) > want


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf: the fp32 product is exact in fp64, the add rounded to fp32."""
    return (a.double() * b.double() + c.double()).float()


GMV_CHUNK = 64   # features a step of the chunked gram_matvec and scorer kernels stages


def gram_matvec_emulated(x1, x2, v, gamma, row_chunk=512):
    """``csrc/gram_matvec.cu``'s staged kernel in plain PyTorch. Per pair:
    the cross product an fmaf chain over ascending features from 0, each
    norm likewise, d2 = max((sqx + sqs) - 2 cross, 0) in fp32, K =
    exp(-gamma d2) rounded to fp32, then v K exactly in fp64. Sums: the
    thread of group g adds supports 4 g .. 4 g + 3 of each 64-support tile
    in turn, tile after tile of its split; a block adds its 16 groups in
    order; the second pass adds the splits in order."""
    x1, x2, v = (torch.as_tensor(a) for a in (x1, x2, v))
    m, d = x1.shape
    n = x2.shape[0]
    per_split, splits = gmv.split_plan(m, n)
    groups, ts = 16, gmv.TILE // 16
    width = splits * per_split * gmv.TILE
    s = torch.zeros((width, d), dtype=torch.float32)
    s[:n] = x2
    vp = torch.zeros(width, dtype=torch.float64)
    vp[:n] = v.double()

    def norms(a):
        sq = torch.zeros(a.shape[0], dtype=torch.float32)
        for c in range(d):
            sq = _fma32(a[:, c], a[:, c], sq)
        return sq

    sqs = norms(s)
    neg_gamma = torch.tensor(-np.float32(gamma))
    out = torch.empty(m, dtype=torch.float32)
    for lo in range(0, m, row_chunk):
        xr = x1[lo:lo + row_chunk]
        cross = torch.zeros((xr.shape[0], width), dtype=torch.float32)
        for c in range(d):
            cross = _fma32(xr[:, c, None], s[None, :, c], cross)
        d2 = torch.clamp((norms(xr)[:, None] + sqs[None, :]) - 2.0 * cross, min=0.0)
        K = torch.exp((neg_gamma * d2).double()).float()
        # support (split p, tile t, group g, k) at ((p * per_split + t) * 16 + g) * 4 + k
        prod = (vp[None, :] * K.double()).view(-1, splits, per_split, groups, ts)
        acc = torch.zeros(prod.shape[:2] + (groups,), dtype=torch.float64)
        for t in range(per_split):
            for k in range(ts):
                acc = acc + prod[:, :, t, :, k]
        block = torch.zeros(prod.shape[:2], dtype=torch.float64)
        for g in range(groups):
            block = block + acc[:, :, g]
        total = torch.zeros(prod.shape[0], dtype=torch.float64)
        for p in range(splits):
            total = total + block[:, p]
        out[lo:lo + row_chunk] = total.float()
    return out


def gmv_planes(x: torch.Tensor) -> tuple:
    """The chunked route's prologue (``split_planes``): rows of x padded
    with zeros to a multiple of 64 features, split into three bf16 planes
    (hi, mid, lo as fp32 values)."""
    m, d = x.shape
    a = torch.zeros((m, -(-d // GMV_CHUNK) * GMV_CHUNK), dtype=torch.float32)
    a[:, :d] = x
    return q8_planes(a)


def gmv_prologue_norms(x: torch.Tensor) -> torch.Tensor:
    """The prologue's norms, as ``split_planes`` takes them: lane k of a
    row's warp runs the fmaf chain of chunk k0 + k (its real features,
    ascending), and the chunks' sums are added in chunk order in fp64, 32
    chunks a round."""
    m, d = x.shape
    chunks = -(-d // GMV_CHUNK)
    s = torch.zeros(m, dtype=torch.float64)
    for k0 in range(0, chunks, 32):
        for k in range(k0, min(k0 + 32, chunks)):
            part = torch.zeros(m, dtype=torch.float32)
            for c in range(k * GMV_CHUNK, min(k * GMV_CHUNK + GMV_CHUNK, d)):
                part = _fma32(x[:, c], x[:, c], part)
            s = s + part.double()
    return s


def chunked_norms_before(x: torch.Tensor) -> torch.Tensor:
    """The norms of the chunked kernel this route replaced: one fmaf chain
    a 64-feature chunk of the float4-padded dim (the real features), the
    chunks' sums added in fp64."""
    m, d = x.shape
    dp = -(-d // 4) * 4
    s = torch.zeros(m, dtype=torch.float64)
    for c0 in range(0, dp, GMV_CHUNK):
        part = torch.zeros(m, dtype=torch.float32)
        for c in range(c0, min(c0 + GMV_CHUNK, dp)):
            if c < d:
                part = _fma32(x[:, c], x[:, c], part)
        s = s + part.double()
    return s


GMV_WARPS = (4, 2)   # csrc/gram_matvec.cu's CWM, CWN: warps of 32 rows x 32 supports


def gmv_cross(x1, x2, rounding="nearest"):
    """The chunked kernel's cross products, (m, n) fp64: per 64-feature
    step, k step after k step, the six plane products (each 16 exact
    products summed exactly) in GRAM_PRODUCTS' order, the five smaller
    ones into one fp32 accumulator and hi.hi into another, each add
    rounded (to nearest, or toward zero as a tensor core's fp32 adder
    may); the pair added in fp32 (to nearest) and converted, the steps'
    sums added in fp64."""
    pa = [p.double() for p in gmv_planes(torch.as_tensor(x1))]
    pb = [p.double() for p in gmv_planes(torch.as_tensor(x2))]
    m, n, dp = pa[0].shape[0], pb[0].shape[0], pa[0].shape[1]
    cross = torch.zeros((m, n), dtype=torch.float64)
    for c0 in range(0, dp, GMV_CHUNK):
        acc = [torch.zeros((m, n), dtype=torch.float32) for _ in range(2)]
        for k in range(c0, c0 + GMV_CHUNK, Q8_KSTEP):
            for q, (i, j) in enumerate(GRAM_PRODUCTS):
                big = q == len(GRAM_PRODUCTS) - 1
                part = pa[i][:, k:k + Q8_KSTEP] @ pb[j][:, k:k + Q8_KSTEP].T
                acc[big] = _round_fp32(acc[big].double() + part, rounding)
        cross = cross + (acc[1] + acc[0]).double()
    return cross


def gram_matvec_chunked_emulated(x1, x2, v, gamma, rounding="nearest", row_chunk=512):
    """``csrc/gram_matvec.cu``'s chunked route in plain PyTorch: the
    prologue's planes and norms, ``gmv_cross``, d2 = max((sx + sy) - 2
    cross, 0) in fp64, K = exp(-gamma fp32(d2)) rounded to fp32, then v K
    exactly in fp64. Sums (split_plan at CHUNKED_TARGET_BLOCKS): the thread
    (wn, q) of a row adds, tile after tile of its split, its columns 32 wn
    + 8 nt + 2 q + e (nt 0-3, e 0-1) in ascending order; the quad's lanes
    are added ((q0 + q1) + q2) + q3, then the row's two warps in wn order,
    then the splits in order."""
    x1, x2, v = (torch.as_tensor(a) for a in (x1, x2, v))
    m, n = x1.shape[0], x2.shape[0]
    per_split, splits = gmv.split_plan(m, n, gmv.CHUNKED_TARGET_BLOCKS)
    width = splits * per_split * gmv.TILE
    x2p = torch.zeros((width, x2.shape[1]), dtype=torch.float32)
    x2p[:n] = x2
    vp = torch.zeros(width, dtype=torch.float64)
    vp[:n] = v.double()
    sy = gmv_prologue_norms(x2p)
    neg_gamma = torch.tensor(-np.float32(gamma))
    out = torch.empty(m, dtype=torch.float32)
    for lo in range(0, m, row_chunk):
        xr = x1[lo:lo + row_chunk]
        d2 = torch.clamp((gmv_prologue_norms(xr)[:, None] + sy[None, :])
                         - 2.0 * gmv_cross(xr, x2p, rounding), min=0.0)
        K = torch.exp((neg_gamma * d2.float()).double()).float()
        # support (split p, tile t, warp wn, nt, quad lane q, e)
        wn, q = GMV_WARPS[1], 4
        prod = (vp[None, :] * K.double()).view(-1, splits, per_split, wn, 4, q, 2)
        acc = torch.zeros((prod.shape[0], splits, wn, q), dtype=torch.float64)
        for t in range(per_split):
            for nt in range(4):
                for e in range(2):
                    acc = acc + prod[:, :, t, :, nt, :, e]
        quad = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
        block = torch.zeros(prod.shape[:2], dtype=torch.float64)
        for w in range(wn):
            block = block + quad[..., w]
        total = torch.zeros(prod.shape[0], dtype=torch.float64)
        for p in range(splits):
            total = total + block[:, p]
        out[lo:lo + row_chunk] = total.float()
    return out


def _cg_normals(l=4096, d=32):
    """Random normals drawn as chip_smoke.py's "cg l4096 d32" case draws them."""
    rng = _rng("cg-normals")
    xp = rng.normal(size=(l, d)).astype(np.float32)
    v = rng.normal(size=l).astype(np.float32)
    return xp, xp, v, float(1.0 / (d * xp.var()))


@functools.lru_cache(maxsize=None)
def _cg_case(label):
    spec = ops.KERNEL_REGISTRY["gram_matvec"]
    if label == "cg l4096 d32":
        return _cg_normals()
    if label == "cg emnist l4096 d32":
        return ops.make_cg_matvec_problem(seed=0)
    return (spec.make_inputs if label == "registry" else spec.make_ragged)(_rng("gmv-" + label))


GMV_CASES = ["registry", "ragged", "cg l4096 d32", "cg emnist l4096 d32"]


def test_cg_emnist_problem_is_the_rounds_proxy():
    """4,096 distinct validation-pool rows at default_gamma: gamma |x|^2 ~ 1."""
    x1, x2, v, gamma = _cg_case("cg emnist l4096 d32")
    assert x1 is x2 and x1.shape == (4096, 32) and v.shape == (4096,)
    assert len(np.unique(x1, axis=0)) == 4096
    assert 0.5 < gamma * float((x1.astype(np.float64) ** 2).sum(1).mean()) < 2.0


@pytest.mark.parametrize("label", GMV_CASES, ids=[c.replace(" ", "-") for c in GMV_CASES])
def test_gram_matvec_order_holds_the_tolerance(label):
    x1, x2, v, gamma = _cg_case(label)
    got = gram_matvec_emulated(x1, x2, v, gamma)
    want = gmv.gram_matvec_plain(*(torch.from_numpy(a) for a in (x1, x2, v)), gamma)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["gram_matvec"].tol


# ----------------------------------------------------------------------
# the rbf_gram_q8 kernel's planes, plan, constants and arithmetic
# ----------------------------------------------------------------------

Q8_KSTEP, Q8_PLANES = 16, 3   # features per mma, bf16 planes of x * scale
Q8_STAGES = 5                 # the chunked kernel's ring of slabs
Q8_PRO_ROWS, Q8_PRO_CH = 16, 128   # rows a prologue block, features it stages at a time


def q8_planes(xs: torch.Tensor) -> tuple:
    """x * scale as the kernel splits it: hi = bf16(xs), mid = bf16(xs -
    hi), lo = bf16(xs - hi - mid), each difference exact in fp32."""
    hi = xs.bfloat16().float()
    r1 = xs - hi
    mid = r1.bfloat16().float()
    return hi, mid, (r1 - mid).bfloat16().float()


def _round_fp32(v: torch.Tensor, rounding: str) -> torch.Tensor:
    """fp64 -> fp32, to nearest or toward zero (the worst a tensor core's
    fp32 adder does)."""
    f = v.float()
    if rounding == "truncate":
        f = torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)
    return f


Q8_CHUNK = 128   # features a chunk of the chunked gram_q8 kernel staged before (8 k steps)


def q8_terms(x, q, scale, zero, chunks):
    """What ``rbf_gram_q8_split_emulated`` multiplies and adds: the three
    planes of x * scale and q, each (rows, kp) with the feature dim padded
    with zeros to a multiple of 16 (fp32 values), and |x|^2, x . zero (fmaf
    chains over ascending features) and |s|^2 (an fmaf chain over each half
    of the padded range of s = q * scale + zero, walked in ``chunks``, then
    the halves added)."""
    m, d = x.shape
    n = q.shape[0]
    kp = -(-d // Q8_KSTEP) * Q8_KSTEP
    xs = torch.zeros((m, kp), dtype=torch.float32)
    xs[:, :d] = x * scale
    qf = torch.zeros((n, kp), dtype=torch.float32)
    qf[:, :d] = q.float()
    s = q8.dequantize(q, scale, zero)
    halves = [torch.zeros(n, dtype=torch.float32) for _ in range(2)]
    for cs in chunks:
        for c in cs:
            if c < d:
                h = int(c >= kp // 2)
                halves[h] = _fma32(s[:, c], s[:, c], halves[h])
    sqx = torch.zeros(m, dtype=torch.float32)
    xz = torch.zeros(m, dtype=torch.float32)
    for c in range(d):
        sqx = _fma32(x[:, c], x[:, c], sqx)
        xz = _fma32(x[:, c], zero[c].expand(m), xz)
    return list(q8_planes(xs)), qf, sqx, xz, halves[0] + halves[1]


def rbf_gram_q8_split_emulated(x, q, scale, zero, gamma, rounding="nearest", row_chunk=512,
                               chunk=None):
    """``csrc/gram_q8.cu`` in plain PyTorch. The feature dim is padded with
    zeros to a multiple of 16. Per k step of 16 features, the hi, mid and
    lo planes of x * scale each meet q in one mma: 16 exact products (a
    bf16 times an int8 needs 16 bits) summed exactly, added to the fp32
    accumulator and rounded. Then cross = acc + x . zero; |x|^2 and
    x . zero are fmaf chains over ascending features, |s|^2 two fmaf chains
    over the halves of the padded range, added; d2 = max((|x|^2 + |s|^2) -
    2 cross, 0) in fp32 and exp(-gamma d2) (the kernel's ex2.approx is
    within ~2^-22 of it). With ``chunk`` (Q8_CHUNK), the chunked kernel's
    order: the k steps chunk after chunk into the same accumulator, each
    half's norm chain carried across the chunks."""
    x, q, scale, zero = (torch.as_tensor(a) for a in (x, q, scale, zero))
    m, d = x.shape
    n = q.shape[0]
    kp = -(-d // Q8_KSTEP) * Q8_KSTEP
    chunks = [range(0, kp)] if chunk is None else [
        range(c0, min(c0 + chunk, kp)) for c0 in range(0, kp, chunk)]
    planes, qd, sqx, xz, sqs = q8_terms(x, q, scale, zero, chunks)
    planes = [p.double() for p in planes]
    qd = qd.double()

    out = torch.empty((m, n), dtype=torch.float32)
    for lo in range(0, m, row_chunk):
        rows = slice(lo, lo + row_chunk)
        acc = torch.zeros((len(planes[0][rows]), n), dtype=torch.float32)
        for cs in chunks:
            for k in range(cs.start, cs.stop, Q8_KSTEP):
                qk = qd[:, k:k + Q8_KSTEP].T
                for plane in planes:
                    acc = _round_fp32(acc.double() + plane[rows, k:k + Q8_KSTEP] @ qk, rounding)
        cross = acc + xz[rows, None]
        d2 = torch.clamp((sqx[rows, None] + sqs[None, :]) - 2.0 * cross, min=0.0)
        out[rows] = torch.exp(-float(gamma) * d2.double()).float()
    return out


@functools.lru_cache(maxsize=None)
def _q8_student():
    return ops.make_q8_student_problem(seed=0)


@functools.lru_cache(maxsize=None)
def _q8_case(label):
    from repro_torch.comm.wire import _quantize_columns

    spec = ops.KERNEL_REGISTRY["rbf_gram_q8"]
    if label == "normal":   # as chip_smoke.py's gram_q8 cases draw them, at 1,024 x 1,024
        rng = _rng("q8-normal")
        x = rng.normal(size=(1024, 32)).astype(np.float32)
        q, scale, zero = _quantize_columns(rng.normal(size=(1024, 32)).astype(np.float32))
        return x, q, scale, zero, 1.0 / 32
    if label == "student 2048":
        x, q, scale, zero, gamma = _q8_student()
        return x[:2048], q, scale, zero, gamma
    return (spec.make_inputs if label == "registry" else spec.make_ragged)(_rng("q8-" + label))


Q8_CASES = ["registry", "ragged", "normal", "student 2048"]


def test_q8_student_problem_is_the_rounds_input():
    """The CG problem's 4,096 proxy rows as the int8 codec sends them, at
    their default_gamma, against the first 8,192 pooled test rows."""
    from repro_torch.comm.wire import decode, encode
    from repro_torch.core.svm import SVMModel

    x, q, scale, zero, gamma = _q8_student()
    xp, _, _, cg_gamma = _cg_case("cg emnist l4096 d32")
    assert x.shape == (8192, 32) and x.dtype == np.float32
    assert q.shape == (4096, 32) and q.dtype == np.int8
    assert scale.shape == zero.shape == (32,) and gamma == cg_gamma
    student = SVMModel(support_x=xp, coef=np.ones(len(xp), np.float32), gamma=gamma,
                       device="cpu")
    sent = decode(encode(student, "int8"), device="cpu")
    assert np.array_equal(sent.q, q) and sent.gamma == gamma
    assert np.array_equal(sent.scale, scale) and np.array_equal(sent.zero, zero)
    devices = ops._emnist_devices(0, 0.15)
    pooled = np.concatenate([dev.splits["test"].x for dev in devices])
    assert len(pooled) > 8192 and np.array_equal(x, pooled[:8192])


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("label", Q8_CASES, ids=[c.replace(" ", "-") for c in Q8_CASES])
def test_rbf_gram_q8_split_holds_the_tolerance(label, rounding):
    x, q, scale, zero, gamma = _q8_case(label)
    got = rbf_gram_q8_split_emulated(x, q, scale, zero, gamma, rounding)
    want = q8.rbf_gram_q8_plain(*(torch.from_numpy(a) for a in (x, q, scale, zero)), gamma)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["rbf_gram_q8"].tol


def test_int8_values_are_exact_in_bf16():
    v = torch.arange(-127, 128, dtype=torch.int8)
    assert len(v) == 255
    assert torch.equal(v.float().bfloat16().float(), v.float())
    assert torch.equal(v.to(torch.bfloat16).to(torch.int8), v)


def test_three_planes_carry_x_scale_to_fp32():
    x, q, scale, zero, gamma = _q8_student()
    rng = _rng("q8-planes")
    wide = (rng.normal(size=4096) * 2.0 ** rng.integers(-60, 60, size=4096)).astype(np.float32)
    for xs in (torch.from_numpy(x) * torch.from_numpy(scale), torch.from_numpy(wide)):
        hi, mid, lo = q8_planes(xs)
        err = ((hi.double() + mid.double() + lo.double()) - xs.double()).abs()
        assert bool((err <= 2.0 ** -24 * xs.double().abs()).all())
        # each difference the kernel takes is exact in fp32
        assert torch.equal((xs - hi).double(), xs.double() - hi.double())


def test_gram_q8_constants_match_the_kernel():
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_q8.cu").read_text()
    for line in (f"constexpr int BM = {q8.ROWS};", f"constexpr int BN = {q8.TILE};",
                 "constexpr int THREADS = 256;", "constexpr int WM = 32;",
                 "constexpr int WN = 32;", "constexpr int BLOCKS_PER_SM = 3;",
                 f"constexpr int PLANES = {Q8_PLANES};",
                 f"constexpr int KSTEP = {Q8_KSTEP};",
                 f"constexpr int MAX_KSTEPS = {q8.STAGED_D // Q8_KSTEP};"):
        assert line in src, line
    # hi, mid, lo into one accumulator, k step after k step: one k step
    # (mma_kstep) runs the three planes, and the staged kernel calls it k
    # step by k step
    step = src[src.index("void mma_kstep("):src.index("void store_tile(")]
    assert "for (int p = 0; p < PLANES; ++p)" in step
    assert "for (int ks = 0; ks < KSTEPS; ++ks) mma_kstep(acc, Xp, Bt, LD, ks, wm, wn, lane);" in src
    # one wave of three resident blocks an SM, as __launch_bounds__ promises
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in src and q8.TARGET_BLOCKS == 3 * 132


def test_gram_q8_chunked_constants_match_the_kernel():
    """The chunked route: 128 x 256 tiles of two warpgroups of m64n256k16
    and a copy warp, slabs of 32 features in a ring of Q8_STAGES TMA slots,
    one block an SM; each slab's k steps ascending, each k step's three
    planes hi, mid, lo into the same accumulators (the staged kernel's
    order), none past the padded feature dim; the boxes' 64-byte swizzle is
    the one the wgmma descriptors name."""
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_q8.cu").read_text()
    for line in (f"constexpr int CBM = {q8.CHUNKED_ROWS};", f"constexpr int CBN = {q8.CHUNKED_TILE};",
                 "constexpr int WG_ROWS = 64;", f"constexpr int SLAB = {q8.SLAB};",
                 f"constexpr int STAGES = {Q8_STAGES};",
                 "constexpr int CTHREADS = THREADS + 32;",
                 "constexpr int SROWS = PLANES * CBM + CBN;",
                 "constexpr int SROW_BYTES = 2 * SLAB;",
                 f"constexpr int PRO_ROWS = {Q8_PRO_ROWS};",
                 f"constexpr int PRO_CH = {Q8_PRO_CH};"):
        assert line in src, line
    assert q8.PLANES == Q8_PLANES
    assert "__launch_bounds__(CTHREADS, 1)\ngram_q8_chunked_kernel(" in src
    assert q8.CHUNKED_TARGET_BLOCKS == 132
    kernel = src[src.index("gram_q8_chunked_kernel(const"):src.index("template <int KSTEPS>\nint launch(")]
    assert ("    for (int ks = 0; ks < SLAB / KSTEP; ++ks)\n      if (ks < ksteps) {" in kernel)
    assert "for (int p = 0; p < PLANES; ++p)\n          wgmma_m64n256k16(" in kernel
    assert "const int ksteps = min(SLAB / KSTEP, (kp - k * SLAB) / KSTEP);" in kernel
    # the slab's boxes: the three planes' rows of the stripe, then the tile's q
    assert "tensor_load(dst + p * CBM * SROW_BYTES, &xmap, k0, p * mp + row0, bar);" in kernel
    assert "tensor_load(dst + PLANES * CBM * SROW_BYTES, &qmap, k0, (t0 + t) * CBN, bar);" in kernel
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in src and "((uint64_t)(8 * 64 >> 4) << 32) | ((uint64_t)2 << 62);" in src
    # the prologue's chains: |x|^2 and x.zero over ascending features, |s|^2
    # over the halves of padded_k(d), added
    pro = src[src.index("q8_prologue(const"):src.index("gram_q8_chunked_kernel(const")]
    assert "for (int f = c0; f < end; ++f) chain = fmaf(sr[f], h ? __ldg(zero + f) : sr[f], chain);" in pro
    assert "const int half = padded_k(d) / 2, lo = h * half, hi = min(d, lo + half);" in pro
    assert "const float sv = __fadd_rn(__fmul_rn(sr[f], __ldg(scale + f)), __ldg(zero + f));" in pro
    assert "if (h == 0) sqs[row0 + cr] = __fadd_rn(chain, other);" in pro
    assert "split3_values(c + j < d ? __fmul_rn(v[j], __ldg(scale + c + j)) : 0.f, hs[j]);" in pro


def test_gram_q8_ring_schedule():
    """The chunked kernel's mbarrier ring, step by step as the source runs
    it: the copy warp fills step s into slot s % STAGES once that slot's
    empty mbarrier has completed its use s / STAGES - 1 (two arrives, one a
    warpgroup); a warpgroup waits for the slot's full mbarrier, issues the
    step's products, and after wgmma.wait_group 1 frees the slot of the step
    before (or, at a tile's last slab, wait_group 0 and its own slot). So
    every use of a slot is freed exactly once, only after the products that
    read it are done, and the copy warp is never more than STAGES steps
    ahead, nor waits on a step the warpgroups have not reached."""
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_q8.cu").read_text()
    kernel = src[src.index("gram_q8_chunked_kernel(const"):src.index("template <int KSTEPS>\nint launch(")]
    for line in ("mbar_init(empty + 8 * i, 2);  // one arrive a wgmma warpgroup",
                 "if (use > 0) mbar_wait(empty + 8 * slot, (use - 1) & 1);",
                 "mbar_wait(full + 8 * slot, (s / STAGES) & 1);",
                 "wgmma_wait<1>();",
                 "if (pending >= 0 && releaser) mbar_arrive(empty + 8 * (pending % STAGES));",
                 "wgmma_wait<0>();",
                 "if (releaser) mbar_arrive(empty + 8 * slot);"):
        assert line in kernel, line
    for slabs, tiles in ((1, 1), (1, 5), (2, 3), (7, 2), (25, 8), (4, 1)):
        steps = slabs * tiles
        freed, done = [], -1   # (step freed, consumer step at which) ; products done up to
        pending, k = -1, 0
        for s in range(steps):
            # the copy warp issued step s only after step s - STAGES was freed
            if s >= Q8_STAGES:
                assert s - Q8_STAGES in [f for f, _ in freed]
            done = s - 1   # wait_group 1 after step s's products are issued
            if pending >= 0:
                assert pending <= done
                freed.append((pending, s))
            pending = s
            k += 1
            if k == slabs:
                done = s   # wait_group 0
                freed.append((s, s))
                pending, k = -1, 0
        assert sorted(f for f, _ in freed) == list(range(steps))   # each step's slot once
        # step s - STAGES is freed by consumer step s - STAGES + 1 <= s - 1:
        # the copy warp can fill step s before the warpgroups wait for it
        assert all(at <= f + 1 for f, at in freed)


@pytest.mark.parametrize("m,n", [(1, 1), (48, 40), (130, 67), (8192, 4096), (1000, 4096),
                                 (8192, 4097), (100, 10_000), (40_000, 200)])
def test_gram_q8_split_plan_covers_every_support_once(m, n):
    per_split, splits = q8.split_plan(m, n)
    tiles = -(-n // q8.TILE)
    owned = [list(range(s * per_split, min((s + 1) * per_split, tiles))) for s in range(splits)]
    assert all(owned) and [t for ts in owned for t in ts] == list(range(tiles))
    stripes = -(-m // q8.ROWS)
    want = max(1, q8.TARGET_BLOCKS // stripes)
    assert splits <= want
    assert per_split == 1 or -(-tiles // (per_split - 1)) > want



@pytest.mark.parametrize("n", [1, 4096, 12_352])
@pytest.mark.parametrize("m", [1, 600, 8192])
def test_gram_q8_chunked_plan_covers_every_support_once_in_one_wave(m, n):
    per_split, splits = q8.plan(m, n, chunked=True)
    tiles = -(-n // q8.CHUNKED_TILE)
    owned = [list(range(s * per_split, min((s + 1) * per_split, tiles))) for s in range(splits)]
    assert all(owned) and [t for ts in owned for t in ts] == list(range(tiles))
    supports = [j for ts in owned for t in ts
                for j in range(t * q8.CHUNKED_TILE, min((t + 1) * q8.CHUNKED_TILE, n))]
    assert supports == list(range(n))
    stripes = -(-m // q8.CHUNKED_ROWS)
    assert stripes * splits <= q8.CHUNKED_TARGET_BLOCKS   # one wave of one block an SM
    assert per_split == 1 or -(-tiles // (per_split - 1)) > q8.CHUNKED_TARGET_BLOCKS // stripes
    assert q8.plan(m, n, chunked=False) == q8.split_plan(m, n)


@pytest.mark.parametrize("m,n,d", [(1, 1, 129), (8192, 4096, 784), (300, 260, 1024),
                                   (1000, 4097, 200), (130, 257, 1)])
def test_gram_q8_chunked_scratch(m, n, d):
    """``chunked_scratch`` is the launcher's layout: the planes of m rows
    rounded up to 128 and q's image of n rounded up to 256, d rounded up to
    32 features, then 2 floats a row and 1 a support; 45.9 MB of bf16 at
    the student's 8,192 x 4,096 x 784."""
    src = (ROOT / "src/repro_torch/kernels/csrc/gram_q8.cu").read_text()
    for line in ("constexpr int slab_dim(int d) { return (d + SLAB - 1) / SLAB * SLAB; }",
                 "constexpr int padded_rows(int m) { return (m + CBM - 1) / CBM * CBM; }",
                 "constexpr int padded_supports(int n) { return (n + CBN - 1) / CBN * CBN; }",
                 "  __nv_bfloat16* qb = xp + PLANES * plane;",
                 "  float* xz = sqx + mp;", "  float* sqs = xz + mp;"):
        assert line in src, line
    rows, supports, ldk = -(-m // 128) * 128, -(-n // 256) * 256, -(-d // 32) * 32
    assert q8.chunked_scratch(m, n, d) == ((3 * rows + supports) * ldk, 2 * rows + supports)
    if (m, n, d) == (8192, 4096, 784):
        assert 2 * q8.chunked_scratch(m, n, d)[0] == 45_875_200


def q8_prologue_emulated(x, q, scale, zero):
    """``q8_prologue`` in plain PyTorch, in its scratch layout: the planes
    of fl(x * scale) split as split3 does and q's bf16 image, rows padded
    to CHUNKED_ROWS / CHUNKED_TILE with zeros and features to SLAB; |x|^2
    and x . zero a chain thread each, |s|^2 two chain threads over the
    halves of padded_k(d), their sums added; the chains walk the features
    PRO_CH at a time from the staged rows, which keeps each chain's order."""
    x, q, scale, zero = (torch.as_tensor(a) for a in (x, q, scale, zero))
    m, d = x.shape
    n = q.shape[0]
    (elems, floats), ldk = q8.chunked_scratch(m, n, d), -(-d // q8.SLAB) * q8.SLAB
    mp, np_ = -(-m // q8.CHUNKED_ROWS) * q8.CHUNKED_ROWS, -(-n // q8.CHUNKED_TILE) * q8.CHUNKED_TILE
    xs = torch.zeros((mp, ldk), dtype=torch.float32)
    xs[:m, :d] = x * scale
    qf = torch.zeros((np_, ldk), dtype=torch.float32)
    qf[:n, :d] = q.float()
    planes = torch.cat([p.bfloat16().reshape(-1) for p in q8_planes(xs)] + [qf.bfloat16().reshape(-1)])
    assert planes.numel() == elems
    half, kp = -(-d // Q8_KSTEP) * Q8_KSTEP // 2, -(-d // Q8_KSTEP) * Q8_KSTEP
    sqx, xz, chains = (torch.zeros(mp), torch.zeros(mp), [torch.zeros(np_), torch.zeros(np_)])
    s = torch.zeros((np_, d))
    s[:n] = q8.dequantize(q, scale, zero)
    for c0 in range(0, ldk, Q8_PRO_CH):
        for f in range(c0, min(c0 + Q8_PRO_CH, d)):
            sqx[:m] = _fma32(x[:, f], x[:, f], sqx[:m])
            xz[:m] = _fma32(x[:, f], zero[f].expand(m), xz[:m])
        for h, (lo, hi) in enumerate(((0, min(d, half)), (half, min(d, kp)))):
            for f in range(max(c0, lo), min(c0 + Q8_PRO_CH, hi)):
                chains[h][:n] = _fma32(s[:n, f], s[:n, f], chains[h][:n])
    norms = torch.cat([sqx, xz, chains[0] + chains[1]])
    assert norms.numel() == floats
    return planes, norms


@pytest.mark.parametrize("label", ["student 2048", "wide 129", "wide 784", "ragged"])
def test_gram_q8_prologue_is_the_emulated_order(label):
    """The prologue's planes, q's image and norms are bitwise what
    ``rbf_gram_q8_split_emulated(..., chunk=Q8_CHUNK)`` multiplies and adds
    (its ``q8_terms``), zeros in the padding; so the chunked route's
    products and epilogue see the staged kernel's operands."""
    from repro_torch.comm.wire import _quantize_columns

    if label.startswith("wide"):
        d = int(label.split()[1])
        x, sup = _wide_rows(d, rows=300)
        q, scale, zero = _quantize_columns(sup[:260])
    else:
        x, q, scale, zero, _ = _q8_case(label)
    x, q, scale, zero = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, q, scale, zero))
    m, d = x.shape
    n = q.shape[0]
    kp = -(-d // Q8_KSTEP) * Q8_KSTEP
    planes, norms = q8_prologue_emulated(x, q, scale, zero)
    want_planes, want_q, sqx, xz, sqs = q8_terms(
        x, q, scale, zero, [range(c0, min(c0 + Q8_CHUNK, kp)) for c0 in range(0, kp, Q8_CHUNK)])
    ldk, mp = -(-d // q8.SLAB) * q8.SLAB, -(-m // q8.CHUNKED_ROWS) * q8.CHUNKED_ROWS
    np_ = -(-n // q8.CHUNKED_TILE) * q8.CHUNKED_TILE
    got = planes.float().split([mp * ldk] * 3 + [np_ * ldk])
    for plane, want in zip(got[:3], want_planes):
        plane = plane.view(mp, ldk)
        assert torch.equal(plane[:m, :kp], want) and not plane[m:].any() and not plane[:, kp:].any()
    qimg = got[3].view(np_, ldk)
    assert torch.equal(qimg[:n, :kp], want_q) and not qimg[n:].any() and not qimg[:, kp:].any()
    got_sqx, got_xz, got_sqs = norms.split([mp, mp, np_])
    for g, w, rows in ((got_sqx, sqx, m), (got_xz, xz, m), (got_sqs, sqs, n)):
        assert torch.equal(g[:rows], w) and not g[rows:].any()


# ----------------------------------------------------------------------
# the fp32 RBF Gram kernel's planes, plan, constants and arithmetic
# ----------------------------------------------------------------------

GRAM_PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))  # (a plane, b plane), 0 = hi


def gram_norms(x: torch.Tensor, staged: int) -> torch.Tensor:
    """|x|^2 of each row as the kernel takes it: for each chunk of `staged`
    features, four fmaf chains over its quarters (ascending features, the
    real ones), added as (q0 + q1) + (q2 + q3); chunk sums added in order."""
    d = x.shape[-1]
    qw = staged // 4
    total = None
    for k0 in range(0, d, staged):
        quarters = []
        for h in range(4):
            q = torch.zeros(x.shape[:-1], dtype=torch.float32)
            for c in range(k0 + h * qw, min(k0 + (h + 1) * qw, d)):
                q = _fma32(x[..., c], x[..., c], q)
            quarters.append(q)
        chunk = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
        total = chunk if total is None else total + chunk
    return total


def rbf_gram_split_emulated(x1, x2, gammas, rounding="nearest"):
    """``csrc/gram.cu`` in plain PyTorch, for x1 (g, m, d), x2 (g, n, d),
    gammas (g,). Both operands are padded with zeros to a multiple of 16
    features and split into three bf16 planes; per k step of 16 features
    the six products (lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi), each
    16 exact products summed exactly, are added to one fp32 accumulator and
    rounded (to nearest, or toward zero). The norms are ``gram_norms``;
    d2 = max((|a|^2 + |b|^2) - 2 a.b, 0) in fp32 and exp(-gamma d2) (the
    kernel's ex2.approx is within ~2^-22 of it)."""
    x1, x2, gammas = (torch.as_tensor(a) for a in (x1, x2, gammas))
    g, m, d = x1.shape
    n = x2.shape[1]
    staged = bg.tile_plan(m, n, d)[2]
    kp = -(-d // Q8_KSTEP) * Q8_KSTEP
    a = torch.zeros((g, m, kp), dtype=torch.float32)
    b = torch.zeros((g, n, kp), dtype=torch.float32)
    a[..., :d], b[..., :d] = x1, x2
    pa = [p.double() for p in q8_planes(a)]
    pb = [p.double() for p in q8_planes(b)]
    acc = torch.zeros((g, m, n), dtype=torch.float32)
    for k in range(0, kp, Q8_KSTEP):
        for i, j in GRAM_PRODUCTS:
            part = pa[i][..., k:k + Q8_KSTEP] @ pb[j][..., k:k + Q8_KSTEP].transpose(1, 2)
            acc = _round_fp32(acc.double() + part, rounding)
    s = gram_norms(x1, staged)[:, :, None] + gram_norms(x2, staged)[:, None, :]
    d2 = torch.clamp(s - 2.0 * acc, min=0.0)
    return torch.exp(-gammas.double()[:, None, None] * d2.double()).float()


@functools.lru_cache(maxsize=None)
def _emnist_full():
    from repro_torch.data import make_dataset

    return make_dataset("emnist", seed=0, scale=1.0)


@functools.lru_cache(maxsize=None)
def _fit_group():
    return ops.make_fit_group_problem(seed=0)


@functools.lru_cache(maxsize=None)
def _gram_case(label):
    spec = ops.KERNEL_REGISTRY["batched_rbf_gram"]
    if label == "fit emnist g256 b64":
        return _fit_group()
    if label == "ideal 2000":
        from repro_torch.core.svm import default_gamma

        x, _ = ops.ideal_rows(seed=0)
        return x[None], x[None], np.asarray([default_gamma(x)], np.float32)
    if label == "normal fit g32 b64":   # as chip_smoke.py's fit cases draw them
        rng = _rng("gram-normal")
        x = rng.normal(size=(32, 64, 32)).astype(np.float32)
        return x, x, (1.0 / (32 * rng.uniform(0.5, 2.0, size=32))).astype(np.float32)
    return (spec.make_inputs if label == "registry" else spec.make_ragged)(_rng("gram-" + label))


GRAM_CASES = ["registry", "ragged", "normal fit g32 b64", "fit emnist g256 b64", "ideal 2000"]


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("label", GRAM_CASES, ids=[c.replace(" ", "-") for c in GRAM_CASES])
def test_rbf_gram_split_holds_the_tolerance(label, rounding):
    x1, x2, gammas = _gram_case(label)
    got = rbf_gram_split_emulated(x1, x2, gammas, rounding)
    want = bg.batched_rbf_gram_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                       for a in (x1, x2, gammas)))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ops.KERNEL_REGISTRY["batched_rbf_gram"].tol


def test_fit_group_problem_is_the_rounds_input(monkeypatch):
    """The first ``batched_rbf_gram`` call of the bucketed round (the first
    bucket-64 group's fit) gets exactly ``make_fit_group_problem``'s
    arrays: 256 devices' train rows zero-padded to 64, x2 the same tensor
    as x1, each device at its default_gamma."""
    from repro_torch.sim import engine

    class Captured(Exception):
        pass

    seen = {}

    def capture(x1, x2, gammas):
        seen["args"] = (x1, x2, gammas)
        raise Captured

    monkeypatch.setattr(engine.kops, "batched_rbf_gram", capture)
    with pytest.raises(Captured):
        for _ in engine.iter_population(_emnist_full(), device="cpu"):
            pass
    x1, x2, gammas = seen["args"]
    xp, xp2, want_gammas = _fit_group()
    assert xp2 is xp and x2 is x1
    assert xp.shape == (256, 64, 32) and np.array_equal(x1.numpy(), xp)
    assert np.array_equal(gammas.numpy(), want_gammas)
    padded = (xp == 0).all(-1)
    assert padded.any() and (~padded).any()   # the padding contract is exercised


# the round's Gram launches (ISSUE table: groups x (g, bucket, val q, test q), d 32)
ROUND_GROUPS = [(7, 256, 64, 16, 56), (1, 128, 64, 16, 56), (3, 256, 128, 32, 104),
                (1, 256, 192, 40, 160), (1, 128, 256, 48, 184)]


def _round_shapes():
    return [(kind, g, m, n, 32) for count, g, b, qv, qt in ROUND_GROUPS for _ in range(count)
            for kind, m, n in (("fit", b, b), ("val", qv, b), ("test", qt, b))]


def test_round_gram_launches_are_the_rounds():
    """``ops.round_gram_launches`` on the full-scale emnist federation: 39
    launches at 15 distinct shapes, a fit and two scores per group."""
    launches = ops.round_gram_launches(_emnist_full())
    assert sorted(launches) == sorted(_round_shapes())
    assert len(launches) == 39 and len({sh[1:] for sh in launches}) == 15


def _covered(g, m, n, d):
    """How often the kernel's grid writes each output: tiles of the plan's
    rows x cols, rows past m and columns past n never stored."""
    rows, cols, _ = bg.tile_plan(m, n, d)
    hits = np.zeros((g, m, n), np.int64)
    for t in range(g):
        for r0 in range(0, -(-m // rows) * rows, rows):
            for c0 in range(0, -(-n // cols) * cols, cols):
                hits[t, r0:r0 + rows, c0:c0 + cols] += 1
    return hits


GRAM_PLAN_SHAPES = sorted({sh[1:] for sh in _round_shapes()}) + [
    (3, 77, 45, 24), (4, 48, 40, 12), (1, 130, 67, 37), (1, 2000, 2000, 32), (1, 1, 1, 1),
    (5, 41, 71, 140), (1, 133, 70, 150), (1, 17, 200, 61)]


@pytest.mark.parametrize("g,m,n,d", GRAM_PLAN_SHAPES)
def test_gram_tile_plan_covers_every_output_once(g, m, n, d):
    assert int(_covered(min(g, 2), m, n, d).min()) == 1
    assert int(_covered(min(g, 2), m, n, d).max()) == 1


def test_gram_tile_plan_wastes_at_most_a_fifth_at_the_rounds_shapes():
    assert list(inspect.signature(bg.tile_plan).parameters) == ["m", "n", "d"]
    for _, g, m, n, d in _round_shapes():
        rows, cols, staged = bg.tile_plan(m, n, d)
        computed_rows, computed_cols = -(-m // rows) * rows, -(-n // cols) * cols
        assert computed_rows - m <= computed_rows / 5, (m, rows)
        assert computed_cols - n <= computed_cols / 5, (n, cols)
        assert staged == 32
    # a val batch of 16 queries against 64 supports is one 16 x 64 tile
    assert bg.tile_plan(16, 64, 32)[:2] == (16, 64)


def _gram_smem_bytes(rows, staged):
    """Shared memory of one block (gram.cu's Tile::BYTES)."""
    staged_rows = rows + bg.COLS
    return 4 * staged_rows * (staged + 4) + 2 * 3 * staged_rows * (staged + 8) + 4 * staged_rows


def test_gram_constants_match_the_kernel():
    src = (ROOT / "src/repro_torch/kernels/csrc/gram.cu").read_text()
    for line in (f"constexpr int BN = {bg.COLS};", "constexpr int WN = 32;",
                 f"constexpr int PLANES = {Q8_PLANES};", f"constexpr int PRODUCTS = {len(GRAM_PRODUCTS)};",
                 f"constexpr int KSTEP = {Q8_KSTEP};",
                 f"constexpr int MAX_KSTEPS = {bg.STAGED[-1] // Q8_KSTEP};",
                 "constexpr int QUARTERS = 4;"):
        assert line in src, line
    # the products in the emulation's order
    assert "constexpr int PA[PRODUCTS] = {" + ", ".join(str(i) for i, _ in GRAM_PRODUCTS) + "};" in src
    assert "constexpr int PB[PRODUCTS] = {" + ", ".join(str(j) for _, j in GRAM_PRODUCTS) + "};" in src
    assert src.index("for (int ks = 0; ks < KSTEPS; ++ks)") < src.index(
        "for (int q = 0; q < PRODUCTS; ++q)")
    # every tile height and staged width the plan picks has a launch
    for rows in bg.ROW_TILES:
        assert f"case {rows}: return launch_staged<{rows}>" in src
    for staged in bg.STAGED:
        assert f"case {staged}: return launch<BM, " in src
    # each instantiation fits an SM's shared memory
    for rows in bg.ROW_TILES:
        for staged in bg.STAGED:
            assert _gram_smem_bytes(rows, staged) + 1024 <= 232448


# ----------------------------------------------------------------------
# the wide paths: where each launcher leaves its staged kernel, and the
# chunked orders at d 784
# ----------------------------------------------------------------------

MAX_SMEM = 232448   # shared memory a block may take on sm_90 (native.MAX_SMEM_BYTES)


def _row_stride(d):
    """ensemble_score.cu's and gram_matvec.cu's row_stride: d padded to a
    float4, then to an odd number of float4s."""
    dp = -(-d // 4) * 4
    return dp if (dp // 4) % 2 else dp + 4


def ens_smem_bytes(d):
    """ensemble_score.cu's smem_bytes: the staged partials kernel."""
    bq, en, warps, red_ld, fast_d = 128, ens.SUPPORT_TILE, 8, 17, 32
    support = max(2 * en * _row_stride(d), bq * red_ld)
    raw = 2 * warps * (8 * fast_d + 2 * fast_d * 4) if d == fast_d else 0
    return 4 * (bq * _row_stride(d) + support + 4 * en) + raw


ENS_STAGES = 3             # ensemble_score.cu's STAGES: the chunked kernel's ring
ENS_PAIR = 2 * ens.SUPPORT_TILE   # its PAIR: two items a step
ENS_RAW_STEP = ENS_PAIR * GMV_CHUNK + 2 * 2 * GMV_CHUNK * 4   # its RAW_STEP (int8 bytes)
ENS_CHUNKED_BYTES = 4 * (ENS_STAGES * (128 + ENS_PAIR) * (GMV_CHUNK + 4) + 128)
ENS_Q8_CHUNKED_BYTES = (4 * (ENS_STAGES * 128 * (GMV_CHUNK + 4) + 2 * ENS_PAIR * (GMV_CHUNK + 4)
                             + 128) + ENS_STAGES * ENS_RAW_STEP)


def gmv_smem_bytes(d):
    """gram_matvec.cu's smem_bytes: the staged kernel."""
    bq, tile, red_ld = gmv.ROWS, gmv.TILE, 17
    support = max(2 * tile * _row_stride(d), 2 * bq * red_ld)
    return 4 * (bq * _row_stride(d) + support + 4 * tile) + 8 * 2 * tile


GMV_CHUNKED_BYTES = 2 * 3 * 3 * (128 + 64) * GMV_CHUNK   # a ring of 3 steps: 3 bf16 planes of 192 rows


def q8_staged_bytes(ksteps):
    """gram_q8.cu's Layout<KSTEPS>::BYTES."""
    kp = ksteps * Q8_KSTEP
    ld = kp + 8
    return (2 * (3 * q8.ROWS * ld + 2 * q8.TILE * ld) + 2 * q8.TILE * kp
            + 4 * (2 * q8.TILE + 2 * q8.ROWS + 2 * kp))


# a ring of slabs (3 planes and q, 32 features) and its full and empty mbarriers
Q8_CHUNKED_BYTES = Q8_STAGES * (3 * 128 + 256) * 2 * 32 + 2 * Q8_STAGES * 8


def sdca_smem_bytes(b):
    """sdca.cu's smem_bytes: the tile blocks, then v (fp64), alpha and y."""
    return SDCA_BLOCK_BYTES + 8 * b + 4 * 2 * b


SDCA_BLOCK_BYTES = 8 * (2 * 32 + 4 * 32 * 33)   # the one-block kernel's blocks and sums
def test_wide_smem_formulas_match_the_sources():
    """The mirrors above are the sources' formulas, term for term."""
    src = {name: (ROOT / f"src/repro_torch/kernels/csrc/{name}.cu").read_text()
           for name in ("ensemble_score", "gram_matvec", "gram_q8", "sdca")}
    assert "return 4 * floats + (d == FAST_D ? 2 * WARPS * RAW_WARP : 0);" in src["ensemble_score"]
    assert ("  return INT8 ? 4 * (STAGES * BQ * CLD + 2 * PAIR * CLD + BQ) + STAGES * RAW_STEP\n"
            "              : 4 * (STAGES * (BQ + PAIR) * CLD + BQ);" in src["ensemble_score"])
    assert f"constexpr int STAGES = {ENS_STAGES};" in src["ensemble_score"]
    assert "constexpr int PAIR = 2 * EN;" in src["ensemble_score"]
    assert "constexpr int RAW_STEP = PAIR * DC + 2 * 2 * DC * 4;" in src["ensemble_score"]
    # one block an SM of the scorers' chunked kernel and of gram_q8's
    assert "__launch_bounds__(THREADS, 1)\npartials_chunked_kernel(" in src["ensemble_score"]
    assert "__launch_bounds__(CTHREADS, 1)\ngram_q8_chunked_kernel(" in src["gram_q8"]
    assert ("return 4 * (BQ * row_stride(d) + support_floats(d) + 2 * TILE + 2 * TILE) + 8 * 2 * TILE;"
            in src["gram_matvec"])
    assert "constexpr int chunked_smem_bytes() { return 2 * STAGES * STEP_ELEMS; }" in src["gram_matvec"]
    assert "constexpr int STEP_ELEMS = PLANES * SROWS * DC;" in src["gram_matvec"]
    assert "constexpr int SROWS = BQ + TILE;" in src["gram_matvec"]
    for name in ("ensemble_score", "gram_matvec"):
        assert f"constexpr int DC = {GMV_CHUNK};" in src[name]
    assert "constexpr int CLD = DC + 4;" in src["ensemble_score"]
    assert f"constexpr int MAX_SMEM = {MAX_SMEM};" in src["ensemble_score"]
    assert "chunked || smem_bytes(d) > MAX_SMEM" in src["ensemble_score"]
    # gram_matvec leaves its staged kernel past one chunk's features
    assert "  if (d > DC)\n    return launch_chunked(" in src["gram_matvec"]
    assert "2 * (XP + BQ) + RAW + 4 * (2 * BN + 2 * BM + 2 * KP);" in src["gram_q8"]
    assert ("constexpr int chunked_smem_bytes() { return STAGES * STAGE_BYTES + 2 * STAGES * 8; }"
            in src["gram_q8"])
    assert "constexpr int STAGE_BYTES = SROWS * SROW_BYTES;" in src["gram_q8"]
    assert "return block_bytes() + static_cast<int>(sizeof(double)) * b +" in src["sdca"]
    assert "return static_cast<int>(sizeof(double)) * (2 * TILE + 4 * TILE * LD);" in src["sdca"]
    assert f"constexpr int MAX_SMEM = {MAX_SMEM};" in src["sdca"]
    assert "if (smem_bytes(b) <= MAX_SMEM)" in src["sdca"]
    assert ("  return static_cast<int>(sizeof(double)) * (2 * CLUSTER * TILE + 4 * TILE * LD) +\n"
            "         static_cast<int>(sizeof(float2)) * 2 * TILE;" in src["sdca"])
    assert ("return (static_cast<int>(sizeof(double)) + static_cast<int>(sizeof(float))) * "
            "slice_cols(b);" in src["sdca"])
    assert "  const int left = MAX_SMEM - cluster_fixed_bytes() - slice_bytes(b);" in src["sdca"]
    assert "  return left > 0 ? left / (STAGE_BYTES + MBAR_BYTES) : 0;" in src["sdca"]
    assert ("return cluster_fixed_bytes() + slice_bytes(b) + ring_stages(b) * "
            "(STAGE_BYTES + MBAR_BYTES);" in src["sdca"])
    assert "constexpr int STAGE_BYTES = static_cast<int>(sizeof(float)) * TILE * CH;" in src["sdca"]


def test_staged_paths_are_chosen_exactly_where_they_fit_today():
    """The scorers keep their staged kernels up to d 220 (where their tiles
    fit), gram_matvec up to d 64 (one chunk's chain; its tiles would fit to
    220), gram_q8 up to d 128 (its k-step instantiations), SDCA its shared
    arrays up to bucket 12,352 of the engine's 64-row quantum: every shape
    of today's paths (d 8 to 37, buckets to 2,048) keeps its kernel and its
    bits."""
    staged_ens = [d for d in range(1, 4097) if ens_smem_bytes(d) <= MAX_SMEM]
    staged_gmv = [d for d in range(1, 4097) if d <= GMV_CHUNK and gmv_smem_bytes(d) <= MAX_SMEM]
    assert staged_ens == list(range(1, 221))
    assert [d for d in range(1, 4097) if gmv_smem_bytes(d) <= MAX_SMEM] == list(range(1, 221))
    assert staged_gmv == list(range(1, 65))
    assert q8.STAGED_D == 128 and all(q8_staged_bytes(k) <= MAX_SMEM for k in range(1, 9))
    shared = [b for b in range(64, 65_537, 64) if sdca_smem_bytes(b) <= MAX_SMEM]
    assert shared == list(range(64, 12_353, 64))
    assert sdca_smem_bytes(12_416) > MAX_SMEM


def test_chunked_and_global_instantiations_fit_every_shape():
    """The chunked kernels' shared memory does not depend on d: one size
    for every d up to 4,096, within a block's 227 KB; the SDCA cluster's
    fits every bucket whose K fits the card. The scorers' and gram_q8's
    chunked kernels take one block an SM (rings of three steps of 128
    queries and 128 supports, and of five 32-feature slabs of a 128 x 256
    tile and their mbarriers: 204,880 bytes)."""
    assert Q8_CHUNKED_BYTES == 204_880
    for bytes_ in (ENS_CHUNKED_BYTES, ENS_Q8_CHUNKED_BYTES, GMV_CHUNKED_BYTES, Q8_CHUNKED_BYTES):
        assert bytes_ <= MAX_SMEM
    # the SDCA cluster's ring holds a whole tile's stages up to bucket
    # 16,384 and at least one stage at every bucket whose K fits an 80 GB
    # card (b 141,312)
    for b in range(12_416, 141_313, 64):
        stages = sdca_ring_stages(b)
        assert stages >= 1 and sdca_cluster_smem_bytes(b) <= MAX_SMEM, b
        if b <= 16_384:
            assert stages >= -(-sdca_mod.slice_cols(b) // SDCA_CH), b
    assert (sdca_ring_stages(16_384), sdca_cluster_smem_bytes(16_384)) == (5, 218_704)
    # every shape past the staged limits goes to these
    assert all(ens_smem_bytes(d) > MAX_SMEM for d in range(221, 4097))
    assert all(sdca_smem_bytes(b) > MAX_SMEM for b in range(12_416, 65_537, 64))


@functools.lru_cache(maxsize=None)
def _wide_rows(d, rows=512):
    """Rows of the emnist federation at feature dim d (``make_emnist_like``'s
    ``dim``), pooled over devices: the round's data at that width."""
    from repro_torch.data.federated import make_emnist_like

    ds = make_emnist_like(seed=0, scale=0.02, dim=d)
    x = np.concatenate([dev.x for dev in ds.devices])
    return np.ascontiguousarray(x[:rows]), np.ascontiguousarray(x[rows:2 * rows])


WIDE_DS = [64, 220, 784]
ROUNDINGS = ["nearest", "truncate"]


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("d", WIDE_DS)
def test_gram_matvec_chunked_order(d, rounding):
    """The chunked route's arithmetic (three bf16 planes, the six products
    in fp32 a 64-feature step, hi.hi apart, the steps' sums and d2 in
    fp64) within the registry's 1e-5 of the plain version on emnist rows
    at default_gamma, with the tensor cores' adds rounded to nearest or
    truncated, and within it of the staged kernel's one fp32 chain (which
    runs to d 64, and could to 220)."""
    x1, x2 = _wide_rows(d)
    v = _rng("gmv-wide", d).normal(size=len(x2)).astype(np.float32)
    gamma = float(1.0 / (d * x1.var()))
    tol = ops.KERNEL_REGISTRY["gram_matvec"].tol
    chunked = gram_matvec_chunked_emulated(x1, x2, v, gamma, rounding)
    want = gmv.gram_matvec_plain(*(torch.from_numpy(a) for a in (x1, x2, v)), gamma)
    assert bool(torch.isfinite(chunked).all())
    assert float((chunked - want).abs().max()) <= tol
    if d <= 220:
        assert float((chunked - gram_matvec_emulated(x1, x2, v, gamma)).abs().max()) <= tol


@functools.lru_cache(maxsize=None)
def _cg_normals_wide(d=784, l=4096):
    rng = _rng("cg-normals-wide")
    xp = rng.normal(size=(l, d)).astype(np.float32)
    v = rng.normal(size=l).astype(np.float32)
    return xp, v, float(1.0 / (d * xp.var()))


def test_gram_matvec_one_chain_drifts_at_d784():
    """Why the chunked route does not continue the staged kernel's one fp32
    chain: at the CG's l = 4,096 on normals (chip_smoke.py's "cg" case at d
    784), that chain drifts past the registry's 1e-5 from the plain version
    where the chunked arithmetic stays within half of it (its adds rounded
    to nearest and truncated). Rows 0-255 of the 4,096, against all 4,096
    supports."""
    rows = 256
    xp, v, gamma = _cg_normals_wide()
    want = gmv.gram_matvec_plain(*(torch.from_numpy(a) for a in (xp[:rows], xp, v)), gamma)
    one_chain = gram_matvec_emulated(xp[:rows], xp, v, gamma)
    tol = ops.KERNEL_REGISTRY["gram_matvec"].tol
    assert float((one_chain - want).abs().max()) > tol
    for rounding in ROUNDINGS:
        chunked = gram_matvec_chunked_emulated(xp[:rows], xp, v, gamma, rounding)
        assert float((chunked - want).abs().max()) <= tol / 2, rounding


def test_gram_matvec_hi_hi_apart_cuts_the_truncation_error():
    """Why hi.hi has an accumulator of its own: with one accumulator for all
    six products, 24 adds a step round at the size of the cross term; with
    hi.hi apart, 4. Under truncating adds the cross terms' largest error
    against the exact fp64 product is at least twice smaller (normals at d
    784, 128 rows against 1,024 supports)."""
    xp, _, _ = _cg_normals_wide()
    a, b = torch.from_numpy(xp[:128]), torch.from_numpy(xp[:1024])
    exact = a.double() @ b.double().T
    pa, pb = [p.double() for p in gmv_planes(a)], [p.double() for p in gmv_planes(b)]
    one = torch.zeros_like(exact)
    for c0 in range(0, pa[0].shape[1], GMV_CHUNK):
        acc = torch.zeros(exact.shape, dtype=torch.float32)
        for k in range(c0, c0 + GMV_CHUNK, Q8_KSTEP):
            for i, j in GRAM_PRODUCTS:
                acc = _round_fp32(acc.double() + pa[i][:, k:k + Q8_KSTEP]
                                  @ pb[j][:, k:k + Q8_KSTEP].T, "truncate")
        one = one + acc.double()
    apart = gmv_cross(a, b, "truncate")
    assert 2 * float((apart - exact).abs().max()) <= float((one - exact).abs().max())


@pytest.mark.parametrize("d", [1, 63, 64, 65, 129, 784, 2100])
def test_gram_matvec_prologue_planes_and_norms(d):
    """The prologue's three planes give back each fp32 value to within
    2^-24 of itself (zeros past d), and its fp64 norms (the fmaf chain of
    each 64-feature chunk, the chunks added in fp64, 32 chunks a round)
    equal those of the chunked kernel this route replaced; rows of the
    emnist federation scaled over 2^-20 .. 2^20."""
    x = _wide_rows(784)[0][:64]
    x = np.tile(x, (1, -(-d // x.shape[1])))[:, :d]
    x = torch.from_numpy(x * np.exp2(np.linspace(-20, 20, 64, dtype=np.float32))[:, None])
    hi, mid, lo = gmv_planes(x)
    assert hi.shape == (64, -(-d // GMV_CHUNK) * GMV_CHUNK)
    for plane in (hi, mid, lo):
        assert torch.equal(plane, plane.bfloat16().float())   # each plane exact in bf16
        assert not plane[:, d:].any()
    back = (hi.double() + mid.double() + lo.double())[:, :d]
    assert bool(((back - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all())
    assert torch.equal(gmv_prologue_norms(x), chunked_norms_before(x))


@pytest.mark.parametrize("d", WIDE_DS)
def test_rbf_gram_q8_chunked_order(d):
    """The chunked gram_q8 order within the registry's 1e-5 of the plain
    version on emnist rows against int8 supports as the codec sends them,
    and the staged order's bits at d 64 and 220."""
    from repro_torch.comm.wire import _quantize_columns

    x, sup = _wide_rows(d)
    q, scale, zero = _quantize_columns(sup)
    gamma = float(1.0 / (d * sup.var()))
    chunked = rbf_gram_q8_split_emulated(x, q, scale, zero, gamma, chunk=Q8_CHUNK)
    want = q8.rbf_gram_q8_plain(*(torch.from_numpy(a) for a in (x, q, scale, zero)), gamma)
    assert bool(torch.isfinite(chunked).all())
    assert float((chunked - want).abs().max()) <= ops.KERNEL_REGISTRY["rbf_gram_q8"].tol
    if d <= 220:
        assert torch.equal(chunked, rbf_gram_q8_split_emulated(x, q, scale, zero, gamma))
