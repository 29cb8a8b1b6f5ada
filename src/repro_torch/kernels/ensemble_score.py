"""Fused mean-of-member RBF-SVM scores: every ensemble evaluation and
every ``SVMModel.predict``.

Replaces ``repro/kernels/ensemble_score.py::ensemble_score_pallas``. The
TPU kernel walks a sequential (query tile, member, support tile) grid
and adds each partial into a VMEM scratch accumulator scaled by 1/k.
CUDA blocks run in parallel, so ``csrc/ensemble_score.cu`` splits the
(member, 64-support tile) work items over a second grid dimension:
support norms once per support, then one block per (128-query tile,
split) with an 8 x 4 register tile of fp32 FMAs per thread, each warp
staging its own rows of the next item by ``cp.async`` while it computes
this one, writing one fp32 partial per query and split; a last pass adds each query's partials in
split order and divides by k. No atomics; the (k, b, n_max) Gram never
exists. ``split_plan`` picks the split from (k, n_max) alone, never from
b, so a query's score is bit-identical whatever chunk it is scored in.
Past d 220 the query tile and two support tiles no longer fit in shared
memory over the whole feature dim, and the launcher takes a chunked
partials kernel: one block an SM walks its split's items two at a time,
64 features a step through a three-step ``cp.async`` ring (16-byte
copies where d % 4 == 0), an 8 x (4 + 4) register tile a thread, the
queries' norms from one coalesced pass a call. Each pair's fmaf chain
runs across the chunks in the staged kernel's order, and each thread
adds its items' terms in the staged kernel's order, so the two give the
same bits where both run (``ensemble_score_chunked_cuda`` launches it at
any d, for that check).

Bound on the H100: fp32 operations. A query-support pair costs about
2d + 8 operations; at the full ensemble (b 8192, k 2821, n_max 230,
d 32) that is 5.71 ms at 67 TFLOP/s, against 1.6 ms to read the 83 MB
fp32 ensemble once per query tile.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("ensemble_score")

# the plain version materialises (members, b, n_max) Gram slabs; this caps
# one slab at 2^27 fp32 elements (512 MB) so full ensembles fit on the card
_PLAIN_SLAB_ELEMS = 1 << 27


SUPPORT_TILE = 64    # supports per work item (csrc/ensemble_score.cu's EN)
# splits when there are enough items: two blocks on each of the H100's 132
# SMs when one query tile (128 queries) is all there is
SPLIT_TARGET = 264


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The kernel's second grid dimension: ``items`` (member, support
    tile) work items, member-major, ``tiles`` to a member; split ``s``
    walks items ``s * per_split`` up to ``(s + 1) * per_split``."""

    tiles: int
    items: int
    per_split: int
    splits: int

    def work(self, split: int) -> List[Tuple[int, int]]:
        """(member, support tile) pairs that split ``split`` scores, in order."""
        lo = split * self.per_split
        return [divmod(i, self.tiles) for i in range(lo, min(lo + self.per_split, self.items))]


def split_plan(k: int, n_max: int) -> SplitPlan:
    """The split for k members of n_max (padded) supports. It takes no
    query count: the order in which a query's partial sums are formed
    and added must not depend on how many queries share the call."""
    tiles = -(-n_max // SUPPORT_TILE)
    items = k * tiles
    per_split = max(1, -(-items // SPLIT_TARGET))
    return SplitPlan(tiles, items, per_split, max(1, -(-items // per_split)))


def launch_scores(name: str, counter, fn, x: torch.Tensor, supports: tuple,
                  coef: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """Allocate the scratch of ``csrc/ensemble_score.cu`` (support norms,
    then the chunked kernel's query norms; per-split partials) and the
    output, then run its launcher ``fn`` on x (b, d) against ``supports``
    (the loader's tensors)."""
    b, d = x.shape
    k, n_max = coef.shape
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    plan = split_plan(k, n_max)
    norms = torch.empty((k * n_max + b,), dtype=torch.float32, device=x.device)
    partial = torch.empty((plan.splits * b,), dtype=torch.float32, device=x.device)
    native.launch(counter, x.device, fn, x.data_ptr(), *(t.data_ptr() for t in supports),
                  coef.data_ptr(), gammas.data_ptr(), norms.data_ptr(), partial.data_ptr(),
                  out.data_ptr(), b, k, n_max, d, plan.per_split, plan.splits)
    return out


def plain_slab(b: int, n_max: int) -> int:
    """Members per slab of the plain versions at b queries, n_max supports."""
    return max(1, _PLAIN_SLAB_ELEMS // max(b * n_max, 1))


def member_scores_plain(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                        gammas: torch.Tensor) -> torch.Tensor:
    """Each member's ``sum_j coef_j exp(-gamma |x - s_j|^2)``: x (b, d),
    sup (k, n_max, d), coef (k, n_max), gammas (k,) -> (k, b). Members
    go in slabs so the Gram slab stays bounded."""
    b = x.shape[0]
    k, n_max, _ = sup.shape
    sqx = (x * x).sum(1)[None, :, None]                    # (1, b, 1)
    step = plain_slab(b, n_max)
    scores = []
    for lo in range(0, k, step):
        s = sup[lo: lo + step]
        sqs = (s * s).sum(-1)[:, None, :]                  # (t, 1, n)
        cross = torch.matmul(x[None], s.transpose(1, 2))   # (t, b, n)
        d2 = torch.clamp(sqx + sqs - 2.0 * cross, min=0.0)
        kq = torch.exp(-gammas[lo: lo + step, None, None] * d2)
        scores.append(torch.bmm(kq, coef[lo: lo + step, :, None])[:, :, 0])
    return torch.cat(scores)


def ensemble_score_plain(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                         gammas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (b, d), sup (k, n_max, d), coef
    (k, n_max), gammas (k,) -> (b,) mean over members of each member's
    score; per-member scores are stacked and averaged as the reference's
    oracle does."""
    return member_scores_plain(x, sup, coef, gammas).mean(0)


def _check(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
           gammas: torch.Tensor) -> tuple:
    """The inputs as the kernel reads them (``native.prepare``), their
    shapes checked."""
    x, sup, coef, gammas = native.prepare("ensemble_score", x.device, x=x, sup=sup, coef=coef,
                                          gammas=gammas)
    if x.dim() != 2 or sup.dim() != 3 or coef.dim() != 2 or gammas.dim() != 1:
        raise ValueError("ensemble_score: want x (b, d), sup (k, n_max, d), "
                         "coef (k, n_max), gammas (k,)")
    b, d = x.shape
    k, n_max, ds = sup.shape
    if ds != d or tuple(coef.shape) != (k, n_max) or gammas.shape[0] != k:
        raise ValueError(f"ensemble_score: shapes {tuple(x.shape)}, {tuple(sup.shape)}, "
                         f"{tuple(coef.shape)}, {tuple(gammas.shape)} disagree")
    if k == 0:
        raise ValueError("ensemble_score: empty ensemble")
    return x, sup, coef, gammas


def ensemble_score_cuda(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                        gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ensemble_score.cu`` on x's CUDA device: the staged
    partials kernel where its tiles fit in shared memory, the chunked one
    past it."""
    x, sup, coef, gammas = _check(x, sup, coef, gammas)
    lib = native.library("ensemble_score")
    return launch_scores("ensemble_score", LAUNCHES, lib.ensemble_score_launch, x, (sup,),
                         coef, gammas)


def ensemble_score_chunked_cuda(x: torch.Tensor, sup: torch.Tensor, coef: torch.Tensor,
                                gammas: torch.Tensor) -> torch.Tensor:
    """The chunked partials kernel at any d, for holding it bit for bit to
    the staged one where both run; no path of the port calls it."""
    x, sup, coef, gammas = _check(x, sup, coef, gammas)
    lib = native.library("ensemble_score")
    return launch_scores("ensemble_score", LAUNCHES, lib.ensemble_score_chunked_launch, x,
                         (sup,), coef, gammas)
