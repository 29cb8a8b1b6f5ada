"""Streaming RBF-Gram matvec ``K(x1, x2; gamma) @ v``: the matvec of the
distillation CG solver.

Replaces ``repro/kernels/gram_matvec.py::gram_matvec_pallas``. The TPU
kernel carries a (bm, 1) sum across a sequential support-tile grid in
VMEM; CUDA blocks run in parallel, so ``csrc/gram_matvec.cu`` gives each
block 128 rows and one contiguous split of the supports (``split_plan``),
keeps the row sums in registers over the split's 64-support tiles,
writes one partial sum per (split, row), and a second launch adds the
splits in order. No atomics; the (m, n) Gram never exists on either
path (the plain version goes in row chunks). Both paths sum over
supports in fp64: an fp32 sum of 4096 terms drifts by ~1e-5 with the
order of its terms alone, more than the registry's 1e-5 between the two
at the CG's l = 4096.

Past d 64 the launcher takes the chunked route, whose cross term runs on
the bf16 tensor cores: a prologue splits each operand once a call (once
when x2 is x1, the CG's case) into three bf16 planes padded to a
multiple of 64 features, with each row's norm in fp64, into scratch the
wrapper allocates (``chunked_scratch``); the kernel then walks (support
tile, 64-feature chunk) steps, runs the six plane products of order >=
2^-16 through ``mma.sync`` into fp32 accumulators a step, and adds the
steps' sums in fp64. No fp32 sum spans more than 64 features: the staged
kernel's single fp32 chain over all features drifts past the registry's
1e-5 from the plain version at l = 4096 already at d 129. So the chunked
route does not give the staged kernel's bits where both run
(``gram_matvec_chunked_cuda`` launches it at any d, for the checks that
hold the two within the tolerance). It takes one block an SM, so its
splits fill CHUNKED_TARGET_BLOCKS, one wave.

Bound on the H100: operations. The cross term's 2 m n d operations are
priced at the rate of an fp32-accurate product from three bf16 planes
(``obs.profile.kernel_bound``): at the CG's l = 4096, d = 32 one call is
~1.1e9 of them against 1 MB of inputs, 0.0065 ms. ``split_plan`` fills
the card's two resident blocks an SM of the staged kernel in one wave.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.rbf_gram import rbf_gram_plain

LAUNCHES = native.LaunchCounter("gram_matvec")

ROWS, TILE = 128, 64          # rows per block, supports per staged tile
TARGET_BLOCKS = 2 * 132       # two resident blocks on each SM of an H100: one wave
CHUNKED_TARGET_BLOCKS = 132   # the chunked kernel's one block an SM: one wave
CHUNK = 64                    # features of the staged kernel's chain; the chunked route's steps
PLANES = 3                    # bf16 planes of each operand on the chunked route
_PLAIN_ROW_CHUNK = 1024       # the reference oracle's row chunk


def gram_matvec_plain(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                      gamma: float) -> torch.Tensor:
    """Plain PyTorch version: x1 (m, d), x2 (n, d), v (n,) -> (m,)
    ``K(x1, x2; gamma) @ v``, row-chunked as the reference's oracle is,
    so at most a (1024, n) Gram block exists at a time; the fp32 Gram
    block meets v in an fp64 product, as the kernel sums in fp64."""
    vd = v.to(torch.float64)
    outs = [(rbf_gram_plain(x1[lo: lo + _PLAIN_ROW_CHUNK], x2, gamma).to(torch.float64)
             @ vd).to(torch.float32)
            for lo in range(0, x1.shape[0], _PLAIN_ROW_CHUNK)]
    return torch.cat(outs) if outs else x1.new_zeros((0,))


def split_plan(m: int, n: int, target: int = TARGET_BLOCKS) -> tuple:
    """(per_split, splits): 64-support tiles per split and the number of
    splits. As many splits as keep ceil(m / ROWS) x splits within
    ``target`` blocks (TARGET_BLOCKS for the staged kernel,
    CHUNKED_TARGET_BLOCKS for the chunked one), one wave; split s takes
    tiles s * per_split .. (s + 1) * per_split - 1, and no split is
    empty."""
    tiles = max(1, -(-n // TILE))
    row_blocks = max(1, -(-m // ROWS))
    want = max(1, min(tiles, target // row_blocks))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def chunked_scratch(m: int, n: int, d: int, same: bool) -> tuple:
    """(bf16 plane elements, fp64 norms) of the chunked route's scratch:
    each operand's rows rounded up to ROWS, x2's after x1's unless x2 is
    x1, times PLANES planes of d rounded up to CHUNK features
    (``csrc/gram_matvec.cu``'s ``scratch_rows`` and ``padded_dim``)."""
    rows = -(-m // ROWS) * ROWS + (0 if same else -(-n // ROWS) * ROWS)
    return PLANES * rows * (-(-d // CHUNK) * CHUNK), rows


def _launch(fn_name: str, x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
            gamma: float) -> torch.Tensor:
    x1, x2, v = native.prepare("gram_matvec", x1.device, x1=x1, x2=x2, v=v)
    if x1.dim() != 2 or x2.dim() != 2 or v.dim() != 1:
        raise ValueError("gram_matvec: want x1 (m, d), x2 (n, d), v (n,)")
    m, d = x1.shape
    n = x2.shape[0]
    if x2.shape[1] != d or v.shape[0] != n:
        raise ValueError(f"gram_matvec: shapes {tuple(x1.shape)}, {tuple(x2.shape)}, "
                         f"{tuple(v.shape)} disagree")
    out = torch.empty((m,), dtype=torch.float32, device=x1.device)
    if m == 0:
        return out
    if n == 0:
        return out.zero_()
    lib = native.library("gram_matvec")
    chunked = fn_name == "gram_matvec_chunked_launch" or d > CHUNK
    per_split, splits = split_plan(m, n, CHUNKED_TARGET_BLOCKS if chunked else TARGET_BLOCKS)
    partial = torch.empty((splits, m), dtype=torch.float64, device=x1.device)
    planes = norms = None
    if chunked:
        same = x1.data_ptr() == x2.data_ptr() and m == n
        elems, rows = chunked_scratch(m, n, d, same)
        planes = torch.empty((elems,), dtype=torch.bfloat16, device=x1.device)
        norms = torch.empty((rows,), dtype=torch.float64, device=x1.device)
    native.launch(LAUNCHES, x1.device, getattr(lib, fn_name),
                  x1.data_ptr(), x2.data_ptr(), v.data_ptr(), float(gamma),
                  partial.data_ptr(), out.data_ptr(),
                  None if planes is None else planes.data_ptr(),
                  None if norms is None else norms.data_ptr(), m, n, d, per_split, splits)
    return out


def gram_matvec_cuda(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                     gamma: float) -> torch.Tensor:
    """Launch ``csrc/gram_matvec.cu`` on x1's CUDA device: the staged
    kernel up to d 64, the chunked route past it."""
    return _launch("gram_matvec_launch", x1, x2, v, gamma)


def gram_matvec_chunked_cuda(x1: torch.Tensor, x2: torch.Tensor, v: torch.Tensor,
                             gamma: float) -> torch.Tensor:
    """The chunked route at any d, for holding it within the tolerance
    to the staged kernel where both run; no path of the port calls it."""
    return _launch("gram_matvec_chunked_launch", x1, x2, v, gamma)
