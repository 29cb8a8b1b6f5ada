"""Batched RBF Gram matrices: the engine's fit and score kernel.

Replaces ``repro/kernels/batched_gram.py::batched_rbf_gram_pallas`` (the
TPU kernel, grid (g, M/bm, N/bn) over VMEM tiles) with the hand-written
CUDA kernel in ``csrc/gram.cu`` (``batched_rbf_gram_kernel``). The cross
term runs on the bf16 tensor cores (``mma.sync``): both fp32 operands
are split into three bf16 planes (hi, mid, lo) that carry them to fp32
accuracy, and the six plane products of order >= 2^-16 are summed in
one fp32 accumulator, so no operand is rounded below fp32. The norms
are fp32 chains on the CUDA cores, and the clamp and ``ex2.approx``
run on the fragments before the only store. One block computes one
``rows`` x 64 output tile of one device; ``tile_plan`` picks ``rows``
(16, 32 or 64) from (m, n, d) alone, so a val batch of 16 queries
against 64 supports computes a 16 x 64 tile, not a 64 x 64 one. The
operands arrive by 16-byte ``cp.async`` and are converted once a tile;
a fit's tile on the diagonal (x2 is x1) stages and converts its rows
once. The source comment has the whole design.

Bound on the H100: bytes. At the engine's shapes (d = 32, b <= 256) each
output element costs about 2d + 6 operations against 4 bytes written,
under the card's 20 fp32 operations a byte, and the tensor cores take
the 2d; the least bytes are each input read once (an operand passed as
both x1 and x2, as the fit passes it, once) and each output written once.
What holds the kernel is instruction issue, not bytes (``PERF.md``
section 6 has its device times beside the bounds).

Padding contract (the reference's): a zero-padded row gives
``exp(-gamma |x|^2) != 0``; the engine masks rows and columns after the
call (``sim/engine.py``). Nothing is masked here. An output depends on
its row, its column and gamma alone, never on g, m, n or the plan, so a
device's Gram is the same bits alone and in a group.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("batched_rbf_gram")

ROW_TILES = (64, 32, 16)   # rows a tile the kernel is built for, largest first
COLS = 64                  # columns a tile
STAGED = (32, 64)          # features staged at once; above 64, chunks of 64
MAX_PAST = 0.2             # share of a launch's computed rows that may lie past m
MAX_GRID_Y = 65535         # row tiles a launch (CUDA's grid limit)
MAX_GRID_Z = 65535         # devices a launch (CUDA's grid limit)


def tile_plan(m: int, n: int, d: int) -> tuple:
    """(rows, cols, staged) of one launch, from (m, n, d) alone (never g):
    the largest of ``ROW_TILES`` whose row tiles leave at most
    ``MAX_PAST`` of the computed rows past m, else the smallest; ``COLS``
    columns; the smallest of ``STAGED`` that holds d, else 64 (d is then
    staged in chunks of 64 features)."""
    del n   # every launch takes 64-column tiles
    for rows in ROW_TILES:
        computed = -(-m // rows) * rows
        if computed - m <= MAX_PAST * computed:
            break
    staged = next((s for s in STAGED if d <= s), STAGED[-1])
    return rows, COLS, staged


def batched_rbf_gram_plain(x1: torch.Tensor, x2: torch.Tensor,
                           gammas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x1 (g, m, d), x2 (g, n, d), gammas (g,)
    -> (g, m, n) with out[t] = exp(-gammas[t] |x1[t,i] - x2[t,j]|^2)."""
    sq1 = (x1 * x1).sum(-1)[:, :, None]
    sq2 = (x2 * x2).sum(-1)[:, None, :]
    cross = torch.bmm(x1, x2.transpose(1, 2))
    d2 = torch.clamp(sq1 + sq2 - 2.0 * cross, min=0.0)
    return torch.exp(-gammas[:, None, None] * d2)


def launch_plan(m: int, n: int, d: int) -> tuple:
    """``tile_plan``'s (rows, staged), the launcher's arguments (every tile
    is ``COLS`` wide)."""
    rows, _, staged = tile_plan(m, n, d)
    return rows, staged


def launch_slices(g: int, m: int, rows: int) -> list:
    """(device slice, row slice) of each launch. One launch where the grid
    takes the call (at most ``MAX_GRID_Z`` devices and ``MAX_GRID_Y``
    row tiles); past ``MAX_GRID_Z`` devices, runs of that many; past
    ``MAX_GRID_Y`` row tiles, one device at a time in runs of that many
    tiles of rows. An output depends on its row, its column and gamma
    alone, so the split changes no value."""
    if -(-m // rows) <= MAX_GRID_Y:
        return [(slice(lo, min(lo + MAX_GRID_Z, g)), slice(0, m))
                for lo in range(0, g, MAX_GRID_Z)]
    span = MAX_GRID_Y * rows
    return [(slice(t, t + 1), slice(lo, min(lo + span, m)))
            for t in range(g) for lo in range(0, m, span)]


def batched_rbf_gram_cuda(x1: torch.Tensor, x2: torch.Tensor,
                          gammas: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gram.cu`` (per-device gamma) on x1's CUDA device:
    one launch, or ``launch_slices``' several past the grid."""
    x1, x2, gammas = native.prepare("batched_rbf_gram", x1.device, x1=x1, x2=x2, gammas=gammas)
    if x1.dim() != 3 or x2.dim() != 3 or gammas.dim() != 1:
        raise ValueError("batched_rbf_gram: want x1 (g, m, d), x2 (g, n, d), gammas (g,)")
    g, m, d = x1.shape
    n = x2.shape[1]
    if x2.shape[0] != g or x2.shape[2] != d or gammas.shape[0] != g:
        raise ValueError(f"batched_rbf_gram: shapes {tuple(x1.shape)}, "
                         f"{tuple(x2.shape)}, {tuple(gammas.shape)} disagree")
    out = torch.empty((g, m, n), dtype=torch.float32, device=x1.device)
    if out.numel() == 0:
        return out
    rows, staged = launch_plan(m, n, d)
    fn = native.library("gram").batched_rbf_gram_launch
    parts = launch_slices(g, m, rows)
    if len(parts) == 1:
        native.launch(LAUNCHES, x1.device, fn, x1.data_ptr(), x2.data_ptr(), gammas.data_ptr(),
                      out.data_ptr(), g, m, n, d, rows, staged)
        return out
    for dev, rs in parts:
        a, b, gam = native.prepare("batched_rbf_gram", x1.device, x1=x1[dev, rs], x2=x2[dev],
                                   gammas=gammas[dev])
        part = torch.empty((a.shape[0], a.shape[1], n), dtype=torch.float32, device=x1.device)
        native.launch(LAUNCHES, x1.device, fn, a.data_ptr(), b.data_ptr(), gam.data_ptr(),
                      part.data_ptr(), a.shape[0], a.shape[1], n, d, rows, staged)
        out[dev, rs] = part
    return out
