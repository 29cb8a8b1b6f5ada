"""Batched cyclic SDCA on the hinge-loss dual: every local fit and the
pooled-data ideal.

Replaces ``repro/core/svm.py::_sdca``, which is not a Pallas kernel but
an XLA ``fori_loop`` inside ``jit``, vmapped over a bucket of devices by
the reference engine. In eager PyTorch each of its 20 x bucket
coordinate steps would be several launches, so ``csrc/sdca.cu`` runs the
whole solve in one launch, one block per device, as a tiled,
delayed-update solve: coordinates go in tiles of ``TILE``; a tile's
K (y o alpha) is summed in fp64 once, from alpha at the tile's start, by
warps that work one tile ahead; one warp then steps through the tile, a
lane a coordinate, carrying each step's change into the other lanes'
fp64 sums with a shuffle instead of a block reduction.

Bound on the H100: latency. The steps form one dependent chain per
device (40,000 for the ideal), so neither the bytes (each K read once)
nor the operations bound it; the design shortens one step to a shuffle,
the reference's fp32 arithmetic and three fp64 operations, with one
barrier a tile and none a step, and streams each tile's K rows from L2
under the steps of the tile before.

v (fp64), alpha and y live in shared memory up to a bucket of 12,384
(``sdca_smem_bytes``). Past it K outgrows the L2 too, and the launcher
takes a second kernel: one thread-block cluster of ``CLUSTER`` CTAs per
device, each owning a slice of the columns (``slice_cols``), streaming its
slice of every tile's K rows through a ring of bulk asynchronous copies
and summing the next tile's matvec over it; rank 0 steps, adding the
ranks' sums in rank order, with one cluster barrier a tile. The sums'
order differs from the one-block kernel's, so the two agree within the
tolerance, not bit for bit (``sdca_global_cuda`` launches the cluster
kernel at any bucket, for that check).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native

LAUNCHES = native.LaunchCounter("sdca")
# The kernel's order of summation (tests/test_torch_kernel_design.py emulates
# it): coordinates go in tiles of TILE, one lane each of the stepping warp; a
# tile row's matvec is summed by 32 lanes, lane l over the GROUP-column groups
# l, l + 32, ... in turn, then over the lanes pairwise, bit 4 of the lane first.
TILE = 32
GROUP = 4
# The cluster kernel's (past bucket 12,384): rank r of CLUSTER sums the
# columns [r W, min(r W + W, n)), W = slice_cols(n); lane l of a rank over
# the slice's GROUP-column groups l, l + 32, ..., the lanes pairwise, then
# rank 0 adds the ranks' sums in rank order.
CLUSTER = 16
SLICE_UNIT = 32 * GROUP


def slice_cols(n: int) -> int:
    """Columns each rank of the cluster kernel owns for a device of ``n``
    real coordinates: ceil(n / CLUSTER) rounded up to whole passes of the
    32 lanes (``SLICE_UNIT``); ranks past n own none."""
    return -(-n // (CLUSTER * SLICE_UNIT)) * SLICE_UNIT


def sdca_plain(K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
               lam: float, epochs: int = 20) -> torch.Tensor:
    """Plain PyTorch version, step for step the reference's ``_sdca``
    vectorised over the device axis: K (g, b, b) zero-padded Grams,
    y (g, b) labels padded with +1, n_real (g,) int32 real counts.
    Returns alpha (g, b) in [0, 1], zero on padded coordinates.

    Each step's dot K_i (y o alpha) is summed in fp64 (the products of
    fp32 values are exact there), then rounded to fp32 for the
    reference's fp32 step, as the kernel sums: at buckets past 12,000 an
    fp32 sum's rounding, which depends on the order of its terms, moves
    some alphas by more than the registry's 1e-5 (the pooled emnist
    ideal at buckets 12,416 and 16,384, 2 epochs).

    Steps for coordinates i >= max(n_real) only write 0 into an alpha
    that is already 0, so the loop stops there."""
    g, b, _ = K.shape
    Ky = (K * y[:, None, :]).double()
    k_ii = torch.clamp(torch.diagonal(K, dim1=1, dim2=2), min=1e-8)
    # 1 on a device's real coordinates: a masked step writes 0, as the reference's
    real = (torch.arange(b, device=K.device)[None, :] < n_real[:, None]).to(torch.float32)
    n_f = n_real.to(torch.float32)
    lam_n = lam * n_f
    alpha = torch.zeros((g, b), dtype=torch.float64, device=K.device)   # fp32 values
    live = int(n_real.max()) if g else 0
    for _ in range(epochs):
        for i in range(min(live, b)):
            f = torch.matmul(Ky[:, i:i + 1, :], alpha[:, :, None])[:, 0, 0].float() / lam_n
            grad = 1.0 - y[:, i] * f
            step = grad * lam * n_f / k_ii[:, i]
            alpha[:, i] = torch.clamp(alpha[:, i].float() + step, 0.0, 1.0) * real[:, i]
    return alpha.float()


def pad_bucket(K: torch.Tensor, y: torch.Tensor) -> tuple:
    """K and y with the bucket padded to a multiple of ``GROUP`` (the
    kernel reads K rows ``GROUP`` columns at a time): K's new rows and
    columns 0, y's new entries +1, as the engine pads a device's rows.
    The padded coordinates lie past every ``n_real``, so their alphas
    stay 0 and their K entries add exact zeros to every sum."""
    g, b, _ = K.shape
    pad = -b % GROUP
    if pad == 0:
        return K, y
    return (torch.nn.functional.pad(K, (0, pad, 0, pad)),
            torch.nn.functional.pad(y, (0, pad), value=1.0))


def _launch(fn_name: str, K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
            lam: float, epochs: int) -> torch.Tensor:
    K, y, n_real = native.prepare("sdca", K.device, dtypes={"n_real": torch.int32},
                                  K=K, y=y, n_real=n_real)
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"sdca: want K (g, b, b), got {tuple(K.shape)}")
    g, b, _ = K.shape
    if tuple(y.shape) != (g, b) or tuple(n_real.shape) != (g,):
        raise ValueError(f"sdca: y {tuple(y.shape)} / n_real {tuple(n_real.shape)} "
                         f"do not match K {tuple(K.shape)}")
    if g == 0 or b == 0:
        return torch.zeros((g, b), dtype=torch.float32, device=K.device)
    K, y = pad_bucket(K, y)
    bp = K.shape[1]
    alpha = torch.empty((g, bp), dtype=torch.float32, device=K.device)
    native.launch(LAUNCHES, K.device, getattr(native.library("sdca"), fn_name),
                  K.data_ptr(), y.data_ptr(), n_real.data_ptr(), alpha.data_ptr(),
                  g, bp, float(lam), int(epochs))
    return alpha if bp == b else alpha[:, :b].contiguous()


def sdca_cuda(K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
              lam: float, epochs: int = 20) -> torch.Tensor:
    """Launch ``csrc/sdca.cu`` on K's CUDA device: one block per device
    where v, alpha and y fit in shared memory, one cluster per device past
    that."""
    return _launch("sdca_launch", K, y, n_real, lam, epochs)


def sdca_global_cuda(K: torch.Tensor, y: torch.Tensor, n_real: torch.Tensor,
                     lam: float, epochs: int = 20) -> torch.Tensor:
    """The cluster kernel, which ``sdca_cuda`` takes past bucket 12,384,
    at any bucket: for holding it to the one-block kernel where both run;
    no path of the port calls it."""
    return _launch("sdca_cluster_launch", K, y, n_real, lam, epochs)
