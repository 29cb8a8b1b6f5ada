"""RBF Gram between fp32 queries and per-column affine int8 supports:
``QuantizedSVM.predict``'s kernel.

Replaces ``repro/kernels/rbf_gram_q8.py::rbf_gram_q8_pallas`` (grid
(M/128, N/128) over VMEM tiles, the int8 tile dequantised in VMEM).
It launches ``csrc/gram_q8.cu``, a kernel of its own: the cross term
``x . s_j = sum_c (x_c scale_c) q_jc + x . zero`` runs on the bf16
tensor cores (``mma.sync``), with the int8 values exact in bf16 and
``x * scale`` split into three bf16 planes (hi, mid, lo) that carry it
to fp32 accuracy, so no operand is rounded below fp32; ``x . zero`` and
the norms are fp32 on the CUDA cores. A block owns 64 query rows and
walks a run of 128-support tiles (``split_plan``), paying for the x
side once; the int8 tiles arrive raw by ``cp.async`` and are converted
to bf16 once a tile. The fp32 supports never exist in device memory.
Past d 128 (``STAGED_D``) the stripe's planes no longer fit staged, and
the launcher takes the chunked route: a prologue writes, once a call,
the three bf16 planes of x * scale, q's bf16 image (exact), |x|^2, x .
zero and the support norms into scratch the wrapper allocates
(``chunked_scratch``, or the caller's); the kernel then walks 128-row x
256-support tiles in 32-feature slabs that a copy warp brings in as TMA
boxes through a ring of five, and two warpgroups multiply by ``wgmma``,
one block an SM (``plan``: ``split_plan`` at CHUNKED_TARGET_BLOCKS, one
wave). Each output sees the staged kernel's products in the staged
kernel's order, so the route gives its bits where both run
(``rbf_gram_q8_chunked_cuda`` launches it at any d, for that check).

Padding contract: a padded int8 row dequantises to ``zero``, not 0; the
reference pads and slices, and the kernel writes only the real (m, n)
outputs. An output depends on its query row and its support alone, so
a row's values are the same bits in any chunk of queries.

Bound on the H100: bytes at the student's 8192 x 4096 x 32, where the
134 MB output takes 0.040 ms at 3.35 TB/s, more than its operations. The
design moves the cross term off the CUDA cores (~32 FMAs and ~16 shared
loads a pair before) and leaves ~6 instructions a pair for the
epilogue (``ex2.approx``) and half a 8-byte store, so the store is the
limit. At d 784 operations: the cross term's 2 m n d at the rate of
three bf16 plane products (``obs.profile.kernel_bound``), 0.1596 ms.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.rbf_gram import rbf_gram_plain

LAUNCHES = native.LaunchCounter("rbf_gram_q8")

ROWS, TILE = 64, 128          # query rows per block, supports per tile
TARGET_BLOCKS = 3 * 132       # three resident blocks on each SM of an H100: one wave
STAGED_D = 128                # the staged kernel's largest feature dim (8 k steps of 16)
CHUNKED_ROWS, CHUNKED_TILE = 128, 256   # the chunked route's block tile
CHUNKED_TARGET_BLOCKS = 132   # its one block an SM: one wave
SLAB = 32                     # features a stage of its ring; its scratch rows' multiple
PLANES = 3                    # bf16 planes of x * scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """Per-column affine int8 -> fp32: ``q * scale + zero`` over the last
    axis, a rounded multiply then a rounded add (the reference oracle's
    arithmetic)."""
    return q.to(torch.float32) * scale + zero


def rbf_gram_q8_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      zero: torch.Tensor, gamma: float) -> torch.Tensor:
    """Plain PyTorch version: x (m, d) fp32, q (n, d) int8, scale and
    zero (d,) -> (m, n): dequantise, then the fp32 Gram."""
    return rbf_gram_plain(x, dequantize(q, scale[None, :], zero[None, :]), gamma)


def split_plan(m: int, n: int, target: int = TARGET_BLOCKS, rows: int = ROWS,
               tile: int = TILE) -> tuple:
    """(per_split, splits): support tiles of ``tile`` per block and the
    number of blocks a stripe of ``rows`` queries is split into (the
    staged kernel's ROWS x TILE within TARGET_BLOCKS, the chunked route's
    CHUNKED_ROWS x CHUNKED_TILE within CHUNKED_TARGET_BLOCKS: ``plan``). As
    many splits as keep ceil(m / rows) x splits within ``target``; split s
    takes tiles s * per_split .. (s + 1) * per_split - 1, and no split is
    empty."""
    tiles = max(1, -(-n // tile))
    stripes = max(1, -(-m // rows))
    want = max(1, min(tiles, target // stripes))
    per_split = -(-tiles // want)
    return per_split, -(-tiles // per_split)


def plan(m: int, n: int, chunked: bool) -> tuple:
    """``split_plan`` for the route that runs."""
    if chunked:
        return split_plan(m, n, CHUNKED_TARGET_BLOCKS, CHUNKED_ROWS, CHUNKED_TILE)
    return split_plan(m, n)


def chunked_scratch(m: int, n: int, d: int) -> tuple:
    """(bf16 elements, fp32 elements) of the chunked route's scratch: the
    three planes of x * scale for m rows rounded up to CHUNKED_ROWS and
    q's image for n rounded up to CHUNKED_TILE, d rounded up to SLAB
    features a row; then |x|^2 and x . zero a row and |s|^2 a support
    (``csrc/gram_q8.cu``'s ``padded_rows``, ``padded_supports`` and
    ``slab_dim``)."""
    rows = -(-m // CHUNKED_ROWS) * CHUNKED_ROWS
    supports = -(-n // CHUNKED_TILE) * CHUNKED_TILE
    return (PLANES * rows + supports) * (-(-d // SLAB) * SLAB), 2 * rows + supports


def _scratch(scratch, m: int, n: int, d: int, device: torch.device) -> tuple:
    """The chunked route's (planes, norms): ``scratch`` checked, or new."""
    elems, floats = chunked_scratch(m, n, d)
    if scratch is None:
        return (torch.empty((elems,), dtype=torch.bfloat16, device=device),
                torch.empty((floats,), dtype=torch.float32, device=device))
    planes, norms = scratch
    for name, t, dtype, want in (("planes", planes, torch.bfloat16, elems),
                                 ("norms", norms, torch.float32, floats)):
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"rbf_gram_q8: scratch {name} must be a contiguous {dtype} "
                             f"tensor on {device}")
        if t.numel() < want:
            raise ValueError(f"rbf_gram_q8: scratch {name} holds {t.numel()} elements, "
                             f"the chunked route needs {want} (chunked_scratch)")
    return planes, norms


def _launch(fn_name: str, x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            zero: torch.Tensor, gamma: float, scratch=None) -> torch.Tensor:
    x, q, scale, zero = native.prepare("rbf_gram_q8", x.device, dtypes={"q": torch.int8},
                                       x=x, q=q, scale=scale, zero=zero)
    if x.dim() != 2 or q.dim() != 2 or scale.dim() != 1 or zero.dim() != 1:
        raise ValueError("rbf_gram_q8: want x (m, d), q (n, d), scale (d,), zero (d,)")
    m, d = x.shape
    n = q.shape[0]
    if q.shape[1] != d or scale.shape[0] != d or zero.shape[0] != d:
        raise ValueError(f"rbf_gram_q8: shapes {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)} disagree")
    if d < 1:
        raise ValueError("rbf_gram_q8: the kernel takes d >= 1")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    chunked = fn_name == "rbf_gram_q8_chunked_launch" or d > STAGED_D
    per_split, splits = plan(m, n, chunked)
    planes, norms = _scratch(scratch, m, n, d, x.device) if chunked else (None, None)
    lib = native.library("gram_q8")
    native.launch(LAUNCHES, x.device, getattr(lib, fn_name),
                  x.data_ptr(), q.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                  float(gamma), out.data_ptr(),
                  None if planes is None else planes.data_ptr(),
                  None if norms is None else norms.data_ptr(), m, n, d, per_split, splits)
    return out


def rbf_gram_q8_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, gamma: float, scratch=None) -> torch.Tensor:
    """Launch ``csrc/gram_q8.cu`` on x's CUDA device: the staged kernel
    up to d ``STAGED_D``, the chunked route past it (its scratch new, or
    ``scratch`` = (planes, norms) of at least ``chunked_scratch``'s
    sizes)."""
    return _launch("rbf_gram_q8_launch", x, q, scale, zero, gamma, scratch)


def rbf_gram_q8_chunked_cuda(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                             zero: torch.Tensor, gamma: float, scratch=None) -> torch.Tensor:
    """The chunked route at any d, for holding it bit for bit to the
    staged kernel where both run; no path of the port calls it."""
    return _launch("rbf_gram_q8_chunked_launch", x, q, scale, zero, gamma, scratch)
