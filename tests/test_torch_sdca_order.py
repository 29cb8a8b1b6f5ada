"""The SDCA kernel's orders of summation (``csrc/sdca.cu``), emulated in
plain PyTorch, and the cluster kernel's structure, checked on the CPU.

- ``sdca_tiled_emulated``: the one-block kernel's order (buckets up to
  12,384); ``sdca_cluster_emulated``: the cluster kernel's past it, each
  of ``CLUSTER`` ranks summing its slice of columns lane by lane and the
  ranks' sums added in rank order. ``tests/test_torch_kernel_design.py``
  holds both within the registry's tol of the plain version;
  ``tests/test_torch_cuda.py`` holds the cluster kernel bitwise to its
  emulation on the card.
- The cluster kernel's constants and shared memory mirror the source, its
  slices cover every column once and leave out the stepping tile's, and
  its copy ring's schedule never waits on a later phase.

Imports no JAX, so the card's tests can import it.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import sdca as sdca_mod
from repro_torch.utils.seeds import derive_stream_seed

SDCA_SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/sdca.cu"
MAX_SMEM = 232448   # shared memory a block may take on sm_90 (native.MAX_SMEM_BYTES)
SDCA_CH, SDCA_CMW = 256, 8                       # the cluster kernel's stage width, matvec warps
# the cluster kernel's: rank 0's sums by rank, blocks and (y, alpha), in every rank
SDCA_CLUSTER_FIXED = 8 * (2 * 16 * 32 + 4 * 32 * 33) + 8 * 2 * 32
SDCA_STAGE = 4 * 32 * SDCA_CH + 2 * 8                  # a ring stage and its two mbarriers


def sdca_ring_stages(b):
    """sdca.cu's ring_stages: what shared memory leaves after the fixed part
    and a slice's v and alpha."""
    left = MAX_SMEM - SDCA_CLUSTER_FIXED - 12 * sdca_mod.slice_cols(b)
    return max(0, left) // SDCA_STAGE


def sdca_cluster_smem_bytes(b):
    return SDCA_CLUSTER_FIXED + 12 * sdca_mod.slice_cols(b) + sdca_ring_stages(b) * SDCA_STAGE


def sdca_tiled_emulated(K, y, n_real, lam, epochs):
    """``csrc/sdca.cu``'s one-block kernel in plain PyTorch, device by
    device. Tile u (of ``epochs`` x ceil(n / TILE)) starts from w = (its
    rows' matvec over every column outside tile u-1) + (tile u-1's columns,
    added step by step during tile u-1 from the new alphas). The matvec of a
    row: lane l of 32 adds the GROUP-column groups l, l + 32, ... in turn
    (products exact in fp64), then the lanes' sums are added pairwise over
    bit 4, then 3, ... 0. A step: the reference's fp32 arithmetic on
    (float)w_r, then w += (K y)[:, r] (alpha_new - alpha_old) in fp64."""
    return _sdca_emulated(K, y, n_real, lam, epochs, ranks=1)


def sdca_cluster_emulated(K, y, n_real, lam, epochs, ranks=sdca_mod.CLUSTER):
    """``csrc/sdca.cu``'s cluster kernel (past bucket 12,384) in plain
    PyTorch: the one-block kernel's tiles, steps and carry, but a row's
    matvec summed by ``ranks`` ranks, rank k over its slice of columns
    [k W, min(k W + W, n)) (W = ``slice_cols``), lane l over the slice's
    groups l, l + 32, ..., the lanes pairwise; then the ranks' sums in rank
    order 0 .. ranks - 1, then the carry."""
    return _sdca_emulated(K, y, n_real, lam, epochs, ranks=ranks)


def _slice_cols(n, ranks):
    """slice_cols(n) of a cluster of ``ranks`` (one rank: ceil(n / 128) 128)."""
    unit = sdca_mod.SLICE_UNIT
    return -(-n // (ranks * unit)) * unit


def _sdca_emulated(K, y, n_real, lam, epochs, ranks):
    K, y, n_real = (torch.as_tensor(a) for a in (K, y, n_real))
    g, b, _ = K.shape
    T, G = sdca_mod.TILE, sdca_mod.GROUP
    lam32 = np.float32(lam)
    out = torch.zeros((g, b), dtype=torch.float32)
    for t in range(g):
        nr = int(n_real[t])
        n = max(0, min(nr, b))
        nf = np.float32(nr)
        lam_n = lam32 * nf
        yv = y[t, :n]
        alpha = torch.zeros(n, dtype=torch.float32)
        tiles = -(-n // T)
        W = _slice_cols(n, ranks)
        Kp = torch.zeros((n, ranks * W), dtype=torch.float64)
        Kp[:, :n] = K[t, :n, :n].double()

        def start(u):
            return (u % tiles) * T

        def block(r0, c0):   # K[r0 + r, c0 + c] y[c0 + c], zero past n
            blk = torch.zeros((T, T), dtype=torch.float32)
            rr, cc = min(T, n - r0), min(T, n - c0)
            blk[:rr, :cc] = K[t, r0:r0 + rr, c0:c0 + cc] * yv[c0:c0 + cc]
            return blk.double()

        def matvec(s, ex):
            v = torch.zeros(Kp.shape[1], dtype=torch.float64)
            v[:n] = (yv * alpha).double()
            v[ex:ex + T] = 0.0
            rows = Kp[torch.clamp(torch.arange(s, s + T), max=n - 1)]
            # column k W + (32 j + lane) G + q
            prod = (rows * v).view(T, ranks, W // (32 * G), 32, G)
            lanes = torch.zeros((T, ranks, 32), dtype=torch.float64)
            for j in range(prod.shape[2]):
                for q in range(G):
                    lanes = lanes + prod[:, :, j, :, q]
            while lanes.shape[-1] > 1:
                halves = lanes.view(T, ranks, 2, -1)
                lanes = halves[:, :, 0] + halves[:, :, 1]
            w = lanes[:, 0, 0]
            for k in range(1, ranks):
                w = w + lanes[:, k, 0]
            return w

        carry = torch.zeros(T, dtype=torch.float64)
        for u in range(epochs * tiles):
            s = start(u)
            w = matvec(s, start(u - 1) if u > 0 else n) + carry
            D, B = block(s, s), block(start(u + 1), s)
            carry = torch.zeros(T, dtype=torch.float64)
            for r in range(min(T, n - s)):
                i = s + r
                old = alpha[i].numpy()[()]
                f = np.float32(float(w[r])) / lam_n
                grad = np.float32(1.0) - yv[i].numpy()[()] * f
                step = grad * lam32 * nf / np.maximum(K[t, i, i].numpy()[()], np.float32(1e-8))
                new = np.minimum(np.maximum(old + step, np.float32(0.0)), np.float32(1.0))
                alpha[i] = float(new)
                w = w + D[:, r] * (float(new) - float(old))
                carry = carry + B[:, r] * float(new)
        out[t, :n] = alpha
    return out


def _rng(purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive_stream_seed(11, purpose, index))


def test_sdca_cluster_constants_match_the_kernel():
    """The cluster kernel's size, slice rule, stage width and warps, as the
    emulation and the mirrors here take them."""
    src = SDCA_SRC.read_text()
    assert f"constexpr int CLUSTER = {sdca_mod.CLUSTER};" in src
    assert "constexpr int SLICE_UNIT = 32 * GROUP;" in src and sdca_mod.SLICE_UNIT == 128
    assert ("  return (n + CLUSTER * SLICE_UNIT - 1) / (CLUSTER * SLICE_UNIT) * SLICE_UNIT;"
            in src)
    assert f"constexpr int CH = {SDCA_CH};" in src
    assert f"constexpr int CMW = {SDCA_CMW};" in src
    assert "constexpr int CRPW = TILE / CMW;" in src
    assert "constexpr int CPASS = CH / SLICE_UNIT;" in src
    # the slice rule at the buckets the ideal takes
    assert [sdca_mod.slice_cols(n) for n in (2000, 12_400, 16_384)] == [128, 896, 1024]


def test_sdca_one_rank_cluster_order_is_the_tiled_one():
    """With one rank the cluster order is the one-block kernel's, bit for bit."""
    rng = _rng("sdca-one-rank")
    args = ops.make_sdca_problem(rng, g=2, b=96, d=16, n_real=[96, 71], epochs=3)
    assert torch.equal(sdca_cluster_emulated(*args, ranks=1), sdca_tiled_emulated(*args))


def cluster_matvec_columns(n, ex):
    """The columns the cluster kernel's matvec warps sum for one tile row,
    walked as ``cluster_matvec`` walks them: each rank's stages of CH
    columns, lane l the groups l, l + 32, ... of a stage (CPASS of them), a
    group skipped when it lies in [ex, ex + TILE). Returns {lane: [columns in
    the order the lane adds them]} by rank."""
    T, G, C = sdca_mod.TILE, sdca_mod.GROUP, sdca_mod.CLUSTER
    W = sdca_mod.slice_cols(n)
    walk = {}
    for rank in range(C):
        lo = rank * W
        own = max(0, min(lo + W, n) - lo)
        lanes = {lane: [] for lane in range(32)}
        for c in range(-(-own // SDCA_CH)):
            c0 = c * SDCA_CH
            groups = -(-min(SDCA_CH, own - c0) // G)
            for i in range(SDCA_CH // sdca_mod.SLICE_UNIT):
                for lane in range(32):
                    g = c0 // G + lane + 32 * i
                    col = lo + g * G
                    if lane + 32 * i < groups and (col < ex or col >= ex + T):
                        lanes[lane] += [col + q for q in range(G) if col + q < n]
        walk[rank] = lanes
    return walk


@pytest.mark.parametrize("n", [1, 31, 32, 33, 130, 2000, 2048, 12_400, 16_384, 40_001])
def test_sdca_cluster_slices_cover_every_column_once(n):
    """Each column < n in exactly one rank's slice, the slice a whole number
    of lane passes and every tile's 32 columns in one slice; the matvec of
    tile u + 1 sums every column once but tile u's, each lane in column
    order over its groups l, l + 32, ... of the slice."""
    T, C = sdca_mod.TILE, sdca_mod.CLUSTER
    W = sdca_mod.slice_cols(n)
    assert W % sdca_mod.SLICE_UNIT == 0 and C * W >= n and C * (W - sdca_mod.SLICE_UNIT) < n
    owners = [min(C - 1, col // W) for col in range(n)]
    assert all(owners[s] == owners[min(s + T, n) - 1] for s in range(0, n, T))
    for ex in sorted({0, T * ((n - 1) // T // 2), T * ((n - 1) // T)}):
        walk = cluster_matvec_columns(n, ex)
        cols = [c for lanes in walk.values() for seq in lanes.values() for c in seq]
        assert sorted(cols) == [c for c in range(n) if not ex <= c < ex + T]
        for rank, lanes in walk.items():
            for lane, seq in lanes.items():
                assert seq == sorted(seq)
                assert all((c - rank * W) // sdca_mod.GROUP % 32 == lane for c in seq)


def test_sdca_cluster_ring_needs_no_later_phase():
    """The copy warp's schedule (``issue``): in phase p it issues every stage
    k < min(total, (p + 2) S + stages), waiting for stage k - stages to be
    freed. Modelled phase by phase at the ring depths the buckets get, every
    wait is on a stage the matvec warps free in phase p or before (so the
    phase's barrier cannot wait on itself), and run p + 1's stages are all
    issued in phase p or before."""
    for b, S in ((12_416, 4), (16_384, 4), (65_536, 16), (131_072, 32), (2048, 1)):
        stages = sdca_ring_stages(b)
        assert stages >= 1
        runs = 3 * 5
        total, issued = runs * S, 0
        for p in range(-1, runs):
            target = min(total, (p + 2) * S + stages)
            while issued < target:
                if issued >= stages:   # freed when run (issued - stages) // S is summed
                    assert (issued - stages) // S - 1 <= p
                issued += 1
            assert issued >= min(total, (p + 2) * S)
