// GQA flash attention with online softmax for Hopper (sm_90a), float32:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] / sqrt(hd)) v[b, j, h / rep]
// over the keys j that the causal (j <= i) and sliding-window (j > i - window)
// masks leave, with rep = H / K query heads per KV head. bfloat16 and float16
// inputs go to flash_attention_tc.cu (tensor cores); this kernel serves
// float32, where the tensor cores have no full-precision product, and the
// wrapper's fp32 copies of mixed-type or float64 inputs (the reference casts
// each of q, k and v to fp32 itself).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU). The
// TPU kernel pads q, k and v to 128-row tiles, transposes them to (B, H, S, hd)
// and walks a (B, H, q tile, kv tile) grid whose innermost, sequential kv
// dimension carries the running max, sum and (bq, hd) accumulator in VMEM
// scratch. CUDA blocks run in parallel and in no order, so here the kv loop
// moves inside the block:
//
//   one block per (query tile of 64 rows, query head, batch), folded into one
//   grid dimension (query tiles fastest) so that any B and H take one launch;
//   256 threads as 16 x 16: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the
//   tile; the q tile and, per step, one 64-key K and V tile are read in place
//   from the (B, S, heads, hd) layout (no transpose, no padded copy) and
//   staged in shared memory;
//   S = q k^T: each thread computes a 4 x 4 block (its rows, keys tx + 16 c)
//   with fp32 FMAs; each row's max and sum are reduced over the 16 threads
//   that share the row with warp shuffles and kept, redundantly, by all 16;
//   P goes through shared memory and each thread adds P V into its slice of
//   the (64, hd) accumulator (its 4 rows, columns tx + 16 j) in registers.
//
// Head dims: built for the padded widths HD 16, 32, 64, 96, 128, 192 and
// 256, each twice (for a call whose hd is the width, with the head dim and
// strides compile-time constants, and for every other hd up to it); a
// call's hd is rounded up to the next one, the tiles' columns from hd
// up to HD are zero-filled (they add exact zeros to q k^T), and only the hd
// real columns of o are written. Loads are 4-byte, so any hd and any
// alignment of a row start work. Past hd 256 the chunked kernel below splits
// hd over a cluster of CTAs (flash_chunked.cuh): each stages its 256-column
// slice of q once and its slice of K and V by cp.async, sums its part of
// q k^T, and the cluster adds the parts in rank order, so S is computed once
// a (query tile, kv tile).
//
// Statistics, P and the accumulator are fp32 (the TPU kernel casts its tiles
// to fp32 before both products, so P stays fp32 for PV); the output is
// acc / max(l, 1e-20). Masked scores are NEG_INF = -1e9, as in the
// reference, not -inf: exp(-inf - (-inf)) would be NaN.
//
// Keys at or past Skv are masked by length on every call, whatever causal and
// window say, with -inf so they never count (the TPU kernel relies on the
// causal test to mask its padded keys and so attends to them when it runs
// non-causal with a window). The kv loop starts at the window's first tile and
// stops at the causal frontier of the tile's last row: a fully masked tile
// seen before a row's first valid key adds p = exp(0) = 1 junk that the next
// valid tile's corr = exp(-1e9 - m) = 0 wipes exactly, and one seen after adds
// p = 0. A row with no valid key at all (possible only when a window leaves
// every key behind it, Sq > Skv) gets the reference's answer, the mean of v
// over all Skv keys, because such a block walks every tile.
//
// Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32, K 8,
// hd 64, causal) in fp32 the work is 68.75 GFLOP: 1.03 ms at 67 TFLOP/s
// outside the tensor cores. Its inner loops read shared memory once per two
// FMAs, so they run below even that. The chunked kernel's inner loops read
// 16 bytes per 10.7 FMAs in q k^T and per 16 in P V; at hd 512 (B 1, S 2048,
// H 8, causal: 0.513 ms) its phases' barriers and the cluster exchange keep
// the FMA pipe below half busy (PERF.md).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_chunked.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16: 4 rows x 4 keys of S, 4 rows x hd/16 of o each
constexpr int CW = 256;       // the chunked kernel's staged slice of q, k, v and o, in columns
constexpr int CBK = 32;       // the chunked kernel's keys a step
constexpr int GROUPS = 4;     // its warp pairs, each summing 64 of a slice's columns of q k^T
constexpr int CLD = CW + 4;   // its row stride of the q, K and V tiles
constexpr int TLD = BQ + 4;   // its row stride of P^T
constexpr int PLD = BK + 1;   // padded row stride of P
constexpr float NEG_INF = -1e9f;

template <int HD>
constexpr int smem_floats() {
  // Qs [BQ][HD + 1], Ks [BK][HD + 1], Vs [BK][HD], Ps [BQ][BK + 1]
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

// The kv tiles [t_lo, t_hi) of TBK keys a query tile walks; keyless: a row
// of it has no valid key (then it walks every tile)
template <int TBK = BK>
__device__ __forceinline__ void tile_range(int q0, int Sq, int Skv, int causal, int window,
                                           int& t_lo, int& t_hi) {
  const int q_last = min(q0 + BQ, Sq) - 1;  // the tile's last real row
  t_lo = 0;
  t_hi = (Skv + TBK - 1) / TBK;
  const bool keyless_row = window > 0 && q_last - window + 1 >= Skv;
  if (!keyless_row) {
    if (causal) t_hi = min(t_hi, q_last / TBK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / TBK;
  }
}

// s[i][c] += q k^T over W staged columns: this thread's rows 4 ty + i, keys tx + 16 c
template <int W, int LD>
__device__ __forceinline__ void qk(float (&s)[4][4], const float* Qs, const float* Ks, int ty,
                                   int tx) {
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
  }
}

// One kv tile's scores into the rows' statistics: scale and mask, the
// online softmax, P into shared memory, the accumulator rescaled
template <int CPT>
__device__ __forceinline__ void softmax_tile(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                             float (&acc)[4][CPT], float* Ps, int q0, int k0,
                                             int Skv, int causal, int window, float scale,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    float mx = m[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      float val = s[i][c] * scale;
      if (kp >= Skv) val = -INFINITY;
      else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) val = NEG_INF;
      s[i][c] = val;
      mx = fmaxf(mx, val);
    }
    // the 16 threads of a row are lanes that differ in their low four bits
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float corr = expf(m[i] - mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = expf(s[i][c] - mx);
      Ps[(ty * 4 + i) * PLD + tx + 16 * c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = corr * l[i] + sum;
    m[i] = mx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
  }
}

// acc += P V over the tile's 64 keys; Vs rows of VLD floats, this thread's
// columns tx + 16 j
template <int CPT, int VLD>
__device__ __forceinline__ void pv(float (&acc)[4][CPT], const float* Ps, const float* Vs, int ty,
                                   int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p4[i] = Ps[(ty * 4 + i) * PLD + kk];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float vv = Vs[kk * VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p4[i], vv, acc[i][j]);
    }
  }
}

// this thread's rows of o: acc / max(l, 1e-20) at columns c0 + tx + 16 j below hd
template <int CPT>
__device__ __forceinline__ void store_rows(const float (&acc)[4][CPT], const float (&l)[4],
                                           float* oh, int64_t qstride, int q0, int Sq, int c0,
                                           int hd, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* row = oh + qp * qstride;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (c0 + tx + 16 * j < hd) row[c0 + tx + 16 * j] = acc[i][j] / den;
  }
}

// EXACT: the call's hd is HD, so the head dim and the strides are
// compile-time constants (the width's other calls take its general
// instantiation, with hd at run time)
template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H, int Kh,
             int hd_arg, int nq, int causal, int window, float scale) {
  const int hd = EXACT ? HD : hd_arg;
  constexpr int LD = HD + 1;   // padded row stride of the q and K tiles
  constexpr int CPT = HD / 16; // accumulator columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;

  // (query tile, head, batch) with query tiles fastest; the causal tiles
  // furthest down the sequence do the most work: start them first
  const int qi = nq - 1 - static_cast<int>(blockIdx.x % nq);
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD, qp = q0 + r;
    const int64_t off = ((int64_t)b * Sq + qp) * qstride + (int64_t)h * hd + c;
    Qs[r * LD + c] = qp < Sq && c < hd ? q[off] : 0.f;
  }

  int t_lo, t_hi;
  tile_range(q0, Sq, Skv, causal, window, t_lo, t_hi);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P reads are done (and Qs is staged)
    // one offset for k and v from the kernel's own pointers: per-head base
    // pointers made this loop 156 SASS instructions for four of its
    // iterations at HD 64, not 138, and the kernel 2-3 % slower
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD, kp = k0 + r;
      const bool valid = kp < Skv && c < hd;
      const int64_t off = ((int64_t)b * Skv + kp) * kvstride + (int64_t)kvh * hd + c;
      Ks[r * LD + c] = valid ? k[off] : 0.f;
      Vs[r * HD + c] = valid ? v[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    qk<HD, LD>(s, Qs, Ks, ty, tx);
    softmax_tile<CPT>(s, m, l, acc, Ps, q0, k0, Skv, causal, window, scale, ty, tx);
    __syncthreads();
    pv<CPT, HD>(acc, Ps, Vs, ty, tx);
  }
  store_rows<CPT>(acc, l, o + (int64_t)b * Sq * qstride + (int64_t)h * hd, qstride, q0, Sq, 0,
                  hd, ty, tx);
}

// ---- the chunked kernel, past hd 256 ----

constexpr int chunked_smem_floats() {
  // Qs [BQ][CLD], Ks [2][CBK][CLD], Vs [CBK][CLD], Xs [GROUPS][8][64][4], Pt [CBK][TLD], Rs [BQ]
  return BQ * CLD + 3 * CBK * CLD + GROUPS * BQ * CBK + CBK * TLD + BQ;
}

// BYTES (16 or 4) from global to shared memory, zero-filled when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = flash_chunked::smem_u32(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + ROWS - 1 of one head's columns from `head` on into a
// [ROWS][CLD] tile of CW columns: columns from `cols` on and rows at or past
// S are zero-filled. 16-byte copies where V16 (hd % 4 == 0 and 16-byte
// bases, so every row start is one: the main path), else 4-byte ones.
template <int ROWS, bool V16>
__device__ __forceinline__ void load_slice(float* dst, const float* head, int64_t row_stride,
                                           int r0, int S, int cols, int tid) {
  constexpr int E = V16 ? 4 : 1, CPR = CW / E;  // floats a copy, copies a row
  // not unrolled: unrolled, the per-copy offsets stay live across the kv loop and spill
#pragma unroll 1
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * E, pos = r0 + r;
    const bool valid = pos < S && c < cols;
    cp_async<4 * E>(dst + r * CLD + c, head + (valid ? pos * row_stride + c : 0), valid);
  }
}

// s[i][c] += q k^T over warp pair g's 64 columns of the staged slice, for
// rows ry + 8 i and keys kx + 8 c, columns ascending: each step reads 8 rows
// and 4 keys of 4 columns (float4, conflict-free: a warp's 4 rows and 8 keys
// fall on distinct 16-byte bank groups) for 128 FMAs
__device__ __forceinline__ void qk_slice(float (&s)[8][4], const float* Qs, const float* Kt, int g,
                                         int ry, int kx) {
  const float* qb = Qs + ry * CLD + 64 * g;
  const float* kb = Kt + kx * CLD + 64 * g;
#pragma unroll 4
  for (int d = 0; d < 64; d += 4) {
    float4 qv[8], kv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = *reinterpret_cast<const float4*>(qb + 8 * i * CLD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(kb + 8 * c * CLD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
        s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
        s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
        s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
      }
  }
}

// Past hd 256: one cluster of nc CTAs per (query tile of 64 rows, O group,
// head, batch), the four folded into one grid dimension of clusters
// (flash_chunked.cuh has the plan). CTA r stages its slice of q once (past
// hd 2,048 one 256-column sub-chunk a step), and per step a 32-key tile of
// its slice of K (two buffers: the next step's copy flies during this one)
// and, on a kv tile's last step, of V's columns that its O group holds (one
// buffer, copied during the step's q k^T). Three phases a tile, each with
// its own thread layout:
//   q k^T: warp pair g (threads 64 g ..) sums columns 64 g .. 64 g + 63 of
//   the slice, thread u an 8 x 4 tile (rows ry + 8 i, keys kx + 8 c), and
//   stores it in Xs;
//   S: after the cluster barrier thread (g, u) reads rows 2 g and 2 g + 1
//   of that tile from every warp pair of every CTA (ld.shared::cluster) and
//   adds the nc x GROUPS parts in rank order, then group order, so all nc
//   CTAs hold the same S; the online softmax as in the one-pass kernel
//   (expf on the scaled, masked scores; a row's 8 owners reduce its max and
//   sum with shuffles), P^T and each row's correction into shared memory;
//   P V: warp w holds rows 8 w .. 8 w + 7 and lane the columns 4 lane and
//   128 + 4 lane (+3) of the slice: per key two float4 reads of P^T (a
//   broadcast) and two of V for 64 FMAs.
// Xs is written again only after every CTA has read it (cluster_done after
// the softmax, cluster_wait before the next write), and once more before
// the exit.
template <bool V16>
__global__ void __launch_bounds__(THREADS, 1)
flash_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                     int Kh, int hd, int nq, int nc, int ss, int nsub, int causal, int window,
                     float scale) {
  namespace fc = flash_chunked;
  extern __shared__ __align__(16) float csm[];
  float* Qs = csm;                                               // [BQ][CLD]
  float* Ks = Qs + BQ * CLD;                                     // [2][CBK][CLD]
  float* Vs = Ks + 2 * CBK * CLD;                                // [CBK][CLD]
  float4* Xs = reinterpret_cast<float4*>(Vs + CBK * CLD);        // [GROUPS][8][64]
  float* Pt = reinterpret_cast<float*>(Xs + GROUPS * 8 * 64);    // [CBK][TLD]
  float* Rs = Pt + CBK * TLD;                                    // [BQ]

  const int rank = static_cast<int>(fc::cluster_rank());
  const int cid = static_cast<int>(blockIdx.x) / nc;
  const int qi = nq - 1 - cid % nq;  // the heaviest causal tiles first
  int rest = cid / nq;
  const int grp = rest % nsub;
  rest /= nsub;
  const int h = rest % H, b = rest / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x;
  const int g = tid / 64, u = tid % 64, ry = u / 8, kx = u % 8;
  const int warp = tid / 32, lane = tid % 32;
  // this CTA's slice of hd, and its O group's columns (none in a short last slice)
  const int sc0 = rank * ss, se = min(sc0 + ss, hd);
  const int oc0 = sc0 + grp * CW, oce = min(oc0 + CW, se);

  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;
  const float* qh = q + (int64_t)b * Sq * qstride + (int64_t)h * hd;
  const float* kh = k + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;
  const float* vh = v + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;

  int t_lo, t_hi;
  tile_range<CBK>(q0, Sq, Skv, causal, window, t_lo, t_hi);
  const int nsteps = (t_hi - t_lo) * nsub;

  load_slice<BQ, V16>(Qs, qh + sc0, qstride, q0, Sq, min(CW, se - sc0), tid);
  load_slice<CBK, V16>(Ks, kh + sc0, kvstride, t_lo * CBK, Skv, min(CW, se - sc0), tid);
  cp_async_commit();

  float m[2], l[2], acc[8][8], s[8][4];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    m[ii] = NEG_INF;
    l[ii] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int t = t_lo + it / nsub, j = it % nsub, k0 = t * CBK;
    const bool last = j == nsub - 1, more = it + 1 < nsteps;
    cp_async_wait<0>();  // step it's K (and, first, q) has landed
    __syncthreads();     // ... for every thread; and every thread is done with step it - 1
    if (nsub > 1 && it > 0) {  // q's sub-chunk j, in place of the last step's
      const int c = sc0 + j * CW;
      load_slice<BQ, V16>(Qs, qh + (c < hd ? c : 0), qstride, q0, Sq, min(CW, se - c), tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (last) {
      load_slice<CBK, V16>(Vs, vh + (oc0 < hd ? oc0 : 0), kvstride, k0, Skv, oce - oc0, tid);
      cp_async_commit();
    }
    // the next step's K, after the publishing fence (a GPU-scope membar
    // waits for every copy in flight)
    auto prefetch = [&]() {
      if (!more) return;
      const int t1 = t_lo + (it + 1) / nsub, c1 = sc0 + (it + 1) % nsub * CW;
      load_slice<CBK, V16>(Ks + ((it + 1) & 1) * CBK * CLD, kh + (c1 < hd ? c1 : 0), kvstride,
                           t1 * CBK, Skv, min(CW, se - c1), tid);
      cp_async_commit();
    };
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    }
    qk_slice(s, Qs, Ks + (it & 1) * CBK * CLD, g, ry, kx);
    if (!last) {
      prefetch();
      continue;
    }

    if (it >= nsub) fc::cluster_wait();  // every CTA has read the last tile's parts
#pragma unroll
    for (int i = 0; i < 8; ++i)
      Xs[(g * 8 + i) * 64 + u] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    fc::cluster_publish();
    prefetch();
    fc::cluster_wait();  // every CTA's parts of this tile are in its Xs
    // rows 2 g + ii of the tile: group gg's part at Xs[gg][2 g + ii][u]; the
    // nc x GROUPS parts in rank order, then group order, one batch of loads
    // a CTA (this one's from its own shared memory)
    float4 tot[2];
    const float4* mine = Xs + 2 * g * 64 + u;
    const uint32_t at = fc::smem_u32(mine);
    for (int rr = 0; rr < nc; ++rr) {
      float4 part[2][GROUPS];
      if (rr == rank) {
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int gg = 0; gg < GROUPS; ++gg) part[ii][gg] = mine[(gg * 8 + ii) * 64];
      } else {
        const uint32_t base = fc::map_rank(at, rr);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int gg = 0; gg < GROUPS; ++gg)
            part[ii][gg] = fc::ld_cluster(base + (gg * 8 + ii) * 64 * 16);
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int gg = 0; gg < GROUPS; ++gg) {
          if (rr == 0 && gg == 0) tot[ii] = part[ii][gg];
          else fc::add4(tot[ii], part[ii][gg]);
        }
    }
    float sv[2][4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      sv[ii][0] = tot[ii].x;
      sv[ii][1] = tot[ii].y;
      sv[ii][2] = tot[ii].z;
      sv[ii][3] = tot[ii].w;
    }

#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int row = ry + 8 * (2 * g + ii), qp = q0 + row;
      float mx = m[ii];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + kx + 8 * c;
        float val = sv[ii][c] * scale;
        if (kp >= Skv) val = -INFINITY;
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) val = NEG_INF;
        sv[ii][c] = val;
        mx = fmaxf(mx, val);
      }
      // the 8 threads of a row are lanes that differ in their low three bits
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[ii] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sv[ii][c] - mx);
        Pt[(kx + 8 * c) * TLD + row] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[ii] = corr * l[ii] + sum;
      m[ii] = mx;
      if (kx == 0) Rs[row] = corr;
    }
    fc::cluster_done();  // the parts read went into P^T's stores (ordered before it)
    if (more) cp_async_wait<1>();  // V has landed (the next step's K may still fly)
    else cp_async_wait<0>();
    __syncthreads();  // ... for every thread, with P^T and the corrections

    const float4 ca = *reinterpret_cast<const float4*>(Rs + 8 * warp);
    const float4 cb = *reinterpret_cast<const float4*>(Rs + 8 * warp + 4);
    const float cr[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= cr[i];
#pragma unroll 8
    for (int kk = 0; kk < CBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + kk * TLD + 8 * warp);
      const float4 pb = *reinterpret_cast<const float4*>(Pt + kk * TLD + 8 * warp + 4);
      const float4 va = *reinterpret_cast<const float4*>(Vs + kk * CLD + 4 * lane);
      const float4 vb = *reinterpret_cast<const float4*>(Vs + kk * CLD + 128 + 4 * lane);
      const float p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p[i], vv[e], acc[i][e]);
    }
  }
  fc::cluster_wait();  // no CTA reads this one's Xs any more

  __syncthreads();  // every P V read of Rs is done: it takes the rows' l
  if (kx == 0) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) Rs[ry + 8 * (2 * g + ii)] = l[ii];
  }
  __syncthreads();
  float* oh = o + (int64_t)b * Sq * qstride + (int64_t)h * hd;
  const bool v4 = (hd & 3) == 0 && (reinterpret_cast<uintptr_t>(o) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * warp + i, qp = q0 + row;
    if (qp >= Sq) continue;
    const float den = fmaxf(Rs[row], 1e-20f);
    float* orow = oh + qp * qstride;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = oc0 + 4 * lane + 128 * jj;
      const float r[4] = {acc[i][4 * jj] / den, acc[i][4 * jj + 1] / den,
                          acc[i][4 * jj + 2] / den, acc[i][4 * jj + 3] / den};
      if (v4 && c + 3 < oce) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < oce) orow[c + e] = r[e];
      }
    }
  }
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD, bool EXACT>
int launch_hd(const float* q, const float* k, const float* v, float* o, int B, int Sq, int Skv,
              int H, int Kh, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<HD>();
  const int err = set_smem(flash_kernel<HD, EXACT>, smem);
  if (err != 0) return err;
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)nq * H * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<HD, EXACT><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, o, Sq, Skv, H, Kh, hd, nq, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool V16>
int launch_chunked_v(const float* q, const float* k, const float* v, float* o, int B, int Sq,
                     int Skv, int H, int Kh, int hd, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * chunked_smem_floats();
  const int err = set_smem(flash_chunked_kernel<V16>, smem);
  if (err != 0) return err;
  const flash_chunked::Plan p = flash_chunked::plan(hd, CW);
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)nq * p.nsub * H * B * p.nc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_chunked::ClusterLaunch launch(static_cast<unsigned>(blocks), THREADS, p.nc, smem, stream);
  const cudaError_t rc =
      cudaLaunchKernelEx(&launch.cfg, flash_chunked_kernel<V16>, q, k, v, o, Sq, Skv, H, Kh, hd,
                         nq, p.nc, p.ss, p.nsub, causal, window, scale);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies where hd % 4 == 0 and q, k and v start on 16-byte boundaries
int launch_chunked(const float* q, const float* k, const float* v, float* o, int B, int Sq,
                   int Skv, int H, int Kh, int hd, int causal, int window, float scale,
                   cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (hd % 4 == 0 && addr % 16 == 0)
    return launch_chunked_v<true>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,
                                  stream);
  return launch_chunked_v<false>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,
                                 stream);
}

}  // namespace

// q, k, v and o float32, (B, S, heads, hd) and contiguous; hd's columns
// from the next of the instantiated widths, or the chunked kernel past 256
extern "C" int flash_attention_launch(const float* q, const float* k, const float* v, float* o,
                                      int B, int Sq, int Skv, int H, int Kh, int hd,
                                      int causal, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || Kh < 1 || H % Kh != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_WIDTH(W)                                                                     \
  if (hd == W)                                                                             \
    return launch_hd<W, true>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);  \
  if (hd < W)                                                                              \
    return launch_hd<W, false>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);
  FLASH_WIDTH(16)
  FLASH_WIDTH(32)
  FLASH_WIDTH(64)
  FLASH_WIDTH(96)
  FLASH_WIDTH(128)
  FLASH_WIDTH(192)
  FLASH_WIDTH(256)
#undef FLASH_WIDTH
  return launch_chunked(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);
}
