// Fused ensemble scoring for Hopper (sm_90a):
//   out[q] = (1/k) sum_t sum_j coef[t,j] * exp(-gamma_t * max(|x_q|^2 + |s_tj|^2 - 2 x_q.s_tj, 0))
//
// Replaces two TPU kernels of the reference package:
//   repro/kernels/ensemble_score.py::ensemble_score_pallas        (fp32 supports)
//   repro/kernels/ensemble_score_q8.py::ensemble_score_q8_pallas  (int8 supports,
//       s_tj = q[t,j] * scale[t] + zero[t], per member and column)
// Both run one template over the support loader (supports.cuh); the packed
// int8 ensemble stays int8 in device memory (a quarter of the bytes) and is
// dequantised in shared memory.
//
// The TPU kernel walks (query tile, member, support tile) as a sequential
// grid and adds each partial into a VMEM scratch accumulator. CUDA blocks run
// in parallel and in no order, so the work is split in two passes, no atomics:
//
//   1. norms_kernel: |s_tj|^2 once per support (of the dequantised value for
//      int8) into a (k, n_max) buffer.
//   2. partials_kernel: grid (query tile of 128, split). The work items are
//      the (member, 64-support tile) pairs, member-major; split s walks items
//      s * per_split .. (s + 1) * per_split - 1. The plan (per_split, splits)
//      comes from (k, n_max) alone, never from b
//      (kernels/ensemble_score.py::split_plan), and every query row takes the
//      same arithmetic in whatever block it lands, so a row's score is
//      bit-identical whatever b or chunk it is scored in. At b <= 128 the
//      plan's up to 264 splits are the whole grid: two blocks on each of the
//      132 SMs. Each block writes one fp32 partial per query and split.
//   3. mean_kernel: sums a query's partials in split order and divides by k.
//
// partials_kernel, per block: 256 threads as 16 support groups x 16 query
// lanes; thread (group, lane) owns queries lane + 16 i (i < 8) and supports
// 4 group .. 4 group + 3 of each item, an 8 x 4 register tile read from
// shared memory as float4 along the feature dim (3 loads per 32 FMAs; row
// strides are an odd number of float4s, so the 8 rows a quarter-warp reads
// fall on distinct banks, and the support reads are warp broadcasts). The
// queries' tile and their norms are staged once per block. Then each warp
// walks the items on its own: warp w stages, dequantises and reads only
// rows 8 w .. 8 w + 7 of each support tile (with their coefficients and
// norms), double-buffered by cp.async so the next item loads while this
// one computes, and synchronises with __syncwarp alone: no block barrier
// per item, so the warps drift apart and one warp's exp phase (MUFU-bound)
// overlaps another's FMAs. A warp whose rows are all past n_max skips the
// item (n_max = 230 pads to 232, not 256). At d = 32 (the round's) the
// copies are 16 bytes: fp32 rows straight into the padded tile; int8 rows
// plus the member's scale and zero rows into the warp's raw buffer, which
// it dequantises with the plain version's __fmul_rn / __fadd_rn rounding.
// Any other d takes a general instantiation: 4-byte copies for fp32, loads
// through the loader for int8. The cross product stays on fp32 FMAs: TF32
// would wreck the |x|^2 + |s|^2 - 2 x.s cancellation. The RBF is
// ex2.approx of -gamma log2(e) d2. Padded supports carry zero coefficients
// (a padded int8 row dequantises to its zero point: finite, and
// annihilated); rows past n_max are staged as zeros; padded query rows are
// computed and never stored.
//
// Feature dims whose tiles outgrow shared memory (smem_bytes(d) > 227 KB, d >
// 220) take partials_chunked_kernel, one more template over the loader,
// with the same grid, split plan and sums. query_norms_kernel first chains
// the queries' |x_q|^2 once a call (coalesced, norms_kernel's chains). Then one
// block of 256 threads an SM walks its split's items two at a time (an odd
// last one alone), each pair's features in chunks of DC = 64: a thread owns
// queries lane + 16 i (i < 8) and supports 4 group .. 4 group + 3 of BOTH
// items, an 8 x (4 + 4) register tile, so a query float4 read from shared
// memory feeds 32 FMAs (16 loads per 256 FMAs) and a staged queries' chunk
// feeds 128 supports. A step's chunks go through a ring of STAGES = 3
// slots by cp.async, two steps ahead, so a step waits for copies committed
// two steps before (cp.async.wait_group 1) behind one block barrier: 16-byte
// copies where d % 4 == 0 and every base is 16-byte aligned (the wrapper's
// tensors always are), 4-byte ones else. int8 rings the raw chunks and the
// members' scale and zero chunks (16-byte copies where d % 16 == 0, 4-byte
// where d % 4 == 0, byte loads else), one step further ahead, and each step
// dequantises the next step's chunks into one of two fp32 tiles with the
// plain version's rounding (a byte to its float by PRMT and FADD, exact,
// not the quarter-rate I2F). An item's coefficients, norms and gamma are
// loaded before its last chunk's FMAs, its exp after them, item A's terms
// before item B's. A warp whose rows of an item are all past n_max skips
// that item, as in the staged kernel. Each chain runs over the same
// features in the same order, and each thread adds its items' terms in the
// same order, as in the staged kernel, so the two give the same bits
// wherever both run. The cross term stays on fp32 FMAs: a tensor-core
// product would change the bits. At b 8192, k 282, n 230, d 784 it runs at
// about half the FMA peak with the clock at its top: 254 registers leave
// two warps a scheduler, and 16 warps an SM (128 registers, 32-feature
// steps, or 4 x (4 + 4) tiles of 512 threads) spilled and ran slower.
//
// Bound on the H100: fp32 operations, about 2d + 8 per query-support pair:
// 5.71 ms at b 8192, k 2821, n_max 230, d 32 (67 TFLOP/s). The fp32 ensemble
// there is 2821 x 230 x 32 x 4 B = 83 MB, more than the 50 MB L2, so each
// query tile reads it from device memory: 64 tiles x 83 MB over 3.35 TB/s is
// 1.6 ms, under the arithmetic; int8 reads a quarter of that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "supports.cuh"

namespace {

constexpr int BQ = 128;              // queries per block
constexpr int TS = 4;                // supports per thread
constexpr int EN = 16 * TS;          // supports per work item: one tile of one member
constexpr int THREADS = 256;         // 16 support groups x 16 query lanes
constexpr int WARPS = THREADS / 32;  // warp w owns support groups 2 w and 2 w + 1 ...
constexpr int WROWS = 2 * TS;        // ... so rows WROWS w .. WROWS w + 7 of every tile
constexpr int TQ = BQ / 16;          // queries per thread
constexpr int FAST_D = 32;           // the feature dim with 16-byte staging
constexpr int RED_LD = 17;           // row stride of the final per-query sums
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DC = 64;               // features a step of the chunked kernel stages
constexpr int CLD = DC + 4;          // its tiles' row stride: 17 float4s, odd
constexpr int STAGES = 3;            // its ring of staged steps
constexpr int PAIR = 2 * EN;         // supports a step of it covers: two items
// int8 bytes a step rings: the two items' raw chunks, then each item's scale
// and zero chunks
constexpr int RAW_STEP = PAIR * DC + 2 * 2 * DC * 4;
constexpr int NORM_ROWS = 64;        // rows a block of query_norms_kernel chains, one a thread
constexpr int NORM_DC = 32;          // features it stages at a time, a warp a row
constexpr int MAX_SMEM = 232448;     // shared memory a block may take (227 KB)

// d rounded up to a float4
__host__ __device__ constexpr int padded(int d) { return (d + 3) / 4 * 4; }
// row stride (floats) of the staged tiles: an odd number of float4s
__host__ __device__ constexpr int row_stride(int d) {
  return (padded(d) / 4) % 2 ? padded(d) : padded(d) + 4;
}
// int8 raw staging of one warp and buffer at FAST_D: its rows, then the
// member's scale and zero rows
constexpr int RAW_WARP = WROWS * FAST_D + 2 * FAST_D * 4;

__host__ __device__ constexpr int support_floats(int d) {
  return 2 * EN * row_stride(d) > BQ * RED_LD ? 2 * EN * row_stride(d) : BQ * RED_LD;
}

int smem_bytes(int d) {
  const int floats = BQ * row_stride(d) + support_floats(d) + 4 * EN;
  return 4 * floats + (d == FAST_D ? 2 * WARPS * RAW_WARP : 0);
}

// the chunked kernel: a ring of STAGES queries' chunks (the first reused as
// the [BQ][RED_LD] group sums); fp32, a ring of STAGES two items' chunks;
// int8, two dequantised two items' chunks and a ring of STAGES raw steps;
// the queries' norms
template <bool INT8>
constexpr int chunked_smem_bytes() {
  return INT8 ? 4 * (STAGES * BQ * CLD + 2 * PAIR * CLD + BQ) + STAGES * RAW_STEP
              : 4 * (STAGES * (BQ + PAIR) * CLD + BQ);
}
static_assert(BQ * CLD >= BQ * RED_LD, "group sums fit a queries' chunk");
static_assert(chunked_smem_bytes<false>() <= MAX_SMEM && chunked_smem_bytes<true>() <= MAX_SMEM,
              "the chunked kernel fits a block");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// global -> shared copies, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x for the RBF's argument -gamma log2(e) d2 <= 0 (relative error ~2^-22;
// results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's rows r0 .. r0 + WROWS - 1 of an item (member t, supports j0 ..)
// into its tile St; rows at or past `rows` are zero-filled. fp32: straight
// into the tile.
template <int D>
__device__ __forceinline__ void stage_rows(const Fp32Supports& sup, int t, int j0, int rows,
                                           int r0, int n_max, int d, int ld, float* St,
                                           unsigned char*, int lane) {
  const float* s = sup.s + ((int64_t)t * n_max + j0) * d;
  if constexpr (D == FAST_D) {
    for (int i = lane; i < WROWS * D / 4; i += 32) {
      const int r = r0 + i / (D / 4), c = (i % (D / 4)) * 4;
      const bool valid = r < rows;
      cp_async16(St + r * ld + c, s + (valid ? r : 0) * D + c, valid);
    }
  } else {
    const int dp = padded(d);
    for (int i = lane; i < WROWS * dp; i += 32) {
      const int r = r0 + i / dp, c = i % dp;
      const bool valid = r < rows && c < d;
      cp_async4(St + r * ld + c, s + (valid ? r * d + c : 0), valid);
    }
  }
}

// int8: at FAST_D the raw rows and the member's scale and zero rows into the
// warp's raw buffer (one 16-byte copy a lane); at any other d through the
// loader, dequantised as it is stored
template <int D>
__device__ __forceinline__ void stage_rows(const Int8Supports& sup, int t, int j0, int rows,
                                           int r0, int n_max, int d, int ld, float* St,
                                           unsigned char* raw, int lane) {
  if constexpr (D == FAST_D) {
    constexpr int ROW_CHUNKS = WROWS * D / 16, VEC_CHUNKS = D / 4;
    static_assert(ROW_CHUNKS + 2 * VEC_CHUNKS == 32, "one 16-byte copy a lane");
    if (lane < ROW_CHUNKS) {
      const int r = r0 + lane / (D / 16), c = (lane % (D / 16)) * 16;
      const bool valid = r < rows;
      const int8_t* q = sup.q + ((int64_t)t * n_max + j0 + (valid ? r : 0)) * D;
      cp_async16(raw + (r - r0) * D + c, q + c, valid);
    } else {
      const int e = lane - ROW_CHUNKS;
      const float* src = e < VEC_CHUNKS ? sup.scale + (int64_t)t * D + 4 * e
                                        : sup.zero + (int64_t)t * D + 4 * (e - VEC_CHUNKS);
      cp_async16(raw + WROWS * D + 16 * e, src, true);
    }
  } else {
    const Int8Supports m = sup.member(t, n_max, d);
    const int dp = padded(d);
    for (int i = lane; i < WROWS * dp; i += 32) {
      const int r = r0 + i / dp, c = i % dp;
      St[r * ld + c] = r < rows && c < d ? m.at(j0 + r, c, d) : 0.f;
    }
  }
}

// int8 at FAST_D: the warp's raw rows into its rows of the fp32 tile, with
// the plain version's rounding (a rounded multiply, then a rounded add);
// returns whether it wrote, so the caller knows to synchronise the warp
template <int D>
__device__ __forceinline__ bool dequantise(const Fp32Supports&, int, int, float*,
                                           const unsigned char*, int) {
  return false;
}
template <int D>
__device__ __forceinline__ bool dequantise(const Int8Supports&, int r0, int ld, float* St,
                                           const unsigned char* raw, int lane) {
  if constexpr (D != FAST_D) {
    return false;
  } else {
    const float* scale = reinterpret_cast<const float*>(raw + WROWS * D);
    const float* zero = scale + D;
    for (int i = lane; i < WROWS * D / 4; i += 32) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const char4 qv = *reinterpret_cast<const char4*>(raw + r * D + c);
      float4 s;
      s.x = __fadd_rn(__fmul_rn(static_cast<float>(qv.x), scale[c]), zero[c]);
      s.y = __fadd_rn(__fmul_rn(static_cast<float>(qv.y), scale[c + 1]), zero[c + 1]);
      s.z = __fadd_rn(__fmul_rn(static_cast<float>(qv.z), scale[c + 2]), zero[c + 2]);
      s.w = __fadd_rn(__fmul_rn(static_cast<float>(qv.w), scale[c + 3]), zero[c + 3]);
      *reinterpret_cast<float4*>(St + (r0 + r) * ld + c) = s;
    }
    return true;
  }
}

template <class Supports>
__global__ void norms_kernel(const Supports sup, float* __restrict__ norms, int k, int n_max,
                             int d) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= (int64_t)k * n_max) return;
  const int t = static_cast<int>(j / n_max), r = static_cast<int>(j % n_max);
  const Supports m = sup.member(t, n_max, d);
  float s = 0.f;
  for (int c = 0; c < d; ++c) {
    const float v = m.at(r, c, d);
    s = fmaf(v, v, s);
  }
  norms[j] = s;
}

// the chunked kernel's queries' |x_q|^2, once a call: norms_kernel's fmaf
// chain a row in ascending feature order, but a block stages its NORM_ROWS
// rows NORM_DC features at a time, a warp reading NORM_DC consecutive
// features of a row (coalesced), every load of a thread in flight at once,
// and each thread then carries its row's chain over the staged features
__global__ void __launch_bounds__(NORM_ROWS)
query_norms_kernel(const float* __restrict__ x, float* __restrict__ xnorms, int b, int d) {
  constexpr int WARPS_N = NORM_ROWS / 32, PER = NORM_ROWS / WARPS_N;  // rows a warp loads
  __shared__ float tile[NORM_ROWS][NORM_DC + 1];
  const int tid = threadIdx.x, lane = tid % 32, q0 = blockIdx.x * NORM_ROWS;
  float s = 0.f;
  for (int c0 = 0; c0 < d; c0 += NORM_DC) {
    const int c = c0 + lane;
    float v[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int q = q0 + tid / 32 + WARPS_N * m;
      v[m] = q < b && c < d ? __ldg(x + (int64_t)q * d + c) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) tile[tid / 32 + WARPS_N * m][lane] = v[m];
    __syncthreads();
    const int width = min(NORM_DC, d - c0);
    for (int i = 0; i < width; ++i) s = fmaf(tile[tid][i], tile[tid][i], s);
    __syncthreads();
  }
  if (q0 + tid < b) xnorms[q0 + tid] = s;
}

// acc[i][s] += x_i . s_s over features 0 .. width - 1 (a multiple of 4), one
// fmaf chain a pair in ascending feature order: rows lane + 16 i of Xs and
// TS grp .. TS grp + 3 of St, row strides ld (odd float4s: conflict-free);
// UNROLL float4 steps unrolled
template <int UNROLL>
__device__ __forceinline__ void fma_tile(float (&acc)[TQ][TS], const float* Xs, const float* St,
                                         int ld, int width, int lane, int grp) {
#pragma unroll UNROLL
  for (int c = 0; c < width; c += 4) {
    float4 sv[TS];
#pragma unroll
    for (int s = 0; s < TS; ++s)
      sv[s] = *reinterpret_cast<const float4*>(St + (TS * grp + s) * ld + c);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(Xs + (lane + 16 * i) * ld + c);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        acc[i][s] = fmaf(xv.x, sv[s].x, acc[i][s]);
        acc[i][s] = fmaf(xv.y, sv[s].y, acc[i][s]);
        acc[i][s] = fmaf(xv.z, sv[s].z, acc[i][s]);
        acc[i][s] = fmaf(xv.w, sv[s].w, acc[i][s]);
      }
    }
  }
}

// The chunked kernel's FMAs over one chunk of `width` features (a multiple
// of 4): acc += x . s, rows lane + 16 i of Xs against supports TS grp ..
// TS grp + 3 of SA into a and, with TWO, of SB into b, each query float4
// feeding both; one fmaf chain a pair in ascending feature order, row
// stride CLD
template <bool TWO>
__device__ __forceinline__ void fma_chunk(float (&a)[TQ][TS], float (&b)[TQ][TS], const float* Xs,
                                          const float* SA, const float* SB, int width, int lane,
                                          int grp) {
#pragma unroll 4
  for (int c = 0; c < width; c += 4) {
    float4 sa[TS], sb[TS];
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      sa[s] = *reinterpret_cast<const float4*>(SA + (TS * grp + s) * CLD + c);
      if constexpr (TWO) sb[s] = *reinterpret_cast<const float4*>(SB + (TS * grp + s) * CLD + c);
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(Xs + (lane + 16 * i) * CLD + c);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        a[i][s] = fmaf(xv.x, sa[s].x, a[i][s]);
        a[i][s] = fmaf(xv.y, sa[s].y, a[i][s]);
        a[i][s] = fmaf(xv.z, sa[s].z, a[i][s]);
        a[i][s] = fmaf(xv.w, sa[s].w, a[i][s]);
        if constexpr (TWO) {
          b[i][s] = fmaf(xv.x, sb[s].x, b[i][s]);
          b[i][s] = fmaf(xv.y, sb[s].y, b[i][s]);
          b[i][s] = fmaf(xv.z, sb[s].z, b[i][s]);
          b[i][s] = fmaf(xv.w, sb[s].w, b[i][s]);
        }
      }
    }
  }
}

// the 16 support groups of each row, added in group order, into
// partial[split][row]: red is [BQ][RED_LD] of shared memory no thread reads
// any more
__device__ __forceinline__ void write_partial(const float (&sums)[TQ], float* red,
                                              float* partial, int rows, int q0, int split,
                                              int tid, int lane, int grp) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TQ; ++i) red[(lane + 16 * i) * RED_LD + grp] = sums[i];
  __syncthreads();
  if (tid < BQ && q0 + tid < rows) {
    float s = 0.f;
    for (int g = 0; g < 16; ++g) s += red[tid * RED_LD + g];
    partial[(int64_t)split * rows + q0 + tid] = s;
  }
}

template <class Supports, int D>
__global__ void __launch_bounds__(THREADS, 2)
partials_kernel(const float* __restrict__ x, const Supports sup, const float* __restrict__ coef,
                const float* __restrict__ gammas, const float* __restrict__ norms,
                float* __restrict__ partial, int b, int n_max, int d_arg, int tiles,
                int per_split, int items) {
  const int d = D ? D : d_arg;
  const int dp = padded(d), ld = row_stride(d);
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // [BQ][ld]
  float* Ss = Xs + BQ * ld;                      // [2][EN][ld], then [BQ][RED_LD]
  float* cs = Ss + support_floats(d);            // [2][EN] coefficients
  float* ns = cs + 2 * EN;                       // [2][EN] support norms
  unsigned char* raw = reinterpret_cast<unsigned char*>(ns + 2 * EN);  // [2][WARPS][RAW_WARP]

  const int tid = threadIdx.x, lane = tid % 16, grp = tid / 16, warp = tid / 32;
  const int wlane = tid % 32, r0 = WROWS * warp;
  const int q0 = blockIdx.x * BQ;
  const int i0 = blockIdx.y * per_split, i1 = min(i0 + per_split, items);

  // the queries' tile, by all threads, once
  if constexpr (D == FAST_D) {
    for (int i = tid; i < BQ * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool valid = q0 + r < b;
      cp_async16(Xs + r * ld + c, x + (int64_t)(valid ? q0 + r : 0) * D + c, valid);
    }
  } else {
    for (int i = tid; i < BQ * dp; i += THREADS) {
      const int r = i / dp, c = i % dp;
      const bool valid = q0 + r < b && c < d;
      cp_async4(Xs + r * ld + c, x + (valid ? (int64_t)(q0 + r) * d + c : 0), valid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float sx[TQ], accq[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float* xr = Xs + (lane + 16 * i) * ld;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(xr[c], xr[c], s);
    sx[i] = s;
    accq[i] = 0.f;
  }

  // From here each warp walks the items on its own: it stages, dequantises
  // and reads only its own rows of each tile (and their coefficients and
  // norms), so it synchronises with __syncwarp alone, and the warps' exp
  // phases interleave with each other's FMAs.
  auto rows_of = [&](int it, int& t, int& j0) {
    t = it / tiles;
    j0 = (it - t * tiles) * EN;
    return min(EN, n_max - j0);
  };
  auto stage_item = [&](int it, int buf) {
    int t, j0;
    const int rows = rows_of(it, t, j0);
    if (r0 >= rows) return;  // every row of this warp is padding: nothing to stage
    stage_rows<D>(sup, t, j0, rows, r0, n_max, d, ld, Ss + buf * EN * ld,
                  raw + (buf * WARPS + warp) * RAW_WARP, wlane);
    if (wlane < 2 * WROWS) {
      const int r = r0 + wlane % WROWS;
      const bool valid = r < rows;
      const int64_t off = (int64_t)t * n_max + j0 + (valid ? r : 0);
      if (wlane < WROWS) cp_async4(cs + buf * EN + r, coef + off, valid);
      else cp_async4(ns + buf * EN + r, norms + off, valid);
    }
  };

  if (i0 < i1) stage_item(i0, 0);
  cp_async_commit();
  for (int it = i0; it < i1; ++it) {
    const int buf = (it - i0) & 1;
    if (it + 1 < i1) stage_item(it + 1, buf ^ 1);  // the warp freed that buffer last step
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    int t, j0;
    if (r0 < rows_of(it, t, j0)) {
      float* St = Ss + buf * EN * ld;
      if (dequantise<D>(sup, r0, ld, St, raw + (buf * WARPS + warp) * RAW_WARP, wlane))
        __syncwarp();
      const float gl = -__ldg(gammas + t) * LOG2E;
      float acc[TQ][TS];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int s = 0; s < TS; ++s) acc[i][s] = 0.f;
      fma_tile<8>(acc, Xs, St, ld, dp, lane, grp);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const float cj = cs[buf * EN + TS * grp + s], nj = ns[buf * EN + TS * grp + s];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float d2 = fmaxf(sx[i] + nj - 2.f * acc[i][s], 0.f);
          accq[i] = fmaf(cj, ex2(gl * d2), accq[i]);
        }
      }
    }
    __syncwarp();  // the warp is done with this buffer before it is refilled
  }

  write_partial(accq, Ss, partial, b, q0, blockIdx.y, tid, lane, grp);
}

// byte `sel & 3` of u (an int8 + 128) as the int8's float: __byte_perm puts
// it under 2^23's exponent (0x4B0000xx), then 2^23 + 128 comes off, exactly
__device__ __forceinline__ float byte_float(uint32_t u, uint32_t sel) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

// A work item of the chunked kernel: its member, first support and real
// rows (0: past the split)
struct Item {
  int t, j0, rows;
};
// rows of an item that warps read: its real ones, then zeros up to the last
// warp that has real ones (the rest are neither staged nor read)
__device__ __forceinline__ int live_rows(int rows) { return (rows + WROWS - 1) / WROWS * WROWS; }

// Any d (see the header): the split's items in pairs, an odd last one alone,
// and each pair's feature chunks in order; step u = (pair u / chunks, chunk
// u % chunks). Ring slot u % STAGES holds step u's queries' chunk and, fp32,
// its two items' chunks; int8 rings the raw chunks one step further ahead
// and dequantises step u + 1's during step u, into tile (u + 1) & 1. The
// copies committed in step s are step s + 2's (int8: its queries' chunk and
// step s + 3's raw chunks), so cp.async.wait_group<STAGES - 2> at the top of
// step s waits for the copies committed two steps before, no later ones.
// Thread (grp, lane) owns queries lane + 16 i and supports TS grp .. TS grp
// + 3 of both items, as partials_kernel's threads own one item's.
template <class Supports, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
partials_chunked_kernel(const float* __restrict__ x, const Supports sup,
                        const float* __restrict__ coef, const float* __restrict__ gammas,
                        const float* __restrict__ norms, const float* __restrict__ xnorms,
                        float* __restrict__ partial, int b, int n_max, int d, int tiles,
                        int per_split, int items) {
  constexpr bool INT8 = Supports::INT8;
  constexpr int F4 = DC / 4;  // float4s of a row's chunk
  extern __shared__ float4 smem4[];
  float* Xr = reinterpret_cast<float*>(smem4);  // [STAGES][BQ][CLD] the queries' chunks
  float* Sr = Xr + STAGES * BQ * CLD;           // [STAGES (int8: 2)][PAIR][CLD] the items'
  float* sxs = Sr + (INT8 ? 2 : STAGES) * PAIR * CLD;               // [BQ] queries' norms
  unsigned char* raw = reinterpret_cast<unsigned char*>(sxs + BQ);  // int8: [STAGES][RAW_STEP]

  const int tid = threadIdx.x, lane = tid % 16, grp = tid / 16, r0 = WROWS * (tid / 32);
  const int q0 = blockIdx.x * BQ;
  const int i0 = blockIdx.y * per_split, i1 = min(i0 + per_split, items);
  const int dp = padded(d), chunks = (dp + DC - 1) / DC;
  const int steps = (i1 - i0 + 1) / 2 * chunks;

  auto item = [&](int it) {
    Item m{0, 0, 0};
    if (it < i1) {
      m.t = it / tiles;
      m.j0 = (it - m.t * tiles) * EN;
      m.rows = min(EN, n_max - m.j0);
    }
    return m;
  };

  // step u's queries' chunk into ring slot u % STAGES
  auto stage_x = [&](int u) {
    const int c0 = (u % chunks) * DC;
    float* Xs = Xr + (u % STAGES) * BQ * CLD;
    if constexpr (VEC) {  // float4 tid % F4 of rows tid / F4 + THREADS / F4 m
      const int c = 4 * (tid % F4);
      if (c0 + c < dp) {
#pragma unroll
        for (int r = tid / F4; r < BQ; r += THREADS / F4) {
          const bool valid = q0 + r < b;
          cp_async16(Xs + r * CLD + c, x + (int64_t)(valid ? q0 + r : 0) * d + c0 + c, valid);
        }
      }
    } else {  // feature tid % DC of rows tid / DC + THREADS / DC m
      const int c = tid % DC;
      if (c0 + c < dp) {
#pragma unroll 4
        for (int r = tid / DC; r < BQ; r += THREADS / DC) {
          const bool valid = q0 + r < b && c0 + c < d;
          cp_async4(Xs + r * CLD + c, x + (valid ? (int64_t)(q0 + r) * d + c0 + c : 0), valid);
        }
      }
    }
  };

  // step v's two items: fp32, their chunks into ring slot v % STAGES; int8,
  // their raw chunks (16-byte copies where d % 16 == 0, 4-byte ones where
  // d % 4 == 0, else byte loads) and each member's scale and zero chunks
  // into raw slot v % STAGES
  auto stage_items = [&](int v) {
    const int p = v / chunks, c0 = (v - p * chunks) * DC;
    for (int h = 0; h < 2; ++h) {
      const Item it = item(i0 + 2 * p + h);
      const int live = live_rows(it.rows);
      const int64_t row0 = (int64_t)it.t * n_max + it.j0;
      if constexpr (!INT8) {
        float* Ss = Sr + ((v % STAGES) * PAIR + h * EN) * CLD;
        const float* s = sup.s + row0 * d;
        if constexpr (VEC) {
          const int c = 4 * (tid % F4);
          if (c0 + c < dp) {
#pragma unroll
            for (int r = tid / F4; r < EN; r += THREADS / F4) {
              if (r >= live) break;
              const bool valid = r < it.rows;
              cp_async16(Ss + r * CLD + c, s + (valid ? (int64_t)r * d : 0) + c0 + c, valid);
            }
          }
        } else {
          const int c = tid % DC;
          if (c0 + c < dp) {
#pragma unroll 4
            for (int r = tid / DC; r < EN; r += THREADS / DC) {
              if (r >= live) break;
              const bool valid = r < it.rows && c0 + c < d;
              cp_async4(Ss + r * CLD + c, s + (valid ? (int64_t)r * d + c0 + c : 0), valid);
            }
          }
        }
      } else {
        if (it.rows == 0) continue;
        unsigned char* rr = raw + (v % STAGES) * RAW_STEP + h * EN * DC;
        const int8_t* q = sup.q + row0 * d;
        if (VEC && d % 16 == 0) {  // 16-byte piece tid % 4 of row tid / 4
          const int r = tid / (DC / 16), c = 16 * (tid % (DC / 16));
          if (r < live && c0 + c < dp) {
            const bool valid = r < it.rows;
            cp_async16(rr + r * DC + c, q + (valid ? (int64_t)r * d : 0) + c0 + c, valid);
          }
        } else if (VEC) {  // 4-byte word tid % F4 of rows tid / F4 + THREADS / F4 m
          const int c = 4 * (tid % F4);
          if (c0 + c < dp) {
#pragma unroll
            for (int r = tid / F4; r < EN; r += THREADS / F4) {
              if (r >= live) break;
              const bool valid = r < it.rows;
              cp_async4(rr + r * DC + c, q + (valid ? (int64_t)r * d : 0) + c0 + c, valid);
            }
          }
        } else {  // byte tid % DC of rows tid / DC + THREADS / DC m, loaded and stored
          const int c = tid % DC;
          if (c0 + c < dp) {
#pragma unroll 4
            for (int r = tid / DC; r < EN; r += THREADS / DC) {
              if (r >= live) break;
              rr[r * DC + c] = r < it.rows && c0 + c < d
                                   ? static_cast<unsigned char>(__ldg(q + (int64_t)r * d + c0 + c))
                                   : 0;
            }
          }
        }
        // the member's scale (e < DC) and zero (e >= DC) over the chunk's
        // features, 0 past d
        const float* scale = sup.scale + (int64_t)it.t * d;
        const float* zero = sup.zero + (int64_t)it.t * d;
        float* sz = reinterpret_cast<float*>(raw + (v % STAGES) * RAW_STEP + PAIR * DC) + h * 2 * DC;
        if constexpr (VEC) {
          if (tid < 2 * F4) {
            const int e = 4 * tid, c = c0 + e % DC;
            const bool valid = c < d;
            cp_async16(sz + e, (e < DC ? scale : zero) + (valid ? c : 0), valid);
          }
        } else if (tid < 2 * DC) {
          const int c = c0 + tid % DC;
          const bool valid = c < d;
          cp_async4(sz + tid, (tid < DC ? scale : zero) + (valid ? c : 0), valid);
        }
      }
    }
  };

  // int8: raw slot v % STAGES into tile v & 1 with the plain version's
  // rounding (a rounded multiply, then a rounded add): a thread does
  // features 4 (tid % F4) .. + 3 of rows tid / F4 + THREADS / F4 m
  auto dequantise_step = [&](int v) {
    const int p = v / chunks, c0 = (v - p * chunks) * DC, c = 4 * (tid % F4);
    if (c >= dp - c0) return;
    const unsigned char* rw = raw + (v % STAGES) * RAW_STEP;
    float* St = Sr + (v & 1) * PAIR * CLD;
    for (int h = 0; h < 2; ++h) {
      const Item it = item(i0 + 2 * p + h);
      const int live = live_rows(it.rows);
      const float* scale = reinterpret_cast<const float*>(rw + PAIR * DC) + h * 2 * DC;
      const float4 sc = *reinterpret_cast<const float4*>(scale + c);
      const float4 ze = *reinterpret_cast<const float4*>(scale + DC + c);
#pragma unroll
      for (int r = tid / F4; r < EN; r += THREADS / F4) {
        if (r >= live) break;
        // each byte q as a float exactly, without I2F: q + 128 into the low
        // byte of 2^23's bits, less 2^23 + 128
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(rw + (h * EN + r) * DC + c) ^ 0x80808080u;
        float4 s;
        s.x = __fadd_rn(__fmul_rn(byte_float(u, 0x7540), sc.x), ze.x);
        s.y = __fadd_rn(__fmul_rn(byte_float(u, 0x7541), sc.y), ze.y);
        s.z = __fadd_rn(__fmul_rn(byte_float(u, 0x7542), sc.z), ze.z);
        s.w = __fadd_rn(__fmul_rn(byte_float(u, 0x7543), sc.w), ze.w);
        *reinterpret_cast<float4*>(St + (h * EN + r) * CLD + c) = s;
      }
    }
  };

  // the copies committed two steps before step u: its queries' chunk, and
  // its items' chunks (int8: step u + 1's raw ones)
  auto prefetch = [&](int u) {
    if (u < steps) stage_x(u);
    if (u + INT8 < steps) stage_items(u + INT8);
  };

  if (INT8 && steps > 0) stage_items(0);
  prefetch(0);
  cp_async_commit();
  prefetch(1);
  cp_async_commit();
  if (tid < BQ) sxs[tid] = q0 + tid < b ? xnorms[q0 + tid] : 0.f;
  if (INT8 && steps > 0) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    dequantise_step(0);
  }

  float accq[TQ], a[TQ][TS], bb[TQ][TS];
#pragma unroll
  for (int i = 0; i < TQ; ++i) accq[i] = 0.f;
  // the pair's coefficients and norms (0 past an item's rows, as the staged
  // kernel's) and members' gammas, loaded before its last chunk's FMAs
  float cs[2][TS], ns[2][TS], gl[2];
  auto rbf = [&](float (&acc)[TQ][TS], int h) {
#pragma unroll
    for (int s = 0; s < TS; ++s) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float d2 = fmaxf(sxs[lane + 16 * i] + ns[h][s] - 2.f * acc[i][s], 0.f);
        accq[i] = fmaf(cs[h][s], ex2(gl[h] * d2), accq[i]);
      }
    }
  };

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed; every thread is done with step s - 1
    prefetch(s + 2);  // into the slots step s - 1 read
    cp_async_commit();
    if (INT8 && s + 1 < steps) dequantise_step(s + 1);

    const int p = s / chunks, k = s - p * chunks, width = min(DC, dp - k * DC);
    const Item A = item(i0 + 2 * p), B = item(i0 + 2 * p + 1);
    const bool doA = r0 < A.rows, doB = r0 < B.rows;  // as the staged kernel's warps
    const float* Xs = Xr + (s % STAGES) * BQ * CLD;
    const float* SA = Sr + (INT8 ? s & 1 : s % STAGES) * PAIR * CLD;
    const float* SB = SA + EN * CLD;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) a[i][j] = bb[i][j] = 0.f;
    }
    if (k == chunks - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Item& it = h ? B : A;
        gl[h] = it.rows ? -__ldg(gammas + it.t) * LOG2E : 0.f;
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          const int r = TS * grp + j;
          const int64_t off = (int64_t)it.t * n_max + it.j0 + r;
          cs[h][j] = r < it.rows ? __ldg(coef + off) : 0.f;
          ns[h][j] = r < it.rows ? __ldg(norms + off) : 0.f;
        }
      }
    }
    if (doA && doB) fma_chunk<true>(a, bb, Xs, SA, SB, width, lane, grp);
    else if (doA) fma_chunk<false>(a, a, Xs, SA, SA, width, lane, grp);
    else if (doB) fma_chunk<false>(bb, bb, Xs, SB, SB, width, lane, grp);
    if (k == chunks - 1) {  // the pair's last chunk: A's exp, then B's
      if (doA) rbf(a, 0);
      if (doB) rbf(bb, 1);
    }
  }

  cp_async_wait<0>();
  write_partial(accq, Xr, partial, b, q0, blockIdx.y, tid, lane, grp);
}

__global__ void mean_kernel(const float* __restrict__ partial, float* __restrict__ out, int b,
                            int splits, int k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= b) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(int64_t)p * b + q];
  out[q] = s / static_cast<float>(k);
}

template <class Supports, int D>
int launch_partials(const float* x, const Supports sup, const float* coef, const float* gammas,
                    const float* norms, float* partial, int b, int k, int n_max, int d,
                    int per_split, int splits, cudaStream_t stream) {
  const int smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        partials_kernel<Supports, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (n_max + EN - 1) / EN;
  const dim3 grid((b + BQ - 1) / BQ, splits);
  partials_kernel<Supports, D><<<grid, THREADS, smem, stream>>>(
      x, sup, coef, gammas, norms, partial, b, n_max, d, tiles, per_split, k * tiles);
  return static_cast<int>(cudaGetLastError());
}

template <class Supports, bool VEC>
int launch_chunked(const float* x, const Supports sup, const float* coef, const float* gammas,
                   const float* norms, const float* xnorms, float* partial, int b, int k,
                   int n_max, int d, int per_split, int splits, cudaStream_t stream) {
  constexpr int smem = chunked_smem_bytes<Supports::INT8>();
  const cudaError_t err = cudaFuncSetAttribute(partials_chunked_kernel<Supports, VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_max + EN - 1) / EN;
  const dim3 grid((b + BQ - 1) / BQ, splits);
  partials_chunked_kernel<Supports, VEC><<<grid, THREADS, smem, stream>>>(
      x, sup, coef, gammas, norms, xnorms, partial, b, n_max, d, tiles, per_split, k * tiles);
  return static_cast<int>(cudaGetLastError());
}

// the three passes on one stream; norms (k * n_max, then b for the chunked
// kernel's queries) and partial (splits * b) are the wrapper's scratch. The
// staged partials kernel where its tiles fit in shared memory, the chunked
// one past that (or always, with `chunked`): its 16-byte copies where d % 4
// == 0 and every base is 16-byte aligned, its 4-byte ones else.
template <class Supports>
int launch_scores(const float* x, const Supports sup, const float* coef, const float* gammas,
                  float* norms, float* partial, float* out, int b, int k, int n_max, int d,
                  int per_split, int splits, void* stream_arg, bool chunked = false) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_arg);
  const int64_t n_sup = (int64_t)k * n_max;
  if (n_sup > 0) {
    norms_kernel<<<static_cast<unsigned>((n_sup + 255) / 256), 256, 0, stream>>>(
        sup, norms, k, n_max, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rc;
  if (chunked || smem_bytes(d) > MAX_SMEM) {
    float* xnorms = norms + n_sup;
    query_norms_kernel<<<(b + NORM_ROWS - 1) / NORM_ROWS, NORM_ROWS, 0, stream>>>(x, xnorms, b,
                                                                                  d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rc = d % 4 == 0 && aligned16(x) && sup.aligned()
             ? launch_chunked<Supports, true>(x, sup, coef, gammas, norms, xnorms, partial, b, k,
                                              n_max, d, per_split, splits, stream)
             : launch_chunked<Supports, false>(x, sup, coef, gammas, norms, xnorms, partial, b,
                                               k, n_max, d, per_split, splits, stream);
  } else {
    rc = d == FAST_D ? launch_partials<Supports, FAST_D>(x, sup, coef, gammas, norms, partial, b,
                                                          k, n_max, d, per_split, splits, stream)
                     : launch_partials<Supports, 0>(x, sup, coef, gammas, norms, partial, b, k,
                                                    n_max, d, per_split, splits, stream);
  }
  if (rc != 0) return rc;
  mean_kernel<<<(b + 255) / 256, 256, 0, stream>>>(partial, out, b, splits, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ensemble_score_smem_bytes(int d) { return smem_bytes(d); }
extern "C" int ensemble_score_chunked_smem_bytes() { return chunked_smem_bytes<false>(); }
extern "C" int ensemble_score_q8_chunked_smem_bytes() { return chunked_smem_bytes<true>(); }

extern "C" int ensemble_score_launch(const float* x, const float* sup, const float* coef,
                                     const float* gammas, float* norms, float* partial,
                                     float* out, int b, int k, int n_max, int d, int per_split,
                                     int splits, void* stream) {
  return launch_scores(x, Fp32Supports{sup}, coef, gammas, norms, partial, out, b, k, n_max, d,
                       per_split, splits, stream);
}

extern "C" int ensemble_score_q8_launch(const float* x, const int8_t* q, const float* scale,
                                        const float* zero, const float* coef,
                                        const float* gammas, float* norms, float* partial,
                                        float* out, int b, int k, int n_max, int d,
                                        int per_split, int splits, void* stream) {
  return launch_scores(x, Int8Supports{q, scale, zero}, coef, gammas, norms, partial, out, b,
                       k, n_max, d, per_split, splits, stream);
}

// the chunked partials kernel at any d, for both loaders: the checks hold it
// bit for bit to the staged kernel where both run
extern "C" int ensemble_score_chunked_launch(const float* x, const float* sup, const float* coef,
                                             const float* gammas, float* norms, float* partial,
                                             float* out, int b, int k, int n_max, int d,
                                             int per_split, int splits, void* stream) {
  return launch_scores(x, Fp32Supports{sup}, coef, gammas, norms, partial, out, b, k, n_max, d,
                       per_split, splits, stream, true);
}

extern "C" int ensemble_score_q8_chunked_launch(const float* x, const int8_t* q,
                                                const float* scale, const float* zero,
                                                const float* coef, const float* gammas,
                                                float* norms, float* partial, float* out, int b,
                                                int k, int n_max, int d, int per_split,
                                                int splits, void* stream) {
  return launch_scores(x, Int8Supports{q, scale, zero}, coef, gammas, norms, partial, out, b,
                       k, n_max, d, per_split, splits, stream, true);
}
