// Streaming RBF-Gram matvec for Hopper (sm_90a):
//   out[i] = sum_j v[j] * exp(-gamma * max(|x1_i|^2 + |x2_j|^2 - 2 x1_i.x2_j, 0))
//
// Replaces repro/kernels/gram_matvec.py::gram_matvec_pallas (TPU), the matvec
// inside the distillation CG solver. The TPU kernel walks (row tile, support
// tile) as a sequential grid and carries a (bm, 1) sum in VMEM across the
// support tiles. CUDA blocks run in parallel and in no order, so here:
//
//   pass 1  grid (splits, row blocks of BQ = 128): block (s, b) owns the row
//           block's 128 rows and support tiles s * per_split ..
//           (s + 1) * per_split - 1 (kernels/gram_matvec.py::split_plan),
//           keeps one fp64 sum a row and writes it to partial[s][row];
//   pass 2  out[i] = sum over splits of partial[s][i], in split order.
//
// No atomics; every sum is taken in a fixed order, so two launches agree bit
// for bit. At the CG's l = 4096: 32 row blocks x 8 splits = 256 blocks of 256
// threads, two resident per SM (__launch_bounds__(256, 2), ~40 KB of shared
// memory a block): one wave on 132 SMs x 2 = 264 slots (97 %), each block
// 128 rows x 512 supports. A thread-block cluster of a row block's 8 splits,
// adding them through distributed shared memory in one launch, measured
// slower: at two blocks an SM the card holds fewer clusters of 8 than the
// grid has (a cluster must fit in one GPC), so the clustered grid ran in
// two waves (PERF.md section 6).
//
// Per block: 256 threads as 16 support groups x 16 row lanes; thread (group,
// lane) owns rows lane + 16 i (i < 8) and supports 4 group .. 4 group + 3 of
// each 64-support tile, an 8 x 4 register tile read from shared memory as
// float4 along the feature dim (12 loads a 128 FMAs; row strides are an odd
// number of float4s, so a quarter-warp's 8 row reads fall on distinct banks,
// and the support reads are warp broadcasts). The rows' tile and their norms
// are staged once a block (16-byte cp.async). Then each warp walks the
// split's tiles on its own: warp w stages only rows 8 w .. 8 w + 7 of each
// support tile and their v (cp.async, double-buffered, so the next tile
// loads while this one computes), its lanes 0-7 take those rows' norms and
// convert their v to fp64 once a tile, and it synchronises with __syncwarp
// alone: no block barrier a tile, so the warps drift apart and one warp's
// exp phase (MUFU and conversions) overlaps another's FMAs. At d = 32 (the
// round's) the copies are 16 bytes with compile-time addresses; any other d
// takes a general instantiation with 4-byte copies (nested row / column
// loops, no runtime division by d). Supports past n are staged as zeros with
// v = 0 and add exactly 0; rows past m are computed and never stored.
//
// Feature dims past one chunk (d > DC = 64) take gram_matvec_chunked: the
// same blocks, thread tiles and sums over supports, but the block walks
// (support tile, feature chunk of 64) steps in order, block-synchronously:
// it stages the rows' chunk (re-read from L2 a tile) and the tile's chunk
// (4-byte cp.async, double-buffered: the next step loads while this one
// computes). Its per-pair arithmetic is not the staged kernel's one fp32
// chain over all d features, which drifts past the registry's 1e-5 from the
// plain version at l 4,096 already at d 129 (PERF.md section 6) and
// at d > 220 would not fit in shared memory anyway: each chunk's products go
// into an fp32 fmaf chain of at most 64 features, and the chunk sums into
// fp64 (32 a thread, carried across a tile's chunks); the norms likewise
// (the rows' from global memory once a block, the supports' by threads 0-63
// as the chunks pass), and d2 in fp64. The exp and the fp64 FMA with v
// come once a tile, after its last chunk. So the chunked kernel does not
// give the staged kernel's bits where both run (d <= 64, through its
// private entry); it takes one block an SM (its fp64 sums need ~250
// registers a thread). d 16 and 32, the rounds' dims, keep the staged
// kernel.
//
// Per-pair arithmetic (the same as the kernel this replaces; the CPU
// emulation in tests/test_torch_kernel_design.py follows it):
//   cross = 0; for c = 0 .. d-1: cross = fmaf(x1[i][c], x2[j][c], cross)
//   sq    = 0; for c = 0 .. d-1: sq = fmaf(a[c], a[c], sq)      (each norm)
//   d2    = fmaxf(sqx + sqs - 2.f * cross, 0.f)
//   K     = expf(-gamma * d2)                  (full precision, not ex2.approx)
//   acc   = fma((double)v[j], (double)K, acc)  (v converted once a tile)
// Sums over supports stay fp64 in a fixed order: a thread adds its 4
// supports of each tile in turn, tile after tile of its split; a block adds
// its 16 groups in group order; the second pass adds the splits in order.
// No fp32 sub-sums, no TF32: the norm expansion's cancellation leaves the
// registry's 1e-5 little headroom at l = 4096 (PERF.md section 7).
//
// Bound on the H100: fp32 operations, about 2d + 8 per (row, support) pair;
// 0.018 ms at l = 4096, d = 32 (67 TFLOP/s), against 1 MB of inputs. What
// holds it back is the instructions a pair: 32 FMAs, 3 shared loads and ~18
// for the epilogue (expf alone ~10), ~53 in all (PERF.md section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;              // rows per block
constexpr int BLOCKS_PER_SM = 2;     // resident blocks an SM (registers: 128 a thread)
constexpr int TQ = 8;                // rows per thread
constexpr int TS = 4;                // supports per thread
constexpr int GROUPS = 16;           // support groups
constexpr int TILE = GROUPS * TS;    // supports per staged tile
constexpr int LANES = BQ / TQ;       // row lanes: thread (group, lane) owns rows lane + LANES i
constexpr int THREADS = LANES * GROUPS;
constexpr int WARPS = THREADS / 32;  // warp w owns support groups 2 w and 2 w + 1 ...
constexpr int WROWS = TS * 32 / LANES;  // ... so rows WROWS w .. WROWS (w + 1) - 1 of every tile
constexpr int FAST_D = 32;           // the feature dim with 16-byte staging
constexpr int RED_LD = 17;           // row stride (doubles) of the group sums
constexpr int DC = 64;               // features a step of the chunked kernel stages
constexpr int CLD = DC + 4;          // its tiles' row stride: 17 float4s, odd

// d rounded up to a float4
__host__ __device__ constexpr int padded(int d) { return (d + 3) / 4 * 4; }
// row stride (floats) of the staged tiles: an odd number of float4s
__host__ __device__ constexpr int row_stride(int d) {
  return (padded(d) / 4) % 2 ? padded(d) : padded(d) + 4;
}
// the two support buffers, reused as the [BQ][RED_LD] fp64 group sums
__host__ __device__ constexpr int support_floats(int d) {
  return 2 * TILE * row_stride(d) > 2 * BQ * RED_LD ? 2 * TILE * row_stride(d)
                                                    : 2 * BQ * RED_LD;
}

// Xs, the support buffers, v as staged (fp32) and the support norms, then
// v in fp64; every part is a multiple of 8 bytes
int smem_bytes(int d) {
  return 4 * (BQ * row_stride(d) + support_floats(d) + 2 * TILE + 2 * TILE) + 8 * 2 * TILE;
}

// the chunked kernel: two buffers of the rows' and the tile's chunks (the
// first reused as the [BQ][RED_LD] fp64 group sums), the tile's v and norms
// in fp64, the rows' norms in fp64
constexpr int chunked_smem_bytes() { return 4 * 2 * (BQ + TILE) * CLD + 8 * 2 * TILE + 8 * BQ; }
static_assert(4 * 2 * (BQ + TILE) * CLD >= 8 * BQ * RED_LD, "group sums fit the buffers");

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

// acc[i][s] += x_i . s_s over features 0 .. width - 1 (a multiple of 4), one
// fmaf chain a pair in ascending feature order: rows lane + LANES i of Xs and
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
      const float4 xv = *reinterpret_cast<const float4*>(Xs + (lane + LANES * i) * ld + c);
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

// the 16 support groups of each row, added in group order, into
// partial[split][row]: red is [BQ][RED_LD] of shared memory no thread reads
// any more
__device__ __forceinline__ void write_partial(const double (&sums)[TQ], double* red,
                                              double* partial, int rows, int q0, int split,
                                              int tid, int lane, int grp) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TQ; ++i) red[(lane + LANES * i) * RED_LD + grp] = sums[i];
  __syncthreads();
  if (tid < BQ && q0 + tid < rows) {
    double s = 0.0;
    for (int g = 0; g < GROUPS; ++g) s += red[tid * RED_LD + g];
    partial[(int64_t)split * rows + q0 + tid] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gram_matvec_partial(const float* __restrict__ x1, const float* __restrict__ x2,
                    const float* __restrict__ v, float gamma, double* __restrict__ partial,
                    int m, int n, int d_arg, int per_split) {
  const int d = D ? D : d_arg;
  const int dp = padded(d), ld = row_stride(d);
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // [BQ][ld]
  float* Ss = Xs + BQ * ld;                      // [2][TILE][ld], then [BQ][RED_LD] doubles
  float* vs = Ss + support_floats(d);            // [2][TILE] v as staged
  float* ns = vs + 2 * TILE;                     // [2][TILE] support norms
  double* vd = reinterpret_cast<double*>(ns + 2 * TILE);  // [2][TILE] v in fp64

  const int tid = threadIdx.x, lane = tid % LANES, grp = tid / LANES, warp = tid / 32;
  const int wlane = tid % 32, r0 = WROWS * warp;
  const int q0 = blockIdx.y * BQ;
  const int tiles = (n + TILE - 1) / TILE;
  const int t0 = blockIdx.x * per_split, t1 = min(t0 + per_split, tiles);

  // the rows' tile, by all threads, once
  if constexpr (D == FAST_D) {
    for (int i = tid; i < BQ * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool valid = q0 + r < m;
      cp_async16(Xs + r * ld + c, x1 + (int64_t)(valid ? q0 + r : 0) * D + c, valid);
    }
  } else {
    for (int r = warp; r < BQ; r += WARPS) {
      const bool row_ok = q0 + r < m;
      for (int c = wlane; c < dp; c += 32) {
        const bool valid = row_ok && c < d;
        cp_async4(Xs + r * ld + c, x1 + (valid ? (int64_t)(q0 + r) * d + c : 0), valid);
      }
    }
  }
  cp_async_commit();

  // one warp's rows r0 .. r0 + WROWS - 1 of support tile t, and their v
  auto stage_tile = [&](int t, int buf) {
    const int j0 = t * TILE, rows = min(TILE, n - j0);
    if (r0 >= rows) return;  // every row of this warp is padding: nothing to stage
    float* St = Ss + buf * TILE * ld;
    if constexpr (D == FAST_D) {
      for (int i = wlane; i < WROWS * D / 4; i += 32) {
        const int r = r0 + i / (D / 4), c = (i % (D / 4)) * 4;
        const bool valid = r < rows;
        cp_async16(St + r * ld + c, x2 + (int64_t)(j0 + (valid ? r : 0)) * D + c, valid);
      }
    } else {
      for (int r = r0; r < r0 + WROWS; ++r) {
        const bool row_ok = r < rows;
        for (int c = wlane; c < dp; c += 32) {
          const bool valid = row_ok && c < d;
          cp_async4(St + r * ld + c, x2 + (valid ? (int64_t)(j0 + r) * d + c : 0), valid);
        }
      }
    }
    if (wlane < WROWS) {
      const int r = r0 + wlane;
      const bool valid = r < rows;
      cp_async4(vs + buf * TILE + r, v + (valid ? j0 + r : 0), valid);
    }
  };

  if (t0 < t1) stage_tile(t0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's copies of the rows' tile have landed ...
  __syncthreads();     // ... and everyone's
  float sx[TQ];
  double acc64[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float* xr = Xs + (lane + LANES * i) * ld;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(xr[c], xr[c], s);
    sx[i] = s;
    acc64[i] = 0.0;
  }

  // From here each warp walks the split's tiles on its own: it stages and
  // reads only its own rows of each tile (and their v and norms), so it
  // synchronises with __syncwarp alone.
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) stage_tile(t + 1, buf ^ 1);  // the warp freed that buffer last step
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int rows = min(TILE, n - t * TILE);
    if (r0 < rows) {
      const float* St = Ss + buf * TILE * ld;
      if (wlane < WROWS) {  // the warp's rows: their norms, and v in fp64
        const int r = r0 + wlane;
        const float* sr = St + r * ld;
        float s = 0.f;
        for (int c = 0; c < d; ++c) s = fmaf(sr[c], sr[c], s);
        ns[buf * TILE + r] = s;
        vd[buf * TILE + r] = static_cast<double>(vs[buf * TILE + r]);
      }
      __syncwarp();
      float acc[TQ][TS];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int s = 0; s < TS; ++s) acc[i][s] = 0.f;
      fma_tile<8>(acc, Xs, St, ld, dp, lane, grp);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const float nj = ns[buf * TILE + TS * grp + s];
        const double vj = vd[buf * TILE + TS * grp + s];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float d2 = fmaxf(sx[i] + nj - 2.f * acc[i][s], 0.f);
          acc64[i] = fma(vj, static_cast<double>(expf(-gamma * d2)), acc64[i]);
        }
      }
    }
    __syncwarp();  // the warp is done with this buffer before it is refilled
  }

  write_partial(acc64, reinterpret_cast<double*>(Ss), partial, m, q0, blockIdx.x, tid, lane, grp);
}

// Any d: (support tile, chunk) steps in order, block-synchronous (see the
// header). Step s = (tile t0 + s / chunks, chunk s % chunks) reads buffer s & 1.
__global__ void __launch_bounds__(THREADS, 1)
gram_matvec_chunked(const float* __restrict__ x1, const float* __restrict__ x2,
                    const float* __restrict__ v, float gamma, double* __restrict__ partial,
                    int m, int n, int d, int per_split) {
  extern __shared__ float4 smem4[];
  float* buf0 = reinterpret_cast<float*>(smem4);  // [2][BQ + TILE][CLD]: rows, then supports
  double* vd = reinterpret_cast<double*>(buf0 + 2 * (BQ + TILE) * CLD);  // [TILE]
  double* ns = vd + TILE;                                               // [TILE]
  double* sxs = ns + TILE;                                              // [BQ]

  const int tid = threadIdx.x, lane = tid % LANES, grp = tid / LANES;
  const int q0 = blockIdx.y * BQ;
  const int tiles = (n + TILE - 1) / TILE;
  const int t0 = blockIdx.x * per_split, t1 = min(t0 + per_split, tiles);
  const int dp = padded(d), chunks = (dp + DC - 1) / DC;
  const int steps = (t1 - t0) * chunks;

  // step s's chunks: the rows' and the tile's features c0 .. c0 + DC - 1
  // (those at or past dp are never read; those in [d, dp) are zeros)
  auto stage = [&](int s) {
    float* Xs = buf0 + (s & 1) * (BQ + TILE) * CLD;
    float* St = Xs + BQ * CLD;
    const int j0 = (t0 + s / chunks) * TILE, c0 = (s % chunks) * DC;
    for (int i = tid; i < (BQ + TILE) * DC; i += THREADS) {
      const int r = i / DC, c = i % DC;
      if (c0 + c >= dp) continue;
      const bool is_row = r < BQ;
      const int64_t row = is_row ? (int64_t)q0 + r : (int64_t)j0 + r - BQ;
      const bool valid = (is_row ? row < m : row < n) && c0 + c < d;
      const float* src = is_row ? x1 : x2;
      cp_async4((is_row ? Xs + r * CLD : St + (r - BQ) * CLD) + c,
                src + (valid ? row * d + c0 + c : 0), valid);
    }
  };

  if (steps > 0) stage(0);
  cp_async_commit();
  // the rows' norms from global memory: a chunk's squares in fp32, the
  // chunks' sums in fp64
  if (tid < BQ) {
    double s = 0.0;
    if (q0 + tid < m) {
      const float* xr = x1 + (int64_t)(q0 + tid) * d;
      for (int c0 = 0; c0 < d; c0 += DC) {
        float p = 0.f;
        for (int c = c0; c < min(c0 + DC, d); ++c) p = fmaf(xr[c], xr[c], p);
        s += static_cast<double>(p);
      }
    }
    sxs[tid] = s;
  }
  __syncthreads();
  double sx[TQ], acc64[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    sx[i] = sxs[lane + LANES * i];
    acc64[i] = 0.0;
  }

  double cross[TQ][TS];  // the tile's cross products: the chunks' fp32 sums, added in fp64
  double nrm = 0.0;      // threads 0 .. TILE - 1: support tid's norm over the chunks so far
  for (int s = 0; s < steps; ++s) {
    const int k = s % chunks, t = t0 + s / chunks;
    cp_async_wait<0>();
    __syncthreads();  // step s has landed; everyone is done with buffer (s + 1) & 1
    if (s + 1 < steps) stage(s + 1);
    cp_async_commit();
    const float* Xs = buf0 + (s & 1) * (BQ + TILE) * CLD;
    const float* St = Xs + BQ * CLD;
    const int c0 = k * DC, width = min(DC, dp - c0);
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) cross[i][j] = 0.0;
      nrm = 0.0;
    }
    if (tid < TILE) {
      const float* sr = St + tid * CLD;
      const int real = min(width, d - c0);
      float p = 0.f;
      for (int c = 0; c < real; ++c) p = fmaf(sr[c], sr[c], p);
      nrm += static_cast<double>(p);
    }
    float acc[TQ][TS];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) acc[i][j] = 0.f;
    fma_tile<4>(acc, Xs, St, CLD, width, lane, grp);
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) cross[i][j] += static_cast<double>(acc[i][j]);
    if (k == chunks - 1) {  // the tile's last chunk: its norms and v, then the exp
      if (tid < TILE) {
        const int j = t * TILE + tid;
        ns[tid] = nrm;
        vd[tid] = j < n ? static_cast<double>(__ldg(v + j)) : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const double nj = ns[TS * grp + j];
        const double vj = vd[TS * grp + j];
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const double d2 = fmax(sx[i] + nj - 2.0 * cross[i][j], 0.0);
          const float kv = expf(-gamma * static_cast<float>(d2));
          acc64[i] = fma(vj, static_cast<double>(kv), acc64[i]);
        }
      }
    }
  }

  cp_async_wait<0>();
  write_partial(acc64, reinterpret_cast<double*>(buf0), partial, m, q0, blockIdx.x, tid, lane, grp);
}

__global__ void sum_splits(const double* __restrict__ partial, float* __restrict__ out, int m,
                           int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  double s = 0.0;
  for (int t = 0; t < splits; ++t) s += partial[(int64_t)t * m + i];
  out[i] = static_cast<float>(s);
}

// the split sums, after either kernel
int launch_sum(double* partial, float* out, int m, int splits, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits<<<(m + 255) / 256, 256, 0, stream>>>(partial, out, m, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const float* x1, const float* x2, const float* v, float gamma, double* partial,
           float* out, int m, int n, int d, int per_split, int splits, cudaStream_t stream) {
  const int smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_matvec_partial<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_matvec_partial<D><<<dim3(splits, (m + BQ - 1) / BQ), THREADS, smem, stream>>>(
      x1, x2, v, gamma, partial, m, n, d, per_split);
  return launch_sum(partial, out, m, splits, stream);
}

int launch_chunked(const float* x1, const float* x2, const float* v, float gamma,
                   double* partial, float* out, int m, int n, int d, int per_split, int splits,
                   cudaStream_t stream) {
  constexpr int smem = chunked_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      gram_matvec_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_matvec_chunked<<<dim3(splits, (m + BQ - 1) / BQ), THREADS, smem, stream>>>(
      x1, x2, v, gamma, partial, m, n, d, per_split);
  return launch_sum(partial, out, m, splits, stream);
}

}  // namespace

extern "C" int gram_matvec_smem_bytes(int d) { return smem_bytes(d); }
extern "C" int gram_matvec_chunked_smem_bytes() { return chunked_smem_bytes(); }

// ``per_split`` 64-support tiles per split, ``splits`` = ceil(tiles / per_split),
// both from kernels/gram_matvec.py::split_plan; ``partial`` holds splits * m
// doubles. The staged kernel up to one chunk's features (its tiles fit in
// shared memory to d 220, but its one fp32 chain is too long past d 64), the
// chunked one past that.
extern "C" int gram_matvec_launch(const float* x1, const float* x2, const float* v,
                                  float gamma, double* partial, float* out, int m, int n,
                                  int d, int per_split, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > DC)
    return launch_chunked(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits, st);
  // 16-byte copies need 16-byte aligned rows: d = 32 and aligned bases
  const bool fast = d == FAST_D && reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  return fast ? launch<FAST_D>(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits, st)
              : launch<0>(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits, st);
}

// the chunked kernel at any d, for the checks that hold it to the staged
// kernel where both run
extern "C" int gram_matvec_chunked_launch(const float* x1, const float* x2, const float* v,
                                          float gamma, double* partial, float* out, int m,
                                          int n, int d, int per_split, int splits,
                                          void* stream) {
  return launch_chunked(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits,
                        static_cast<cudaStream_t>(stream));
}
