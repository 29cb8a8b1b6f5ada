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
// Feature dims past one chunk (d > DC = 64) take the chunked route, whose
// cross term runs on the bf16 tensor cores. One fp32 chain over all d
// features, the staged kernel's, drifts past the registry's 1e-5 from the
// plain version at l 4,096 already at d 129 (PERF.md section 6), so no fp32
// sum here spans more than DC = 64 features; the chunks' sums are fp64.
//
//   split_planes (once a call, once for x2 = x1, the CG's case): warp w of a
//           block takes one row; it writes the row's three bf16 planes, hi =
//           bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid) (both
//           differences exact in fp32; gram.cu's split), padded with zeros
//           to dp = d rounded up to DC features and to a multiple of BQ rows,
//           so that every later copy is one 16-byte cp.async whatever d is;
//           and the row's norm in fp64: lane k runs the fmaf chain of chunk k
//           (ascending features), and the chunks' sums are added in order
//           in fp64 (the arithmetic of the chunked kernel this replaced).
//           6 bytes a feature a row: 20 MB at l 4,096 d 784, which stays in
//           the 50 MB L2. Splitting in the main kernel instead would convert
//           every support tile once per row block.
//   gram_matvec_chunked  grid (splits, row blocks of BQ = 128), one block an
//           SM (221,184 bytes of shared memory, __launch_bounds__(THREADS,
//           1)): block (s, b) walks (support tile of TILE = 64, chunk of DC
//           = 64 features) steps of split s's tiles
//           (kernels/gram_matvec.py::split_plan at CHUNKED_TARGET_BLOCKS,
//           one wave). Each step's three planes of the rows' chunk and of
//           the tile's chunk (192 rows x 128 bytes a plane) arrive by 16-byte
//           cp.async in a ring of STAGES = 3 steps, two steps ahead, one
//           barrier a step. Rows are unpadded: the 16-byte chunk c of row r
//           lies at c ^ (r % 8), so the 8 rows one ldmatrix reads and a
//           quarter-warp's copies fall on 8 distinct bank groups. 8 warps as
//           4 x 2; warp (wm, wn) owns rows 32 wm .. + 31 and supports 32 wn ..
//           + 31 of the step: 2 x 4 m16n8 fragments. A step runs, k step
//           after k step, the six plane products of order >= 2^-16 as
//           mma.sync.m16n8k16 (bf16 x bf16, fp32 accumulation, exact
//           products), smallest first: lo.hi, mid.mid, hi.lo, mid.hi,
//           hi.mid, hi.hi (gram.cu's order), the five smaller ones into one
//           set of 32 fp32 accumulators a thread and hi.hi into another, so
//           that 4 roundings a step, not 24, fall at the size of the cross
//           term (the tensor cores' fp32 adds truncate; one set was 9.5e-6
//           from the plain version at l 4,096 d 129, two 7.6e-6). At the end
//           of the step each pair is added in fp32, hi.hi's + the rest's
//           (one rounding to nearest), and converted once into 32 fp64 cross
//           sums: a conversion to fp64 issues at 16 an SM a clock, and two a
//           pair took 17 % more time (PERF.md section 6).
//           After a tile's last chunk the epilogue runs on the fragments:
//           d2 = max(sx + sy - 2 cross, 0) in fp64, K = expf(-gamma
//           fp32(d2)), acc += (double)v_j K, a thread's 8 columns of the
//           tile in ascending order, tile after tile. At the end the quad's
//           four lanes are added by shuffles ((l0 + l1) + l2) + l3, and the
//           two warps of a row in wn order through shared memory, into
//           partial[split][row].
//
// The chunked route gives other bits than the staged kernel where both run
// (d <= 64, through its private entry gram_matvec_chunked_launch), within
// the tolerance; d 16 and 32, the rounds' dims, keep the staged kernel and
// its bits. gram_matvec_emulated and gram_matvec_chunked_emulated in
// tests/test_torch_kernel_design.py follow the two on the CPU.
//
// Per-pair arithmetic of the staged kernel (the same as the kernel this
// replaces; the CPU emulation in tests/test_torch_kernel_design.py follows
// it):
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
// Bound on the H100: operations. A pair's 2d cross-term operations are
// priced at the rate of an fp32-accurate product from three bf16 planes,
// 989 / 6 = 164.8 TFLOP/s (obs/profile.py::kernel_bound), whichever
// pipe runs them: 0.0065 ms at l = 4096, d = 32, and 0.160 ms at d = 784,
// against 1 MB and 26 MB of inputs. The staged kernel runs them as fp32
// FMAs on the CUDA cores; what holds it back is the instructions a pair: 32
// FMAs, 3 shared loads and ~18 for the epilogue (expf alone ~10), ~53 in
// all (PERF.md section 6). The chunked kernel at l 4,096 d 784 takes ~4,800
// cycles a step for its 1,536 mma an SM (1.5 ldmatrix a 6 mma; the rows'
// chunks are copied again for every support tile, ~2 GB a call from L2):
// mma.sync's issue rate, a step's conversions to fp64 (~10 %) and the
// lockstep of its phases hold it (PERF.md section 6; wgmma from the same
// ring took 0.855x its time).
#include <cuda_bf16.h>
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
constexpr int DC = 64;               // features a step of the chunked kernel: its fp32 chains

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

// the chunked kernel's three bf16 planes (PLANES), of which the six products
// of order >= 2^-16 (PRODUCTS) run, KSTEP features an mma; a ring of STAGES
// steps, each the planes of SROWS staged rows (the block's BQ rows, then the
// tile's TILE supports) x DC features, 128 bytes a row; warps as CWM x CWN
constexpr int PLANES = 3;
constexpr int PRODUCTS = 6;
constexpr int KSTEP = 16;
constexpr int STAGES = 3;
constexpr int SROWS = BQ + TILE;
constexpr int STEP_ELEMS = PLANES * SROWS * DC;    // bf16 a ring slot
constexpr int CWM = 4, CWN = 2;                   // warps along rows and supports
constexpr int MT = BQ / CWM / 16, NT = TILE / CWN / 8;   // m16 and n8 fragments a warp: 2 x 4
constexpr int CPR = DC * 2 / 16;                  // 16-byte copies a staged row of a plane
constexpr int RPR = THREADS / CPR;                // staged rows a round of copies covers
constexpr int SPLIT_ROWS = 8;                     // rows a block of split_planes: a warp each
static_assert(CWM * CWN == WARPS && MT == 2 && NT == 4, "8 warps of 32 x 32");
static_assert(BQ % RPR == 0 && TILE % RPR == 0, "a round of copies is all rows or all supports");

constexpr int chunked_smem_bytes() { return 2 * STAGES * STEP_ELEMS; }
static_assert(8 * BQ * CWN <= chunked_smem_bytes(), "the warps' row sums fit the ring");

// the chunked route's scratch, laid out by the launcher: dp = d rounded up to
// DC, each operand's rows rounded up to BQ; x2's planes and norms follow
// x1's unless x2 is x1
constexpr int padded_dim(int d) { return (d + DC - 1) / DC * DC; }
constexpr int padded_rows(int rows) { return (rows + BQ - 1) / BQ * BQ; }
int scratch_rows(int m, int n, bool same) { return padded_rows(m) + (same ? 0 : padded_rows(n)); }

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for one 16 x 8 x 16 tile: a row-major bf16 (4 regs), b column-major
// bf16 (2 regs), d fp32 (4 regs)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[i][s] += x_i . s_s over features 0 .. width - 1 (a multiple of 4), one
// fmaf chain a pair in ascending feature order: rows lane + LANES i of Xs and
// TS grp .. TS grp + 3 of St, row strides ld (odd float4s: conflict-free);
// 8 float4 steps unrolled
__device__ __forceinline__ void fma_tile(float (&acc)[TQ][TS], const float* Xs, const float* St,
                                         int ld, int width, int lane, int grp) {
#pragma unroll 8
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
      fma_tile(acc, Xs, St, ld, dp, lane, grp);
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

// The chunked route's prologue: row r of x (rows x d) -> its three bf16
// planes at planes[p][r][0 .. dp) (zeros past d, and for r >= rows) and its
// norm at norms[r] (0 past rows). Warp w of block b takes row SPLIT_ROWS b +
// w; lane l converts features 4 l .. 4 l + 3 of each 128.
__global__ void __launch_bounds__(THREADS)
split_planes(const float* __restrict__ x, int rows, int d, int dp, int64_t plane,
             __nv_bfloat16* __restrict__ planes, double* __restrict__ norms) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * SPLIT_ROWS + threadIdx.x / 32;
  const bool real = r < rows;
  const float* xr = x + (int64_t)(real ? r : 0) * d;
  __nv_bfloat16* dst = planes + (int64_t)r * dp;
  for (int c = 4 * lane; c < dp; c += 128) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = real && c + j < d ? __ldg(xr + c + j) : 0.f;
    uint32_t out[PLANES][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two features a conversion (cvt.rn.bf16x2.f32)
      const float v0 = w[2 * h], v1 = w[2 * h + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
      const float2 fh = __bfloat1622float2(hi);
      const float r0 = __fsub_rn(v0, fh.x), r1 = __fsub_rn(v1, fh.y);  // exact
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const float2 fm = __bfloat1622float2(mid);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(__fsub_rn(r0, fm.x), __fsub_rn(r1, fm.y));
      out[0][h] = as_u32(hi);
      out[1][h] = as_u32(mid);
      out[2][h] = as_u32(lo);
    }
#pragma unroll
    for (int q = 0; q < PLANES; ++q)
      *reinterpret_cast<uint2*>(dst + q * plane + c) = make_uint2(out[q][0], out[q][1]);
  }
  // the norm: lane k the fp32 fmaf chain of chunk k0 + k, the chunks' sums
  // added in chunk order in fp64 (every lane adds them all, from shuffles)
  const int chunks = dp / DC;
  double s = 0.0;
  for (int k0 = 0; k0 < chunks; k0 += 32) {
    const int k = k0 + lane;
    float part = 0.f;
    if (real && k < chunks) {
      const int end = min(k * DC + DC, d);
      for (int c = k * DC; c < end; ++c) part = fmaf(__ldg(xr + c), __ldg(xr + c), part);
    }
    const int here = min(32, chunks - k0);
    for (int j = 0; j < here; ++j) s += static_cast<double>(__shfl_sync(0xffffffffu, part, j));
  }
  if (lane == 0) norms[r] = s;
}

// The chunked kernel (see the header). p1 / p2: the planes of x1 / x2, plane
// strides ps1 / ps2 elements, rows dp elements; n1 / n2 their norms.
__global__ void __launch_bounds__(THREADS, 1)
gram_matvec_chunked(const __nv_bfloat16* __restrict__ p1, const double* __restrict__ n1,
                    int64_t ps1, const __nv_bfloat16* __restrict__ p2,
                    const double* __restrict__ n2, int64_t ps2, const float* __restrict__ v,
                    float gamma, double* __restrict__ partial, int m, int n, int dp,
                    int per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][PLANES][SROWS][DC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / CWN, wn = warp % CWN;
  const int q0 = blockIdx.y * BQ;
  const int tiles = (n + TILE - 1) / TILE;
  const int t0 = blockIdx.x * per_split, t1 = min(t0 + per_split, tiles);
  const int chunks = dp / DC;
  const int steps = (t1 - t0) * chunks;

  // the copies: this thread takes 16-byte chunk cc of staged rows cr + RPR i
  // of each plane, stored at chunk cc ^ (row % 8) (= cc ^ (cr % 8))
  const int cr = tid / CPR, cc = tid % CPR;
  const int sw = (cc ^ (cr & 7)) * 8;
  const __nv_bfloat16* a_src = p1 + (int64_t)(q0 + cr) * dp + cc * 8;
  const __nv_bfloat16* b_src = p2 + (int64_t)(t0 * TILE + cr) * dp + cc * 8;
  auto stage = [&](int s, int slot) {
    __nv_bfloat16* dst = ring + slot * STEP_ELEMS + cr * DC + sw;
    const int64_t ko = (int64_t)(s / chunks) * TILE * dp + (s % chunks) * DC;  // tile, chunk
    const int ka = (s % chunks) * DC;
#pragma unroll 1
    for (int p = 0; p < PLANES; ++p) {
      const __nv_bfloat16* a = a_src + p * ps1 + ka;
      const __nv_bfloat16* b = b_src + p * ps2 + ko;
      __nv_bfloat16* o = dst + p * SROWS * DC;
#pragma unroll
      for (int i = 0; i < BQ / RPR; ++i)
        cp_async16(o + i * RPR * DC, a + (int64_t)i * RPR * dp, true);
#pragma unroll
      for (int i = 0; i < TILE / RPR; ++i)
        cp_async16(o + (BQ + i * RPR) * DC, b + (int64_t)i * RPR * dp, true);
    }
  };

  // the products, smallest first: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi
  // (plane of x1, plane of x2; 0 hi, 1 mid, 2 lo)
  constexpr int PA[PRODUCTS] = {2, 1, 0, 1, 0, 0};
  constexpr int PB[PRODUCTS] = {0, 1, 2, 0, 1, 0};
  // ldmatrix rows of this lane (the swizzle's row % 8 is lane % 8 for both)
  // and its 16-byte chunk within a k step before the swizzle: A's matrices
  // are (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of an m16
  // tile; B's (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of two
  // n8 tiles
  const int a_row = 32 * wm + ((lane / 8) & 1) * 8 + lane % 8;
  const int b_row = BQ + 32 * wn + (lane / 16) * 8 + lane % 8;
  const int a_hi = lane / 16, b_hi = (lane / 8) & 1;
  const uint32_t ring_addr = smem_addr(ring);

  // epilogue rows of this thread: 32 wm + 16 mt + 8 h + g; columns of a
  // tile: 32 wn + 8 nt + c2 + e
  const int g = lane / 4, c2 = (lane % 4) * 2;
  double sx[MT][2], tot[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sx[mt][h] = n1[q0 + 32 * wm + 16 * mt + 8 * h + g];  // rows padded: in bounds, 0 past m
      tot[mt][h] = 0.0;
    }
  const float neg_gamma = -gamma;

  double cross[MT][NT][4];  // the tile's cross products: the steps' fp32 sums, added in fp64
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) cross[mt][nt][e] = 0.0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s, s);
    cp_async_commit();
  }
  int slot = 0;
  for (int s = 0; s < steps; ++s) {
    const int k = s % chunks;
    cp_async_wait<STAGES - 2>();  // this thread's copies of step s have landed ...
    __syncthreads();              // ... and everyone's; every warp is done with step s - 1
    {
      const int ahead = s + STAGES - 1, aslot = slot == 0 ? STAGES - 1 : slot - 1;
      if (ahead < steps) stage(ahead, aslot);
      cp_async_commit();
    }
    const uint32_t base = ring_addr + 2 * slot * STEP_ELEMS;
    float acc[2][MT][NT][4];  // the five smaller products' sums, then hi.hi's
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DC / KSTEP; ++ks) {
      uint32_t af[PLANES][MT][4], bf[PLANES][NT / 2][4];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[p][mt], base + 2 * ((p * SROWS + a_row + 16 * mt) * DC +
                                             ((2 * ks + a_hi) ^ (lane % 8)) * 8));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp)
          ldmatrix_x4(bf[p][jp], base + 2 * ((p * SROWS + b_row + 16 * jp) * DC +
                                             ((2 * ks + b_hi) ^ (lane % 8)) * 8));
      }
#pragma unroll
      for (int q = 0; q < PRODUCTS; ++q) {
        const int a = q == PRODUCTS - 1;  // hi.hi into its own accumulator
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            mma_bf16(acc[a][mt][2 * jp], af[PA[q]][mt], bf[PB[q]][jp][0], bf[PB[q]][jp][1]);
            mma_bf16(acc[a][mt][2 * jp + 1], af[PA[q]][mt], bf[PB[q]][jp][2],
                     bf[PB[q]][jp][3]);
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cross[mt][nt][e] = (k == 0 ? 0.0 : cross[mt][nt][e]) +
                             static_cast<double>(acc[1][mt][nt][e] + acc[0][mt][nt][e]);
    if (k == chunks - 1) {  // the tile's last chunk: the exp and the sums over supports
      const int jb = (t0 + s / chunks) * TILE + 32 * wn + c2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb + 8 * nt + e;
          const double nj = n2[j];  // rows padded: in bounds, 0 past n
          const double vj = j < n ? static_cast<double>(__ldg(v + j)) : 0.0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const double d2 = fmax(sx[mt][h] + nj - 2.0 * cross[mt][nt][2 * h + e], 0.0);
              const float kv = expf(neg_gamma * static_cast<float>(d2));
              tot[mt][h] = fma(vj, static_cast<double>(kv), tot[mt][h]);
            }
        }
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }

  // the quad's lanes in lane order, then the row's two warps in wn order
  cp_async_wait<0>();
  __syncthreads();  // no thread reads the ring any more
  double* red = reinterpret_cast<double*>(smem);  // [BQ][CWN]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int quad = lane & ~3;
      double q4 = __shfl_sync(0xffffffffu, tot[mt][h], quad);
      q4 += __shfl_sync(0xffffffffu, tot[mt][h], quad + 1);
      q4 += __shfl_sync(0xffffffffu, tot[mt][h], quad + 2);
      q4 += __shfl_sync(0xffffffffu, tot[mt][h], quad + 3);
      if (lane % 4 == 0) red[(32 * wm + 16 * mt + 8 * h + g) * CWN + wn] = q4;
    }
  __syncthreads();
  if (tid < BQ && q0 + tid < m) {
    double sum = 0.0;
    for (int w = 0; w < CWN; ++w) sum += red[tid * CWN + w];
    partial[(int64_t)blockIdx.x * m + q0 + tid] = sum;
  }
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

// x's planes and norms (x2 = x1: once), the chunked kernel, the split sums
int launch_chunked(const float* x1, const float* x2, const float* v, float gamma,
                   double* partial, float* out, void* planes, double* norms, int m, int n,
                   int d, int per_split, int splits, cudaStream_t stream) {
  constexpr int smem = chunked_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      gram_matvec_chunked, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool same = x1 == x2 && m == n;
  const int dp = padded_dim(d), r1 = padded_rows(m), r2 = same ? r1 : padded_rows(n);
  const int64_t ps1 = (int64_t)r1 * dp, ps2 = (int64_t)r2 * dp;
  __nv_bfloat16* pl1 = static_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* pl2 = same ? pl1 : pl1 + PLANES * ps1;
  double* nm2 = same ? norms : norms + r1;
  split_planes<<<r1 / SPLIT_ROWS, THREADS, 0, stream>>>(x1, m, d, dp, ps1, pl1, norms);
  if (!same)
    split_planes<<<r2 / SPLIT_ROWS, THREADS, 0, stream>>>(x2, n, d, dp, ps2, pl2, nm2);
  const cudaError_t split_err = cudaGetLastError();
  if (split_err != cudaSuccess) return static_cast<int>(split_err);
  gram_matvec_chunked<<<dim3(splits, (m + BQ - 1) / BQ), THREADS, smem, stream>>>(
      pl1, norms, ps1, pl2, nm2, ps2, v, gamma, partial, m, n, dp, per_split);
  return launch_sum(partial, out, m, splits, stream);
}

}  // namespace

extern "C" int gram_matvec_smem_bytes(int d) { return smem_bytes(d); }
extern "C" int gram_matvec_chunked_smem_bytes() { return chunked_smem_bytes(); }
// the chunked route's scratch: PLANES x rows x padded_dim(d) bf16 planes and
// rows fp64 norms, rows = gram_matvec_scratch_rows(m, n, x2 is x1)
extern "C" int gram_matvec_scratch_rows(int m, int n, int same) {
  return scratch_rows(m, n, same != 0);
}
extern "C" int gram_matvec_padded_dim(int d) { return padded_dim(d); }

// ``per_split`` 64-support tiles per split, ``splits`` = ceil(tiles / per_split),
// both from kernels/gram_matvec.py::split_plan; ``partial`` holds splits * m
// doubles; ``planes`` and ``norms`` the chunked route's scratch (unread up to
// d 64). The staged kernel up to one chunk's features (its tiles fit in
// shared memory to d 220, but its one fp32 chain is too long past d 64), the
// chunked route past that.
extern "C" int gram_matvec_launch(const float* x1, const float* x2, const float* v,
                                  float gamma, double* partial, float* out, void* planes,
                                  double* norms, int m, int n, int d, int per_split,
                                  int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > DC)
    return launch_chunked(x1, x2, v, gamma, partial, out, planes, norms, m, n, d, per_split,
                          splits, st);
  // 16-byte copies need 16-byte aligned rows: d = 32 and aligned bases
  const bool fast = d == FAST_D && reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  return fast ? launch<FAST_D>(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits, st)
              : launch<0>(x1, x2, v, gamma, partial, out, m, n, d, per_split, splits, st);
}

// the chunked route at any d, for the checks that hold it to the staged
// kernel where both run
extern "C" int gram_matvec_chunked_launch(const float* x1, const float* x2, const float* v,
                                          float gamma, double* partial, float* out,
                                          void* planes, double* norms, int m, int n, int d,
                                          int per_split, int splits, void* stream) {
  return launch_chunked(x1, x2, v, gamma, partial, out, planes, norms, m, n, d, per_split,
                        splits, static_cast<cudaStream_t>(stream));
}
