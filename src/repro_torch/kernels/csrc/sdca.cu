// Cyclic SDCA on the hinge-loss dual as a tiled, delayed-update solve with
// fp64 sums (sm_90a): one block per device up to bucket 12,384, one
// thread-block cluster of CLUSTER CTAs per device past it.
//
// Replaces repro/core/svm.py::_sdca, an XLA fori_loop inside jit that the
// reference engine vmaps over a bucket of devices (repro/sim/engine.py:202).
// It is not a Pallas kernel there; on the GPU it needs one, because eager
// PyTorch would issue several launches per coordinate step (20 epochs x
// n_real steps per solve, 40,000 for the pooled-data ideal).
//
// Bound on the H100: the dependent chain. Step i reads the alpha that step
// i-1 wrote, so a solve is 20 n_real steps in a row on one SM; the bytes (each
// K read once) and the operations bound it far below that. The design makes
// one step as short as it can be and keeps everything else off the chain.
//
// The coordinates go in tiles of TILE = 32, lane r of warp 0 (the stepping
// warp) owning coordinate s + r of the tile that starts at s:
//   1. Tile matvec: w_r = sum_{j < n} K[s+r, j] y_j alpha_j, from alpha at the
//      tile's start. One warp sums a row: lane l reads the 4-column groups l,
//      l + 32, l + 64, ... of K[s+r, :] (16-byte loads, eight in flight) and
//      adds their products with y o alpha, kept in fp64 in shared memory, in
//      column order; each product of two fp32 values is exact in fp64. The
//      lanes' sums are added pairwise, lanes differing in bit 4 first, then
//      bit 3, ... bit 0. The order depends on nothing but n.
//   2. In-tile steps, in warp 0 alone: lane r turns its w into f = (float)w /
//      (lam n_real), the reference's step and the new alpha_r; one shuffle
//      broadcasts it, and every lane adds K[s+lane, s+r] y_r (alpha_new -
//      alpha_old) to its w in fp64. A step is a shuffle, the fp32 arithmetic
//      of the reference (its two divisions as a multiply by a reciprocal
//      taken once and one FMA correction, still rounded as a division) and
//      three fp64 operations: no barrier.
//   3. Look-ahead: while warp 0 steps through tile t, the other warps compute
//      tile t+1's matvec over every column outside tile t (those do not
//      change during tile t) and stage tile t+1's diagonal block K y and the
//      block K[tile t+2 rows, tile t+1 cols] y in shared memory. Warp 0 adds
//      tile t's own columns, K[tile t+1 rows, tile t cols] y alpha_new, to a
//      second fp64 sum as each alpha of tile t is set. One __syncthreads a
//      tile (20 ceil(n / 32) + 1 a solve), none a step.
// The K rows are read once a tile from L2: a group's Grams and the 2,048^2
// ideal Gram (16 MB) sit in the 50 MB L2; at b 2048, 16 matvec warps of
// 16-byte loads keep 64 KB in flight (4 warps of 8 rows each below b 1024). No sum depends on the block's shape, and there are no
// atomics, so a device's alpha is bit-identical whatever group it is solved
// in and from launch to launch. tests/test_torch_kernel_design.py emulates
// this order on the CPU.
//
// Past bucket 12,384 (smem_bytes(b) > 227 KB) v, alpha and y outgrow a
// block's shared memory, and K (4 b^2 bytes, 1.07 GB at b 16,384) outgrows
// the 50 MB L2: a tile's 32 rows (2 MiB at b 16,384) come from HBM, and one
// SM with 64 KB in flight pulls them at ~53 GB/s, 15x the steps' time. So
// a device is solved by one thread-block cluster of CLUSTER CTAs
// (flash_chunked.cuh's helpers), and every tile's rows come from all of
// them at once:
//   a. Column slices. Rank r owns the columns [r W, min(r W + W, n)), W =
//      slice_cols(n): ceil(n / CLUSTER) rounded up to SLICE_UNIT, one pass
//      of the 32 lanes over GROUP-column groups. It keeps their v (fp64) and
//      alpha in its shared memory. Ranks past n own no column. A tile's 32
//      columns lie in one slice.
//   b. The K ring. Warp 1 of each rank streams its slice of the tiles' rows,
//      a stage of TILE rows x CH columns at a time, into a ring of shared
//      memory: one TMA copy of a box of K seen as a (g b, b) tensor
//      (cp.async.bulk.tensor) a stage, which completes on the stage's
//      "full" mbarrier; the matvec warps free a stage on its "empty" one.
//      The copies do not depend on alpha, so they run as far ahead as the
//      ring holds. (A row segment a lane, cp.async.bulk, compiles to a loop
//      of 32 copies a warp; the ring then fed an SM at ~23 GB/s, PERF.md.)
//   c. Look-ahead matvec, split by columns. While rank 0's warp 0 steps
//      through tile t, warps 2.. of every rank sum tile t+1's rows over the
//      rank's slice, leaving out tile t's columns: lane l over the slice's
//      groups l, l + 32, ... (stage by stage, in column order), then the
//      lanes pairwise as above. Each rank writes its 32 sums into rank 0's
//      shared memory (st.shared::cluster); rank 0's warp 0 adds them in rank
//      order 0 .. CLUSTER - 1, then the carry of tile t's columns (step 3).
//      Rank 0's matvec warps also stage the step's two blocks, and the next
//      tile's y and alpha.
//   d. One cluster barrier a tile. Warp 0 writes tile t's new v and alpha
//      into the owning rank's slice (st.shared::cluster), the partial sums
//      land, and the cluster passes one barrier (cluster_publish /
//      cluster_wait); the copy warp arrives without a fence (cluster_done)
//      and issues no store, so no fence waits for a bulk copy in flight.
// The step is the one-block kernel's. Every sum's order depends on n and
// CLUSTER alone, with no atomics: a device's alphas are the same from
// launch to launch and in any group, within the tolerance of the one-block
// kernel's (tests/test_torch_kernel_design.py emulates this order too).
//
// Arithmetic follows the reference step by step: f = s / (lam * n_real) with
// lam * n_real in fp32; step = grad * lam * n_real / max(K[i,i], 1e-8);
// alpha_i = clip(alpha_i + step, 0, 1). Coordinates i >= n_real stay 0, which
// the reference reaches by masking: its steps for them write 0 into an alpha
// that is already 0, so they are skipped here, and so are the j >= n_real
// terms of each dot, whose alpha is 0.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_chunked.cuh"

namespace {

namespace fc = flash_chunked;

constexpr int TILE = 32;
constexpr int LD = TILE + 1;           // padded row of a staged block: no bank conflicts
constexpr int GROUP = 4;               // columns a lane reads at once
constexpr int IN_FLIGHT = 8;           // groups a lane loads before it sums them
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;       // shared memory a block may take (227 KB)
static_assert(TILE == 32, "a tile is one warp, a lane a coordinate");

struct Layout {
  double* part;   // [2][TILE]       the tile's matvec, by tile parity
  double* dy;     // [2][TILE][LD]   K[rows t, cols t] * y
  double* by;     // [2][TILE][LD]   K[rows t+1, cols t] * y
  double* v;      // [b]             y * alpha, zero past n
  float* alpha;   // [b]
  const float* ys;  // [b]
};

// the tile blocks and their sums
__host__ __device__ constexpr int block_bytes() {
  return static_cast<int>(sizeof(double)) * (2 * TILE + 4 * TILE * LD);
}
__host__ __device__ inline int smem_bytes(int b) {
  return block_bytes() + static_cast<int>(sizeof(double)) * b +
         static_cast<int>(sizeof(float)) * 2 * b;
}

// v, alpha and y after the blocks (y copied in by the kernel)
__device__ inline Layout carve(unsigned char* raw, int b) {
  Layout L;
  L.part = reinterpret_cast<double*>(raw);
  L.dy = L.part + 2 * TILE;
  L.by = L.dy + 2 * TILE * LD;
  L.v = L.by + 2 * TILE * LD;
  L.alpha = reinterpret_cast<float*>(L.v + b);
  L.ys = L.alpha + b;
  return L;
}

// a / b rounded to nearest from y = RN(1 / b): q = RN(a y) is within an ulp of
// a / b, and one correction by the exact residual a - b q gives RN(a / b)
// (Markstein's theorem; it holds unless a - b q underflows, |a| < ~2^-100,
// where the quotient may be an ulp off). Two dependent FMAs in place of a
// division subroutine on the chain.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  return fmaf(fmaf(-b, q, a), y, q);
}

struct Solve {
  const float* Kd;   // this device's (b, b) Gram; b a multiple of GROUP, 16-byte aligned
  int b, n, tiles;
};

// One level of the lanes' sum over V row sums: lanes L and L ^ DIST add
// theirs; when V > 1, L keeps the half of the rows (acc[0 .. V/2)) that its
// DIST bit selects, else both keep the row.
template <int DIST, int V>
__device__ __forceinline__ void fold(double* acc, int lane) {
  if constexpr (V == 1) {
    acc[0] += __shfl_xor_sync(FULL, acc[0], DIST);
  } else {
    constexpr int H = V / 2;
    const bool upper = lane & DIST;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const double send = upper ? acc[k] : acc[k + H];
      const double keep = upper ? acc[k + H] : acc[k];
      acc[k] = keep + __shfl_xor_sync(FULL, send, DIST);
    }
  }
}

// row sums a lane holds at the level over bit log2(dist), for `rows` rows a warp
__host__ __device__ constexpr int level(int rows, int dist) {
  return rows * dist / 16 > 0 ? rows * dist / 16 : 1;
}

// Every row's 32 lane sums added over bit 4 first, then bit 3, ... bit 0,
// however many rows a warp holds; row k's sum ends in lane k (32 / RPW).
template <int RPW>
__device__ __forceinline__ void lane_sum(double (&acc)[RPW], int lane) {
  fold<16, level(RPW, 16)>(acc, lane);
  fold<8, level(RPW, 8)>(acc, lane);
  fold<4, level(RPW, 4)>(acc, lane);
  fold<2, level(RPW, 2)>(acc, lane);
  fold<1, level(RPW, 1)>(acc, lane);
}

// Warps 1..NMW: global tile u's matvec over the groups outside [ex4, ex4 +
// TILE / GROUP), and the blocks warp 0 steps with. Warp m sums rows m, m +
// NMW, ... of the tile, RPW of them, IN_FLIGHT groups' loads in flight a lane.
template <int NMW>
__device__ void prepare(const Layout& L, const Solve& S, int u, int ex4, int buf) {
  constexpr int RPW = TILE / NMW;
  constexpr int U = IN_FLIGHT / RPW;   // groups of each row a batch of loads covers
  static_assert(NMW >= TILE / IN_FLIGHT && NMW <= 16, "2 to 8 rows a warp");
  const int nt = 32 * NMW, th = threadIdx.x - 32;
  const int lane = threadIdx.x % 32, mw = threadIdx.x / 32 - 1;
  const int s1 = (u % S.tiles) * TILE, s2 = ((u + 1) % S.tiles) * TILE;
  const int n = S.n;

  // the two blocks: every load issued before any is used
  constexpr int PER = TILE * TILE / (32 * NMW);
  float kd[PER], kb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = (th + i * nt) / TILE, col = s1 + (th + i * nt) % TILE;
    kd[i] = (col < n && s1 + r < n) ? __ldg(S.Kd + (int64_t)(s1 + r) * S.b + col) : 0.f;
    kb[i] = (col < n && s2 + r < n) ? __ldg(S.Kd + (int64_t)(s2 + r) * S.b + col) : 0.f;
  }
  double* dyb = L.dy + buf * TILE * LD;
  double* byb = L.by + buf * TILE * LD;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = (th + i * nt) / TILE, c = (th + i * nt) % TILE;
    const float yc = s1 + c < n ? L.ys[s1 + c] : 0.f;
    dyb[r * LD + c] = kd[i] * yc;
    byb[r * LD + c] = kb[i] * yc;
  }

  const int groups = (n + GROUP - 1) / GROUP;
  const int passes = (groups + 31) / 32;   // lane l reads groups l + 32 j, j < passes
  const double2* v2 = reinterpret_cast<const double2*>(L.v);
  const float* rows = S.Kd + (int64_t)(s1 + mw) * S.b;   // row k of the warp: rows + k NMW b
  const int last = n - 1 - s1;                            // rows past it are not real
  double acc[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) acc[k] = 0.0;
  for (int j0 = 0; j0 < passes; j0 += U) {
    float4 kv[RPW][U];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const int g = lane + 32 * (j0 + i);
        const bool live = g < groups && mw + k * NMW <= last;
        // a group past n reads padded columns (K and alpha both 0) inside the row
        kv[k][i] = live ? __ldg(reinterpret_cast<const float4*>(rows + (int64_t)k * NMW * S.b) + g)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int i = 0; i < U; ++i) {   // a group's y o alpha read once for the warp's rows
      const int g = lane + 32 * (j0 + i);
      if (g < groups && (g < ex4 || g >= ex4 + TILE / GROUP)) {
        const double2 v01 = v2[2 * g], v23 = v2[2 * g + 1];
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          double a = acc[k];
          a = fma(static_cast<double>(kv[k][i].x), v01.x, a);
          a = fma(static_cast<double>(kv[k][i].y), v01.y, a);
          a = fma(static_cast<double>(kv[k][i].z), v23.x, a);
          a = fma(static_cast<double>(kv[k][i].w), v23.y, a);
          acc[k] = a;
        }
      }
    }
  }
  lane_sum(acc, lane);
  if (lane % (32 / RPW) == 0) {
    const int r = mw + (lane / (32 / RPW)) * NMW;
    if (r <= last) L.part[buf * TILE + r] = acc[0];
  }
}

template <int NMW>
__global__ void __launch_bounds__(32 * (NMW + 1))
sdca_kernel(const float* __restrict__ K, const float* __restrict__ y,
            const int* __restrict__ n_real, float* __restrict__ alpha_out, int b, float lam,
            int epochs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dev = blockIdx.x;
  const Layout L = carve(smem_raw, b);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nr = n_real[dev];
  const int n = nr < 0 ? 0 : (nr < b ? nr : b);
  const float nf = static_cast<float>(nr);
  const float lam_n = lam * nf;
  const float r_lam_n = __frcp_rn(lam_n);
  Solve S;
  S.Kd = K + (int64_t)dev * b * b;
  S.b = b;
  S.n = n;
  S.tiles = (n + TILE - 1) / TILE;
  const int runs = epochs * S.tiles;   // global tile u runs tile u % tiles

  for (int j = threadIdx.x; j < b; j += blockDim.x) {
    L.alpha[j] = 0.f;
    L.v[j] = 0.0;
    const_cast<float*>(L.ys)[j] = y[(int64_t)dev * b + j];
  }
  __syncthreads();

  if (runs > 0 && warp > 0) prepare<NMW>(L, S, 0, INT_MIN / 2, 0);
  __syncthreads();

  double carry = 0.0;   // warp 0: the previous tile's columns, for this tile's rows
  for (int u = 0; u < runs; ++u) {
    const int buf = u & 1;
    const int s = (u % S.tiles) * TILE;
    if (warp == 0) {
      double w_own = L.part[buf * TILE + lane] + carry;
      double w_next = 0.0;
      const double* D = L.dy + buf * TILE * LD + lane * LD;
      const double* B = L.by + buf * TILE * LD + lane * LD;
      const int i = s + lane;
      const bool real = i < n;
      float a_own = real ? L.alpha[i] : 0.f;
      const float y_own = real ? L.ys[i] : 1.f;
      const float k_ii = fmaxf(static_cast<float>(D[lane]) * y_own, 1e-8f);  // (K y)_ii y_i
      const float r_k_ii = __frcp_rn(k_ii);
      const int steps = n - s < TILE ? n - s : TILE;
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        if (r >= steps) break;
        const float f = div_rn(__double2float_rn(w_own), lam_n, r_lam_n);
        const float grad = 1.f - y_own * f;
        const float step = div_rn(grad * lam * nf, k_ii, r_k_ii);
        const float cand = fminf(fmaxf(a_own + step, 0.f), 1.f);
        const float a_old = __shfl_sync(FULL, a_own, r);
        const float a_new = __shfl_sync(FULL, cand, r);
        if (lane == r) a_own = a_new;
        const double delta = __dsub_rn(static_cast<double>(a_new), static_cast<double>(a_old));
        w_own = __dadd_rn(w_own, __dmul_rn(D[r], delta));
        w_next = __dadd_rn(w_next, __dmul_rn(B[r], static_cast<double>(a_new)));
      }
      if (real) {
        L.alpha[i] = a_own;
        L.v[i] = static_cast<double>(y_own * a_own);
      }
      carry = w_next;
    } else if (u + 1 < runs) {
      prepare<NMW>(L, S, u + 1, s / GROUP, buf ^ 1);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < b; j += blockDim.x)
    alpha_out[(int64_t)dev * b + j] = L.alpha[j];
}

template <int NMW>
int launch(const float* K, const float* y, const int* n_real, float* alpha, int g, int b,
           float lam, int epochs, cudaStream_t stream) {
  const int smem = smem_bytes(b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdca_kernel<NMW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sdca_kernel<NMW><<<g, 32 * (NMW + 1), smem, stream>>>(K, y, n_real, alpha, b, lam, epochs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The cluster kernel, past bucket 12,384 (a.-d. above)
// ---------------------------------------------------------------------------

constexpr int CLUSTER = 16;                // CTAs a device (non-portable: above 8)
constexpr int SLICE_UNIT = 32 * GROUP;     // a slice is whole passes of the lanes
constexpr int CH = 256;                    // columns of a ring stage's row
constexpr int CMW = 8;                     // matvec warps a CTA
constexpr int CRPW = TILE / CMW;           // rows a matvec warp sums
constexpr int CPASS = CH / SLICE_UNIT;     // groups of a stage row a lane sums
constexpr int CTHREADS = 32 * (2 + CMW);   // warp 0 steps (rank 0), warp 1 copies
constexpr int STAGE_BYTES = static_cast<int>(sizeof(float)) * TILE * CH;
constexpr int MBAR_BYTES = 2 * static_cast<int>(sizeof(uint64_t));   // a stage's full and empty
static_assert(CH % SLICE_UNIT == 0, "a stage row is whole passes of the lanes");

// every rank's columns: ceil(n / CLUSTER) rounded up to SLICE_UNIT
__host__ __device__ inline int slice_cols(int n) {
  return (n + CLUSTER * SLICE_UNIT - 1) / (CLUSTER * SLICE_UNIT) * SLICE_UNIT;
}
// rank 0's partial sums of a tile's rows by rank, the step's blocks and the
// tile's (y, alpha), by tile parity: in every rank's layout
__host__ __device__ constexpr int cluster_fixed_bytes() {
  return static_cast<int>(sizeof(double)) * (2 * CLUSTER * TILE + 4 * TILE * LD) +
         static_cast<int>(sizeof(float2)) * 2 * TILE;
}
// a slice's v (fp64) and alpha
__host__ __device__ inline int slice_bytes(int b) {
  return (static_cast<int>(sizeof(double)) + static_cast<int>(sizeof(float))) * slice_cols(b);
}
// stages of the K ring: what shared memory leaves (0: the bucket does not fit)
__host__ __device__ inline int ring_stages(int b) {
  const int left = MAX_SMEM - cluster_fixed_bytes() - slice_bytes(b);
  return left > 0 ? left / (STAGE_BYTES + MBAR_BYTES) : 0;
}
__host__ __device__ inline int cluster_smem_bytes(int b) {
  return cluster_fixed_bytes() + slice_bytes(b) + ring_stages(b) * (STAGE_BYTES + MBAR_BYTES);
}

struct Cluster {
  float* ring;      // [stages][TILE][CH]  K rows of this rank's slice
  double* part;     // [2][CLUSTER][TILE]  rank 0: each rank's sums of a tile's rows
  double* dy;       // [2][TILE][LD]       rank 0: K[rows t, cols t] * y
  double* by;       // [2][TILE][LD]       rank 0: K[rows t+1, cols t] * y
  double* v;        // [slice_cols(b)]     y * alpha of the slice, zero past n
  uint64_t* full;   // [stages]            a stage's copies landed
  uint64_t* empty;  // [stages]            a stage's rows read
  float2* ya;       // [2][TILE]           rank 0: (y, alpha) of the tile's coordinates
  float* alpha;     // [slice_cols(b)]
};

__device__ inline Cluster carve_cluster(unsigned char* raw, int b, int stages) {
  Cluster L;
  L.ring = reinterpret_cast<float*>(raw);
  L.part = reinterpret_cast<double*>(L.ring + (int64_t)stages * TILE * CH);
  L.dy = L.part + 2 * CLUSTER * TILE;
  L.by = L.dy + 2 * TILE * LD;
  L.v = L.by + 2 * TILE * LD;
  L.full = reinterpret_cast<uint64_t*>(L.v + slice_cols(b));
  L.empty = L.full + stages;
  L.ya = reinterpret_cast<float2*>(L.empty + stages);
  L.alpha = reinterpret_cast<float*>(L.ya + 2 * TILE);
  return L;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The box of `map` at (col, row) into this CTA's shared `dst`, counted
// against the mbarrier `bar` as it lands (columns or rows past the tensor
// read 0)
__device__ __forceinline__ void tensor_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, double x) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(x) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x) : "memory");
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// A rank's view of its device: its slice and its ring
struct Slice {
  Solve S;
  int rank, W, lo, own, stages_a_tile, runs, stages;
};

// The cluster kernel's staging of the blocks warp 0 steps through tile s1
// with, K[s1 rows, s1 cols] y and K[s2 rows, s1 cols] y (as prepare's, but
// apart): by NT threads, the loads (PER of each a thread) issued before the
// sums and the stores after them.
template <int NT>
struct Blocks {
  static constexpr int PER = TILE * TILE / NT;
  float kd[PER], kb[PER], yc[PER];

  __device__ __forceinline__ void load(const Solve& S, const float* ys, int s1, int s2, int th) {
    const int n = S.n;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = (th + i * NT) / TILE, col = s1 + (th + i * NT) % TILE;
      kd[i] = (col < n && s1 + r < n) ? __ldg(S.Kd + (int64_t)(s1 + r) * S.b + col) : 0.f;
      kb[i] = (col < n && s2 + r < n) ? __ldg(S.Kd + (int64_t)(s2 + r) * S.b + col) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = (th + i * NT) % TILE;
      yc[i] = s1 + c < n ? ys[s1 + c] : 0.f;
    }
  }

  __device__ __forceinline__ void store(double* dyb, double* byb, int th) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = (th + i * NT) / TILE, c = (th + i * NT) % TILE;
      dyb[r * LD + c] = kd[i] * yc[i];
      byb[r * LD + c] = kb[i] * yc[i];
    }
  }
};

// Warp 1's lane 0: stage k = u * stages_a_tile + c (tile run u's column
// chunk c: K[tile rows, lo + c CH ...], one TILE x CH box of the (g b, b)
// tensor map) into slot k % stages, for every k < target; a slot is refilled
// once the matvec warps have freed it.
__device__ void issue(const Cluster& L, const Slice& V, const CUtensorMap* map, int dev,
                      int& issued, int target) {
  for (; issued < target; ++issued) {
    const int slot = issued % V.stages;
    if (issued >= V.stages) mbar_wait(fc::smem_u32(L.empty + slot), (issued / V.stages - 1) & 1);
    const int u = issued / V.stages_a_tile, c0 = (issued - u * V.stages_a_tile) * CH;
    const uint32_t bar = fc::smem_u32(L.full + slot);
    mbar_expect(bar, STAGE_BYTES);
    tensor_load(fc::smem_u32(L.ring + (int64_t)slot * TILE * CH), map, V.lo + c0,
                dev * V.S.b + (u % V.S.tiles) * TILE, bar);
  }
}

// Warps 2..: tile run u's sums over the slice, outside the columns [ex, ex +
// TILE), into rank 0's part[u & 1][rank]; on rank 0 also the step's blocks
// and the tile's (y, alpha). Warp m sums rows m, m + CMW, ...
__device__ void cluster_matvec(const Cluster& L, const Slice& V, const float* ys, int u, int ex) {
  const int th = threadIdx.x - 64, lane = threadIdx.x % 32, mw = threadIdx.x / 32 - 2;
  const Solve& S = V.S;
  const int buf = u & 1;
  const int s1 = (u % S.tiles) * TILE, s2 = ((u + 1) % S.tiles) * TILE;
  const int last = S.n - 1 - s1;   // rows past it are not real

  Blocks<32 * CMW> blocks;   // rank 0: loads issued now, stored after the sums
  float2 ya = make_float2(1.f, 0.f);
  if (V.rank == 0) {
    blocks.load(S, ys, s1, s2, th);
    const int i = s1 + th;
    if (th < TILE && i < S.n) {
      ya.x = ys[i];
      // the alpha warp 0 wrote a tile run before or earlier; with one tile,
      // warp 0 carries its own
      if (S.tiles > 1) {
        const int owner = i / V.W;
        ya.y = ld_cluster_f32(fc::map_rank(fc::smem_u32(L.alpha + (i - owner * V.W)), owner));
      }
    }
  }

  const double2* v2 = reinterpret_cast<const double2*>(L.v);
  double acc[CRPW];
#pragma unroll
  for (int k = 0; k < CRPW; ++k) acc[k] = 0.0;
  for (int c = 0; c < V.stages_a_tile; ++c) {
    const int k_stage = u * V.stages_a_tile + c, slot = k_stage % V.stages;
    const int c0 = c * CH;
    const int groups = ((V.own - c0 < CH ? V.own - c0 : CH) + GROUP - 1) / GROUP;
    mbar_wait(fc::smem_u32(L.full + slot), (k_stage / V.stages) & 1);
    const float4* st = reinterpret_cast<const float4*>(L.ring + (int64_t)slot * TILE * CH);
    float4 kv[CRPW][CPASS];
#pragma unroll
    for (int k = 0; k < CRPW; ++k)
#pragma unroll
      for (int i = 0; i < CPASS; ++i) {
        const int g = lane + 32 * i;
        const int r = mw + k * CMW;
        kv[k][i] = g < groups && r <= last ? st[r * (CH / GROUP) + g]
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(fc::smem_u32(L.empty + slot));   // the rows are in registers
#pragma unroll
    for (int i = 0; i < CPASS; ++i) {   // a group's y o alpha read once for the warp's rows
      const int g = c0 / GROUP + lane + 32 * i;   // the slice's group
      const int col = V.lo + g * GROUP;
      if (lane + 32 * i < groups && (col < ex || col >= ex + TILE)) {
        const double2 v01 = v2[2 * g], v23 = v2[2 * g + 1];
#pragma unroll
        for (int k = 0; k < CRPW; ++k) {
          double a = acc[k];
          a = fma(static_cast<double>(kv[k][i].x), v01.x, a);
          a = fma(static_cast<double>(kv[k][i].y), v01.y, a);
          a = fma(static_cast<double>(kv[k][i].z), v23.x, a);
          a = fma(static_cast<double>(kv[k][i].w), v23.y, a);
          acc[k] = a;
        }
      }
    }
  }
  lane_sum(acc, lane);
  if (lane % (32 / CRPW) == 0) {
    const int r = mw + (lane / (32 / CRPW)) * CMW;
    if (r <= last)
      st_cluster(fc::map_rank(fc::smem_u32(L.part + (buf * CLUSTER + V.rank) * TILE + r), 0),
                 acc[0]);
  }
  if (V.rank == 0) {
    blocks.store(L.dy + buf * TILE * LD, L.by + buf * TILE * LD, th);
    if (th < TILE) L.ya[buf * TILE + th] = ya;
  }
}

__global__ void __launch_bounds__(CTHREADS, 1)
sdca_cluster_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ K,
                    const float* __restrict__ y, const int* __restrict__ n_real,
                    float* __restrict__ alpha_out, int b, float lam, int epochs, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Cluster L = carve_cluster(smem_raw, b, stages);
  const int dev = blockIdx.x / CLUSTER;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nr = n_real[dev];
  const int n = nr < 0 ? 0 : (nr < b ? nr : b);
  const float* ys = y + (int64_t)dev * b;
  Slice V;
  V.S.Kd = K + (int64_t)dev * b * b;
  V.S.b = b;
  V.S.n = n;
  V.S.tiles = (n + TILE - 1) / TILE;
  V.rank = static_cast<int>(fc::cluster_rank());
  V.W = slice_cols(n);
  V.lo = V.rank * V.W;
  V.own = n - V.lo < V.W ? n - V.lo : V.W;
  if (V.own < 0) V.own = 0;
  V.stages_a_tile = (V.own + CH - 1) / CH;
  V.runs = epochs * V.S.tiles;   // tile run u runs tile u % tiles
  V.stages = stages;

  for (int j = threadIdx.x; j < slice_cols(b); j += CTHREADS) {
    L.v[j] = 0.0;
    L.alpha[j] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(fc::smem_u32(L.full + s), 1);
      mbar_init(fc::smem_u32(L.empty + s), CMW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fc::cluster_publish();
  fc::cluster_wait();

  const float nf = static_cast<float>(nr);
  const float lam_n = lam * nf;
  const float r_lam_n = __frcp_rn(lam_n);
  double carry = 0.0;   // warp 0: the previous tile's columns, for this tile's rows
  float a_own = 0.f;    // warp 0: lane r's alpha, carried when the device has one tile
  int issued = 0;       // warp 1: stages issued
  // phase p: warp 0 steps tile run p, the matvec warps sum tile run p + 1,
  // warp 1 copies up to the ring's depth past the stages of run p + 1
  for (int p = -1; p < V.runs; ++p) {
    if (warp == 0) {
      if (V.rank == 0 && p >= 0) {
        const int buf = p & 1, s = (p % V.S.tiles) * TILE;
        const double* P = L.part + buf * CLUSTER * TILE + lane;
        double w_own = P[0];
#pragma unroll
        for (int k = 1; k < CLUSTER; ++k) w_own = __dadd_rn(w_own, P[k * TILE]);
        w_own = __dadd_rn(w_own, carry);
        double w_next = 0.0;
        const double* D = L.dy + buf * TILE * LD + lane * LD;
        const double* B = L.by + buf * TILE * LD + lane * LD;
        const int i = s + lane;
        const bool real = i < n;
        const float2 yv = L.ya[buf * TILE + lane];
        if (V.S.tiles > 1) a_own = real ? yv.y : 0.f;
        const float y_own = real ? yv.x : 1.f;
        const float k_ii = fmaxf(static_cast<float>(D[lane]) * y_own, 1e-8f);  // (K y)_ii y_i
        const float r_k_ii = __frcp_rn(k_ii);
        const int steps = n - s < TILE ? n - s : TILE;
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          if (r >= steps) break;
          const float f = div_rn(__double2float_rn(w_own), lam_n, r_lam_n);
          const float grad = 1.f - y_own * f;
          const float step = div_rn(grad * lam * nf, k_ii, r_k_ii);
          const float cand = fminf(fmaxf(a_own + step, 0.f), 1.f);
          const float a_old = __shfl_sync(FULL, a_own, r);
          const float a_new = __shfl_sync(FULL, cand, r);
          if (lane == r) a_own = a_new;
          const double delta = __dsub_rn(static_cast<double>(a_new), static_cast<double>(a_old));
          w_own = __dadd_rn(w_own, __dmul_rn(D[r], delta));
          w_next = __dadd_rn(w_next, __dmul_rn(B[r], static_cast<double>(a_new)));
        }
        if (real) {   // into the owning rank's slice
          const int owner = i / V.W, at = i - owner * V.W;
          st_cluster(fc::map_rank(fc::smem_u32(L.v + at), owner),
                     static_cast<double>(y_own * a_own));
          st_cluster(fc::map_rank(fc::smem_u32(L.alpha + at), owner), a_own);
        }
        carry = w_next;
        fc::cluster_publish();
      } else {
        fc::cluster_done();
      }
    } else if (warp == 1) {
      const int total = V.runs * V.stages_a_tile;
      const int ahead = (p + 2) * V.stages_a_tile + V.stages;
      if (lane == 0) issue(L, V, &map, dev, issued, ahead < total ? ahead : total);
      __syncwarp();
      fc::cluster_done();
    } else {
      if (p + 1 < V.runs)
        cluster_matvec(L, V, ys, p + 1, p >= 0 ? (p % V.S.tiles) * TILE : INT_MIN / 2);
      fc::cluster_publish();
    }
    fc::cluster_wait();
  }
  float* out = alpha_out + (int64_t)dev * b;
  for (int j = threadIdx.x; j < V.own; j += CTHREADS) out[V.lo + j] = L.alpha[j];
  if (V.rank == 0)
    for (int j = n + threadIdx.x; j < b; j += CTHREADS) out[j] = 0.f;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

int launch_cluster(const float* K, const float* y, const int* n_real, float* alpha, int g, int b,
                   float lam, int epochs, cudaStream_t stream) {
  const int stages = ring_stages(b);
  if (stages < 1 || (int64_t)g * CLUSTER > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // K as a (g b, b) fp32 tensor read in TILE x CH boxes
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(b), static_cast<cuuint64_t>(g) * b};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(b) * sizeof(float)};
  const cuuint32_t box[2] = {CH, TILE}, unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(K), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = cluster_smem_bytes(b);
  cudaError_t err = cudaFuncSetAttribute(sdca_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sdca_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  fc::ClusterLaunch launch(static_cast<unsigned>(g * CLUSTER), CTHREADS, CLUSTER, smem, stream);
  int clusters = 0;   // the card must hold one cluster of CLUSTER CTAs at this shared memory
  err = cudaOccupancyMaxActiveClusters(&clusters, sdca_cluster_kernel, &launch.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaLaunchKernelEx(&launch.cfg, sdca_cluster_kernel, map, K, y, n_real, alpha, b, lam,
                           epochs, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sdca_smem_bytes(int b) { return smem_bytes(b); }
extern "C" int sdca_cluster_smem_bytes(int b) { return cluster_smem_bytes(b); }

// matvec warps by bucket: 4 (8 rows each) up to b 1023, then one per 128
// columns up to 16 (the sums do not depend on it); past the shared-memory
// limit, the cluster kernel
extern "C" int sdca_launch(const float* K, const float* y, const int* n_real, float* alpha, int g,
                           int b, float lam, int epochs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_bytes(b) <= MAX_SMEM) {
    if (b >= 2048) return launch<16>(K, y, n_real, alpha, g, b, lam, epochs, st);
    if (b >= 1024) return launch<8>(K, y, n_real, alpha, g, b, lam, epochs, st);
    return launch<4>(K, y, n_real, alpha, g, b, lam, epochs, st);
  }
  return launch_cluster(K, y, n_real, alpha, g, b, lam, epochs, st);
}

// the cluster kernel at any bucket: the checks hold it to the one-block
// kernel where both run
extern "C" int sdca_cluster_launch(const float* K, const float* y, const int* n_real,
                                   float* alpha, int g, int b, float lam, int epochs,
                                   void* stream) {
  return launch_cluster(K, y, n_real, alpha, g, b, lam, epochs,
                        static_cast<cudaStream_t>(stream));
}
