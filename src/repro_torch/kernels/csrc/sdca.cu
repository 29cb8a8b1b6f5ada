// Cyclic SDCA on the hinge-loss dual as a tiled, delayed-update solve with
// fp64 sums, one block per device (sm_90a).
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
// Buckets whose v, alpha and y outgrow shared memory (smem_bytes(b) > 227
// KB, b > 12,384) take the same kernel with those three in global memory
// (GLOBAL): v in a (g, b) fp64 scratch, alpha in the output, y read where it
// lies; 16 bytes a coordinate, 256 KB a device at b 16,384, which stay in the
// 50 MB L2. The tile blocks and sums stay in shared memory. The order of
// every sum and step is unchanged, so at a bucket both take the two give the
// same alphas bit for bit. __syncthreads makes warp 0's global writes of a
// tile visible to the matvec warps, as it does its shared ones.
//
// Arithmetic follows the reference step by step: f = s / (lam * n_real) with
// lam * n_real in fp32; step = grad * lam * n_real / max(K[i,i], 1e-8);
// alpha_i = clip(alpha_i + step, 0, 1). Coordinates i >= n_real stay 0, which
// the reference reaches by masking: its steps for them write 0 into an alpha
// that is already 0, so they are skipped here, and so are the j >= n_real
// terms of each dot, whose alpha is 0.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

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

// the tile blocks alone: what the GLOBAL instantiation keeps in shared memory
__host__ __device__ constexpr int block_bytes() {
  return static_cast<int>(sizeof(double)) * (2 * TILE + 4 * TILE * LD);
}
__host__ __device__ inline int smem_bytes(int b) {
  return block_bytes() + static_cast<int>(sizeof(double)) * b +
         static_cast<int>(sizeof(float)) * 2 * b;
}

// shared: v, alpha and y after the blocks (y copied in by the kernel);
// GLOBAL: v in the device's row of the scratch, alpha in its output row, y
// its input row
template <bool GLOBAL>
__device__ inline Layout carve(unsigned char* raw, int b, double* v, float* alpha,
                               const float* y) {
  Layout L;
  L.part = reinterpret_cast<double*>(raw);
  L.dy = L.part + 2 * TILE;
  L.by = L.dy + 2 * TILE * LD;
  if constexpr (GLOBAL) {
    L.v = v;
    L.alpha = alpha;
    L.ys = y;
  } else {
    L.v = L.by + 2 * TILE * LD;
    L.alpha = reinterpret_cast<float*>(L.v + b);
    L.ys = L.alpha + b;
  }
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

template <int NMW, bool GLOBAL>
__global__ void __launch_bounds__(32 * (NMW + 1))
sdca_kernel(const float* __restrict__ K, const float* __restrict__ y,
            const int* __restrict__ n_real, float* __restrict__ alpha_out,
            double* __restrict__ v_scratch, int b, float lam, int epochs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dev = blockIdx.x;
  const Layout L = carve<GLOBAL>(smem_raw, b, v_scratch + (int64_t)dev * b,
                                 alpha_out + (int64_t)dev * b, y + (int64_t)dev * b);

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
    if constexpr (!GLOBAL) const_cast<float*>(L.ys)[j] = y[(int64_t)dev * b + j];
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
  if constexpr (!GLOBAL)
    for (int j = threadIdx.x; j < b; j += blockDim.x)
      alpha_out[(int64_t)dev * b + j] = L.alpha[j];
}

template <int NMW, bool GLOBAL>
int launch(const float* K, const float* y, const int* n_real, float* alpha, double* v, int g,
           int b, float lam, int epochs, cudaStream_t stream) {
  const int smem = GLOBAL ? block_bytes() : smem_bytes(b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdca_kernel<NMW, GLOBAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sdca_kernel<NMW, GLOBAL><<<g, 32 * (NMW + 1), smem, stream>>>(K, y, n_real, alpha, v, b, lam,
                                                                 epochs);
  return static_cast<int>(cudaGetLastError());
}

// matvec warps by bucket: 4 (8 rows each) up to b 1023, then one per 128
// columns up to 16 (the sums do not depend on it)
template <bool GLOBAL>
int launch_by_bucket(const float* K, const float* y, const int* n_real, float* alpha,
                     double* v, int g, int b, float lam, int epochs, cudaStream_t st) {
  if (b >= 2048) return launch<16, GLOBAL>(K, y, n_real, alpha, v, g, b, lam, epochs, st);
  if (b >= 1024) return launch<8, GLOBAL>(K, y, n_real, alpha, v, g, b, lam, epochs, st);
  return launch<4, GLOBAL>(K, y, n_real, alpha, v, g, b, lam, epochs, st);
}

}  // namespace

extern "C" int sdca_smem_bytes(int b) { return smem_bytes(b); }

// ``v`` is a (g, b) fp64 scratch, read only past the shared-memory limit,
// where v, alpha and y go to global memory (it may be null below it)
extern "C" int sdca_launch(const float* K, const float* y, const int* n_real, float* alpha,
                           double* v, int g, int b, float lam, int epochs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_bytes(b) <= MAX_SMEM)
    return launch_by_bucket<false>(K, y, n_real, alpha, v, g, b, lam, epochs, st);
  if (v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_by_bucket<true>(K, y, n_real, alpha, v, g, b, lam, epochs, st);
}

// the global-memory instantiation at any bucket: the checks hold it bit for
// bit to the shared one where both run
extern "C" int sdca_global_launch(const float* K, const float* y, const int* n_real,
                                  float* alpha, double* v, int g, int b, float lam, int epochs,
                                  void* stream) {
  if (v == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_by_bucket<true>(K, y, n_real, alpha, v, g, b, lam, epochs,
                                static_cast<cudaStream_t>(stream));
}
