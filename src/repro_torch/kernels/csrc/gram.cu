// fp32 RBF Gram tiles for Hopper (sm_90a):
//   out[t, i, j] = exp(-gamma_t * max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0))
// with a = x1[t] (m, d), b = x2[t] (n, d), fp32 in and out.
//
// Replaces two TPU kernels of the reference package, which tile the Gram
// over VMEM blocks and run the cross term in fp32 on the matrix unit:
//   repro/kernels/batched_gram.py::batched_rbf_gram_pallas  (per-device gamma, (g,))
//   repro/kernels/rbf_gram.py::rbf_gram_pallas              (one scalar gamma)
// Both launchers run one tile body, as two kernels (so a profile tells them
// apart), batched_rbf_gram_kernel and rbf_gram_kernel; each has its own
// wrapper and launch counter in Python.
//
// Arithmetic. The cross term runs on the bf16 tensor cores without rounding
// any operand below fp32. Every fp32 value v of both operands is split into
// three bf16 planes, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid) (both differences exact in fp32; two values a cvt.rn.bf16x2.f32),
// which carry v to within 2^-24 of itself. Of the nine plane products the
// six of order >= 2^-16 run as bf16 x bf16 mma.sync.m16n8k16 with fp32
// accumulation, whose products are exact, in one accumulator, smallest
// first: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi, k step after k step
// (PA / PB below). The feature dim is padded with zeros to the staged width,
// which adds exactly 0. TF32 alone would keep 10 bits of each operand, and
// the norm expansion cancels. The norms are fp32: the four threads that
// convert a staged row take a quarter of its features each, as an fmaf
// chain over ascending features, and the row's norm is (q0 + q1) + (q2 +
// q3) (for d > 64, chunk after chunk, added in order). The epilogue runs on
// the fragments: d2 = max(fmaf(-2, a.b, |a|^2 + |b|^2), 0), the plain
// version's rounding, and ex2.approx.ftz of -gamma log2(e) d2 (relative
// error ~2^-22). tests/test_torch_kernel_design.py::rbf_gram_split_emulated
// follows these steps on the CPU.
//
// Tiles. One block computes one BM x 64 tile of one device's Gram, BM = 16,
// 32 or 64 rows chosen by the host plan (kernels/batched_gram.py::tile_plan,
// from (m, n, d) alone, never g): the largest BM that leaves at most 1/5 of
// the computed rows past m. 4 BM threads: warps of 16 x 32 outputs (four
// m16n8 fragments, 16 fp32 accumulators a thread, 24 mma a k step). The
// block's BM rows of a and 64 rows of b arrive by cp.async, 16 bytes a copy
// where d % 4 == 0 and both operands are 16-byte aligned (4 bytes a copy
// otherwise), into fp32 rows padded by 16 bytes; each staged row is
// converted once into its three planes (bf16 rows padded by 16 bytes, so
// the 8 rows one ldmatrix reads fall on 8 distinct bank groups) with its
// norm, by four threads; the fragments are read by ldmatrix. 32 features
// are staged for d <= 32, else chunks of 64. A fit (x2 is x1) stages and
// converts a tile on the diagonal once, as both a and b. Rows past m and
// columns past n are computed on zeros and never stored: only the real
// (m, n) outputs are written, the reference's padding contract (a
// zero-padded row of the caller's gives exp(-gamma |x|^2) != 0; callers
// mask). Each fragment's column pair is one float2 store (a warp writes
// full 32-byte sectors) where n is even; a whole tile stores without checks.
// No atomics; an output depends on its row, its column and gamma alone,
// never on g, m, n or the plan.
//
// What holds it (PERF.md section 6, PR 19): instruction issue. The copy
// and conversion rounds are unrolled so each one's rows are known when the
// kernel is compiled, and the launch bound keeps three 256-thread blocks an
// SM (<= 85 registers, no spill; four spilled). One block a tile beat
// blocks that walk several tiles with the next tile's copies in flight,
// output tiles stored by the copy engine, wider tiles and smaller ones.
//
// Bound on the H100: bytes. At the engine's shapes (d = 32, b <= 256) each
// output costs ~70 operations against 4 bytes written; the tensor cores take
// the 64 of the cross term, and ~8 instructions a pair of epilogue remain on
// the CUDA cores, under the card's 20 fp32 operations a byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;           // columns per tile
constexpr int WN = 32;           // columns per warp
constexpr int WARPS_N = BN / WN;
constexpr int NT = WN / 8;       // n8 fragments a warp
constexpr int PLANES = 3;        // bf16 planes of each operand
constexpr int PRODUCTS = 6;      // plane products of order >= 2^-16
constexpr int KSTEP = 16;        // features per mma
constexpr int MAX_KSTEPS = 4;    // staged features: 32, or chunks of 64
constexpr int QUARTERS = 4;      // threads that convert one staged row
constexpr int SMEM_PER_SM = 232448;
constexpr int MAX_RESIDENT = 3;  // blocks an SM the launch bound asks for: 85 registers
                                 // a thread of a 256-thread block, no spill
constexpr float LOG2E = 1.4426950408889634f;

template <int BM, int KSTEPS>
struct Tile {
  static constexpr int THREADS = (BM / 16) * WARPS_N * 32;  // 4 BM: a staged row a 4 threads
  static constexpr int ROWS = BM + BN;        // staged rows: BM of a, then BN of b
  static constexpr int KP = KSTEPS * KSTEP;   // staged features
  static constexpr int QW = KP / QUARTERS;    // features a converting thread takes
  static constexpr int CPR = KP / 4;          // 16-byte copies a staged row
  static constexpr int RPI = THREADS / CPR;   // rows one round of copies covers
  static constexpr int RAW_LD = KP + 4;       // fp32 row stride: 16 bytes of padding
  static constexpr int LD = KP + 8;           // bf16 row stride: 16 bytes of padding
  static constexpr int RAW = ROWS * RAW_LD;   // floats
  static constexpr int PLANE = ROWS * LD;     // bf16 elements a plane
  static constexpr int BYTES = 4 * RAW + 2 * PLANES * PLANE + 4 * ROWS;
  // blocks an SM: as many as shared memory allows, at most MAX_RESIDENT;
  // the launch bound holds the registers to it
  static constexpr int BY_SMEM = SMEM_PER_SM / (BYTES + 1024);
  static constexpr int RESIDENT = BY_SMEM < MAX_RESIDENT ? BY_SMEM : MAX_RESIDENT;
  static_assert(THREADS == QUARTERS * BM && BN % BM == 0, "a round of conversion is BM rows");
  static_assert(BM % RPI == 0 && BN % RPI == 0, "a round of copies is all a or all b");
  static_assert(QW % 4 == 0, "a quarter is whole float4s");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// features k0 .. k0 + KP - 1 of the tile's rows into the raw tile: staged row
// r < BM is row r of a, row BM + r row r of b (none of b on the diagonal);
// rows past the real ones and features past d are left as they are (the
// conversion reads them as 0). Round i of the 16-byte copies takes staged
// rows i RPI .. (i + 1) RPI - 1, so whether it reads a or b is known when
// the kernel is compiled.
template <int BM, int KSTEPS>
__device__ __forceinline__ void stage(float* raw, const float* a, int a_rows, const float* b,
                                      int b_rows, int k0, int d, bool vec, int tid) {
  using T = Tile<BM, KSTEPS>;
  const int kc = min(T::KP, d - k0);
  if (vec) {  // a row of d = 32 is 8 copies by 8 neighbouring threads
    const int r = tid / T::CPR, c = 4 * (tid % T::CPR);
    const int64_t step = (int64_t)T::RPI * d;
    const float* pa = a + (int64_t)r * d + k0 + c;
    const float* pb = b + (int64_t)r * d + k0 + c;
    float* dst = raw + r * T::RAW_LD + c;
    if (c < kc) {
#pragma unroll
      for (int i = 0; i < T::ROWS / T::RPI; ++i) {
        constexpr int NA = BM / T::RPI;  // rounds of a
        if (i < NA) {
          if (r + i * T::RPI < a_rows) cp_async16(dst + i * T::RPI * T::RAW_LD, pa + i * step);
        } else {
          if (r + (i - NA) * T::RPI < b_rows)
            cp_async16(dst + i * T::RPI * T::RAW_LD, pb + (i - NA) * step);
        }
      }
    }
  } else {  // 4 bytes a copy: d % 4 != 0 or an operand not 16-byte aligned
    for (int e = tid; e < T::ROWS * T::KP; e += T::THREADS) {
      const int r = e / T::KP, c = e % T::KP;
      const bool in_a = r < BM;
      const int rr = in_a ? r : r - BM;
      if (c < kc && rr < (in_a ? a_rows : b_rows))
        cp_async4(raw + r * T::RAW_LD + c, (in_a ? a : b) + (int64_t)rr * d + k0 + c);
    }
  }
  cp_async_commit();
}

// four features v (those at or past `real` read as 0) -> their three planes
// at dst[0 .. 3] of each plane, and their squares into the fmaf chain
template <bool MASKED>
__device__ __forceinline__ void split4(float4 v, int real, __nv_bfloat16* dst, int plane,
                                       float& nrm) {
  float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (MASKED) w[j] = j < real ? w[j] : 0.f;
    nrm = fmaf(w[j], w[j], nrm);  // a padded feature adds exactly 0
  }
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
    *reinterpret_cast<uint2*>(dst + q * plane) = make_uint2(out[q][0], out[q][1]);
}

// the raw tile -> three bf16 planes and the rows' norms. In round i thread
// (r, h) takes features h QW .. (h + 1) QW - 1 of staged row i BM + r: round
// 0 converts the a rows, rounds 1 .. the b rows (skipped on the diagonal);
// the four threads of a row are neighbouring lanes of one warp.
template <int BM, int KSTEPS>
__device__ __forceinline__ void convert(__nv_bfloat16* planes, float* sq, const float* raw,
                                        int a_rows, int b_rows, bool diag, int k0, int d,
                                        int tid) {
  using T = Tile<BM, KSTEPS>;
  const int r = tid / QUARTERS, h = tid % QUARTERS;
  const int c0 = h * T::QW;
#pragma unroll
  for (int i = 0; i < T::ROWS / BM; ++i) {
    if (i > 0 && diag) break;
    const int row = i * BM + r;
    const int real = (i == 0 ? r < a_rows : (i - 1) * BM + r < b_rows) ? d - (k0 + c0) : 0;
    const float* src = raw + row * T::RAW_LD + c0;
    __nv_bfloat16* dst = planes + row * T::LD + c0;
    float nrm = 0.f;
    if (real >= T::QW) {
#pragma unroll
      for (int c = 0; c < T::QW; c += 4)
        split4<false>(*reinterpret_cast<const float4*>(src + c), 4, dst + c, T::PLANE, nrm);
    } else {
#pragma unroll
      for (int c = 0; c < T::QW; c += 4)
        split4<true>(*reinterpret_cast<const float4*>(src + c), real - c, dst + c, T::PLANE,
                     nrm);
    }
    // (q0 + q1) + (q2 + q3), the same bits in the row's four lanes
    nrm = __fadd_rn(nrm, __shfl_xor_sync(0xffffffffu, nrm, 1));
    nrm = __fadd_rn(nrm, __shfl_xor_sync(0xffffffffu, nrm, 2));
    if (h == 0) sq[row] = k0 == 0 ? nrm : __fadd_rn(sq[row], nrm);
  }
}

template <int BM, int KSTEPS>
__device__ __forceinline__ void gram_tile(const float* __restrict__ x1,
                                          const float* __restrict__ x2, float gamma,
                                          float* __restrict__ out, int m, int n, int d) {
  using T = Tile<BM, KSTEPS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);                             // [ROWS][RAW_LD]
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(raw + T::RAW);  // [PLANES][ROWS][LD]
  float* sq = reinterpret_cast<float*>(planes + PLANES * T::PLANE);       // [ROWS]

  const int t = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int a_rows = min(BM, m - row0), b_rows = min(BN, n - col0);
  const float* a = x1 + ((int64_t)t * m + row0) * d;
  const float* b = x2 + ((int64_t)t * n + col0) * d;
  const bool vec = (d & 3) == 0 && ((reinterpret_cast<uintptr_t>(x1) |
                                     reinterpret_cast<uintptr_t>(x2)) & 15) == 0;
  // a fit (x2 is x1): a tile on the diagonal stages and converts its rows once,
  // as both a and b
  const bool diag = BM == BN && x1 == x2 && m == n && row0 == col0;
  const int boff = diag ? 0 : BM;  // staged row of the tile's first column

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  // the products, smallest first: lo.hi, mid.mid, hi.lo, mid.hi, hi.mid, hi.hi
  // (plane of a, plane of b; 0 hi, 1 mid, 2 lo)
  constexpr int PA[PRODUCTS] = {2, 1, 0, 1, 0, 0};
  constexpr int PB[PRODUCTS] = {0, 1, 2, 0, 1, 0};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < d; k0 += T::KP) {
    // (for d > 64, every warp has read the last chunk's planes before the
    // barrier after the copies, and the conversion overwrites them after it)
    stage<BM, KSTEPS>(raw, a, a_rows, b, diag ? 0 : b_rows, k0, d, vec, tid);
    cp_async_wait_all();
    __syncthreads();
    convert<BM, KSTEPS>(planes, sq, raw, a_rows, b_rows, diag, k0, d, tid);
    __syncthreads();

    const __nv_bfloat16* A = planes + (16 * wm) * T::LD;
    const __nv_bfloat16* B = planes + (boff + WN * wn) * T::LD;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t af[PLANES][4], bf[PLANES][NT / 2][4];  // bf[p][jp]: n tiles 2 jp, 2 jp + 1
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const int mi = lane / 8;
        ldmatrix_x4(af[p], A + p * T::PLANE + ((mi & 1) * 8 + lane % 8) * T::LD + ks * KSTEP +
                               (mi >> 1) * 8);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp)
          ldmatrix_x4(bf[p][jp], B + p * T::PLANE +
                                     (jp * 16 + (lane / 16) * 8 + lane % 8) * T::LD +
                                     ks * KSTEP + ((lane / 8) & 1) * 8);
      }
#pragma unroll
      for (int q = 0; q < PRODUCTS; ++q)
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma_bf16(acc[2 * jp], af[PA[q]], bf[PB[q]][jp][0], bf[PB[q]][jp][1]);
          mma_bf16(acc[2 * jp + 1], af[PA[q]], bf[PB[q]][jp][2], bf[PB[q]][jp][3]);
        }
    }
  }

  // epilogue on the fragments: rows 16 wm + g (+ 8), columns 32 wn + 8 nt + c2 (+ 1)
  const int g = lane / 4, c2 = (lane % 4) * 2;
  const float ngl2 = -gamma * LOG2E;
  const int cl = WN * wn + c2;  // + 8 nt
  // a whole tile (every row and column real, n even) stores without checks
  const bool whole = a_rows == BM && b_rows == BN && (n & 1) == 0;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rl = 16 * wm + hf * 8 + g;
    const float rsq = sq[rl];
    float* o = out + ((int64_t)t * m + row0 + rl) * n + col0 + cl;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 sb = *reinterpret_cast<const float2*>(sq + boff + cl + 8 * nt);
      const float d0 = fmaxf(fmaf(-2.f, acc[nt][2 * hf], __fadd_rn(rsq, sb.x)), 0.f);
      const float d1 = fmaxf(fmaf(-2.f, acc[nt][2 * hf + 1], __fadd_rn(rsq, sb.y)), 0.f);
      const float v0 = ex2(ngl2 * d0), v1 = ex2(ngl2 * d1);
      const int c = cl + 8 * nt;  // column within the tile
      if (whole) {
        *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(v0, v1);
      } else if (rl < a_rows) {
        if ((n & 1) == 0 && c + 1 < b_rows) {
          *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(v0, v1);
        } else {
          if (c < b_rows) o[8 * nt] = v0;
          if (c + 1 < b_rows) o[8 * nt + 1] = v1;
        }
      }
    }
  }
}

template <int BM, int KSTEPS>
__global__ void __launch_bounds__(Tile<BM, KSTEPS>::THREADS, Tile<BM, KSTEPS>::RESIDENT)
batched_rbf_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                        const float* __restrict__ gammas, float* __restrict__ out, int m, int n,
                        int d) {
  gram_tile<BM, KSTEPS>(x1, x2, gammas[blockIdx.z], out, m, n, d);
}

template <int BM, int KSTEPS>
__global__ void __launch_bounds__(Tile<BM, KSTEPS>::THREADS, Tile<BM, KSTEPS>::RESIDENT)
rbf_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2, float gamma,
                float* __restrict__ out, int m, int n, int d) {
  gram_tile<BM, KSTEPS>(x1, x2, gamma, out, m, n, d);
}

template <class Kernel, class... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, int bytes, cudaStream_t stream,
                  Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// one launch of one tile height: per-device gammas when `gammas` is given,
// else the scalar
template <int BM, int KSTEPS>
int launch(const float* x1, const float* x2, const float* gammas, float gamma, float* out, int g,
           int m, int n, int d, cudaStream_t stream) {
  using T = Tile<BM, KSTEPS>;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
  if (gammas != nullptr)
    return launch_kernel(batched_rbf_gram_kernel<BM, KSTEPS>, grid, T::THREADS, T::BYTES, stream,
                         x1, x2, gammas, out, m, n, d);
  return launch_kernel(rbf_gram_kernel<BM, KSTEPS>, grid, T::THREADS, T::BYTES, stream, x1, x2,
                       gamma, out, m, n, d);
}

template <int BM>
int launch_staged(const float* x1, const float* x2, const float* gammas, float gamma, float* out,
                  int g, int m, int n, int d, int staged, cudaStream_t stream) {
  switch (staged) {  // the plan's staged features: 32, or chunks of 64
    case 32: return launch<BM, 2>(x1, x2, gammas, gamma, out, g, m, n, d, stream);
    case 64: return launch<BM, MAX_KSTEPS>(x1, x2, gammas, gamma, out, g, m, n, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const float* x1, const float* x2, const float* gammas, float gamma, float* out,
             int g, int m, int n, int d, int rows, int staged, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {  // the plan's rows a tile
    case 16: return launch_staged<16>(x1, x2, gammas, gamma, out, g, m, n, d, staged, s);
    case 32: return launch_staged<32>(x1, x2, gammas, gamma, out, g, m, n, d, staged, s);
    case 64: return launch_staged<64>(x1, x2, gammas, gamma, out, g, m, n, d, staged, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int batched_rbf_gram_launch(const float* x1, const float* x2, const float* gammas,
                                       float* out, int g, int m, int n, int d, int rows,
                                       int staged, void* stream) {
  return dispatch(x1, x2, gammas, 0.f, out, g, m, n, d, rows, staged, stream);
}

extern "C" int rbf_gram_launch(const float* x1, const float* x2, float gamma, float* out, int m,
                               int n, int d, int rows, int staged, void* stream) {
  return dispatch(x1, x2, nullptr, gamma, out, 1, m, n, d, rows, staged, stream);
}
