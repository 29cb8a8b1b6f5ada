// RBF Gram against per-column affine int8 supports, for Hopper (sm_90a):
//   out[i, j] = exp(-gamma * max(|x_i|^2 + |s_j|^2 - 2 x_i.s_j, 0)),
//   s_j[c] = q[j, c] * scale[c] + zero[c]
// with x (m, d) fp32, q (n, d) int8, scale and zero (d,) fp32, out (m, n) fp32.
//
// Replaces repro/kernels/rbf_gram_q8.py::rbf_gram_q8_pallas (TPU), which
// dequantises each int8 tile in VMEM and runs the fp32 Gram tile on it. Here
// the cross term runs on the bf16 tensor cores without rounding any operand
// below fp32:
//
//   x.s_j = sum_c (x[c] * scale[c]) q[j, c] + sum_c x[c] zero[c]
//
// Every int8 value is exact in bf16. x' = x * scale (one rounded fp32
// multiply) is split into three bf16 planes, hi = bf16(x'), mid = bf16(x' -
// hi), lo = bf16(x' - hi - mid) (both differences exact in fp32), which
// carry x' to within 2^-24 of itself. Each plane times q is a bf16 x bf16
// mma.sync.m16n8k16 with fp32 accumulation, whose products are exact; the
// three run into one accumulator, hi, mid, lo, k step after k step. The
// zero-point term x.zero is one fp32 dot per query row, added once. The
// norms are fp32: |x_i|^2 an fmaf chain over ascending features, |s_j|^2 of
// s dequantised as the plain version does it (a rounded multiply, then a
// rounded add), as two fmaf chains over the halves of the padded feature
// range, added (the two threads that convert a support row take one half
// each). tests/test_torch_kernel_design.py::rbf_gram_q8_split_emulated
// follows these steps on the CPU.
//
// Blocks. Block (stripe, split) owns a stripe of BM = 64 query rows and
// walks support tiles split * per_split .. of BN = 128 rows
// (kernels/rbf_gram_q8.py::split_plan: three blocks an SM, one wave). Once
// a block it stages the stripe's three planes (bf16, padded rows), its row
// norms and x.zero in shared memory. Each int8 support tile is copied raw
// (16-byte cp.async; a tile of 128 rows is one contiguous run of 128 d bytes,
// zero-filled past n) through a two-slot ring, converted once to a padded
// bf16 tile with its support norms, and read by ldmatrix. Tile t + 2 is
// loaded and tile t + 1 converted while tile t is multiplied, with one
// barrier a tile. The feature dim is padded with zeros to a multiple of 16
// in the planes and in q, which adds exactly 0. Rows past m and supports
// past n are computed and never stored: only the real (m, n) outputs are
// written, the reference's padding contract. No atomics; an output's value
// depends on its row and its support alone, never on m, n or the split.
//
// Warps. 8 warps as 2 x 4; warp (wm, wn) owns rows 32 wm .. 32 wm + 31 and
// supports 32 wn .. 32 wn + 31 of the 64 x 128 tile: 2 x 4 fragments of
// m16n8, 32 fp32 accumulators a thread, 24 mma a k step. (128-row stripes
// with 4 x 2 warps of 32 x 64 need 124 registers, so two blocks an SM: 6 %
// slower at the student's shape, PERF.md section 6.) Rows of the
// shared tiles are padded by 16 bytes, so the 8 rows one ldmatrix reads fall
// on 8 distinct bank groups. The epilogue runs on the fragments: cross =
// acc + x.zero, d2 = max(|x|^2 + |s|^2 - 2 cross, 0), ex2.approx.ftz of
// -gamma log2(e) d2 (relative error ~2^-22), each fragment's column pair
// stored as one float2 (full 32-byte sectors a warp) where n is even.
//
// Feature dims past 128 (MAX_KSTEPS k steps) take a chunked instantiation,
// gram_q8_chunked_kernel: the same blocks, warps and fragments, but the
// feature dim goes in chunks of CK = 128 features. For each support tile the
// block walks the chunks in order: it stages the chunk's three planes of
// x * scale (from x, which stays in L2) and converts the tile's int8 chunk to
// bf16 (plain loads: a chunk of a row is not 16-byte aligned when d % 16 !=
// 0), then runs the chunk's k steps into the same accumulators, carried
// across chunks. So the mma sequence is the staged kernel's, k step after k
// step, hi, mid, lo; |x|^2 and x.zero are the same fmaf chains (from global
// memory, once a block); each support norm is the same two chains over the
// halves of the padded feature range, each thread of a row's pair carrying
// its half's chain across the chunks. Where both run (d <= 128) the two give
// the same bits; the launcher takes the staged kernel there.
//
// Bound on the H100: bytes. At the student's 8192 x 4096 x 32 the 134 MB
// output takes 0.040 ms at 3.35 TB/s; the tensor-core work (3 planes) is
// ~6.4 GFLOP of bf16, the epilogue ~6 instructions a pair on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block (a stripe)
constexpr int BN = 128;       // supports per tile
constexpr int THREADS = 256;  // 8 warps as 2 (rows) x 4 (supports)
constexpr int BLOCKS_PER_SM = 3;  // resident blocks an SM (registers: 85 a thread)
constexpr int WM = 32;        // rows per warp
constexpr int WN = 32;        // supports per warp
constexpr int WARPS_N = BN / WN;
constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 fragments a warp
static_assert((BM / WM) * WARPS_N * 32 == THREADS && BN * 2 == THREADS, "tile shape");
constexpr int PLANES = 3;     // bf16 planes of x * scale
constexpr int KSTEP = 16;     // features per mma
constexpr int MAX_KSTEPS = 8; // the staged kernel's d <= 128; also a chunk's k steps
constexpr int CK = MAX_KSTEPS * KSTEP;  // features a chunk of the chunked kernel stages
constexpr float LOG2E = 1.4426950408889634f;

template <int KSTEPS>
struct Layout {
  static constexpr int KP = KSTEPS * KSTEP;  // padded feature dim
  static constexpr int LD = KP + 8;          // bf16 row stride: 16 bytes of padding
  static constexpr int XP = PLANES * BM * LD;  // the stripe's planes (bf16 elements)
  static constexpr int BQ = 2 * BN * LD;       // two converted support tiles
  static constexpr int RAW = 2 * BN * KP;      // two raw int8 tiles (bytes)
  static constexpr int BYTES =
      2 * (XP + BQ) + RAW + 4 * (2 * BN + 2 * BM + 2 * KP);  // + norms, x.zero, scale, zero
};

// the chunked kernel: the stripe's planes and one converted support tile, a
// chunk of CK features each, then the support norms, |x|^2, x.zero and the
// chunk's scale and zero
struct ChunkLayout {
  static constexpr int LD = CK + 8;
  static constexpr int XP = PLANES * BM * LD;
  static constexpr int BT = BN * LD;
  static constexpr int BYTES = 2 * (XP + BT) + 4 * (BN + 2 * BM + 2 * CK);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; bytes past `valid` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid));
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

// one raw tile: supports j0 .. j0 + BN - 1 are the bytes [j0 d, (j0 + BN) d) of
// q, contiguous, 16-byte aligned (j0 is a multiple of 128, q is aligned)
__device__ __forceinline__ void load_raw(int8_t* dst, const int8_t* q, int64_t j0, int n,
                                         int d, int tid) {
  const int64_t base = j0 * d, end = (int64_t)n * d;
  const int chunks = BN * d / 16;
  for (int i = tid; i < chunks; i += THREADS) {
    const int64_t off = base + 16 * i;
    const int64_t left = end - off;
    const int valid = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
    cp_async16(dst + 16 * i, q + (valid > 0 ? off : 0), valid);
  }
}

// raw tile -> bf16 tile [BN][LD] and the support norms. Thread t converts
// half t % 2 of row t / 2 (features h KP/2 .. (h + 1) KP/2 - 1) and takes the
// norm of its half's real features as an fmaf chain; the row's norm is
// (half 0) + (half 1).
template <int KSTEPS>
__device__ __forceinline__ void convert_tile(__nv_bfloat16* Bt, float* sqs, const int8_t* raw,
                                             const float* sc, const float* ze, int d, int tid) {
  constexpr int KP = Layout<KSTEPS>::KP, LD = Layout<KSTEPS>::LD, HALF = KP / 2;
  const int r = tid >> 1, h = tid & 1;
  const int c0 = h * HALF;
  const int8_t* src = raw + r * d;
  __nv_bfloat16* dst = Bt + r * LD + c0;
  float nrm = 0.f;
#pragma unroll
  for (int c = 0; c < HALF; c += 2) {
    const int g0 = c0 + c, g1 = g0 + 1;
    const bool v0 = g0 < d, v1 = g1 < d;
    const float q0 = v0 ? static_cast<float>(src[g0]) : 0.f;
    const float q1 = v1 ? static_cast<float>(src[g1]) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(q0, q1);  // exact
    if (v0) {
      const float s = __fadd_rn(__fmul_rn(q0, sc[g0]), ze[g0]);
      nrm = fmaf(s, s, nrm);
    }
    if (v1) {
      const float s = __fadd_rn(__fmul_rn(q1, sc[g1]), ze[g1]);
      nrm = fmaf(s, s, nrm);
    }
  }
  const float other = __shfl_xor_sync(0xffffffffu, nrm, 1);
  if (h == 0) sqs[r] = __fadd_rn(nrm, other);
}

// one k step of 16 features: the tile's B fragments, then the three planes'
// A fragments, each into the same accumulators (column ks * KSTEP of tiles
// whose bf16 rows are ld apart)
__device__ __forceinline__ void mma_kstep(float (&acc)[MT][NT][4], const __nv_bfloat16* Xp,
                                          const __nv_bfloat16* Bt, int ld, int ks, int wm,
                                          int wn, int lane) {
  uint32_t bf[NT / 2][4];  // n tiles 2 jp, 2 jp + 1
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp)
    ldmatrix_x4(bf[jp], Bt + (wn * WN + jp * 16 + (lane / 16) * 8 + lane % 8) * ld +
                            ks * KSTEP + ((lane / 8) & 1) * 8);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int mi = lane / 8;
      ldmatrix_x4(af[mt], Xp + p * BM * ld + (wm * WM + mt * 16 + (mi & 1) * 8 + lane % 8) * ld +
                              ks * KSTEP + (mi >> 1) * 8);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        mma_bf16(acc[mt][2 * jp], af[mt], bf[jp][0], bf[jp][1]);
        mma_bf16(acc[mt][2 * jp + 1], af[mt], bf[jp][2], bf[jp][3]);
      }
  }
}

// the epilogue on the fragments of support tile `tile`: cross = acc + x.zero,
// d2, the RBF, and the real (m, n) outputs stored; sq holds the tile's
// support norms
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4],
                                           const float (&rsq)[MT][2], const float (&rxz)[MT][2],
                                           const float* sq, float ngl2, float* out, int m,
                                           int n, int row0, int tile, int wm, int wn,
                                           int lane) {
  const int g = lane / 4, c2 = (lane % 4) * 2;  // fragment row group and column pair
  const bool pairs = (n & 1) == 0;
  const int col_t = tile * BN + wn * WN + c2;  // + nt * 8
  const float* sq_t = sq + wn * WN + c2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 s = *reinterpret_cast<const float2*>(sq_t + nt * 8);
    const int c = col_t + nt * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row0 + wm * WM + mt * 16 + hf * 8 + g;
        const float cr0 = __fadd_rn(acc[mt][nt][2 * hf], rxz[mt][hf]);
        const float cr1 = __fadd_rn(acc[mt][nt][2 * hf + 1], rxz[mt][hf]);
        const float d0 = fmaxf(fmaf(-2.f, cr0, __fadd_rn(rsq[mt][hf], s.x)), 0.f);
        const float d1 = fmaxf(fmaf(-2.f, cr1, __fadd_rn(rsq[mt][hf], s.y)), 0.f);
        const float k0 = ex2(ngl2 * d0), k1 = ex2(ngl2 * d1);
        if (r < m) {
          float* o = out + (int64_t)r * n + c;
          if (pairs && c + 1 < n) {
            *reinterpret_cast<float2*>(o) = make_float2(k0, k1);
          } else {
            if (c < n) o[0] = k0;
            if (c + 1 < n) o[1] = k1;
          }
        }
      }
  }
}

// the thread's four rows' |x|^2 and x.zero (rows wm * 32 + mt * 16 + hf * 8 + g)
__device__ __forceinline__ void row_terms(float (&rsq)[MT][2], float (&rxz)[MT][2],
                                          const float* sqx, const float* xz, int wm, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * WM + mt * 16 + hf * 8 + lane / 4;
      rsq[mt][hf] = sqx[r];
      rxz[mt][hf] = xz[r];
    }
}

// |x_i|^2 and x_i.zero of the stripe's rows, fmaf chains over ascending
// features read from global memory, into sqx[BM] and xz[BM]
__device__ __forceinline__ void stripe_terms(float* sqx, float* xz, const float* x,
                                             const float* zero, int m, int d, int row0,
                                             int tid) {
  if (tid < BM) {
    float s2 = 0.f, sz = 0.f;
    if (row0 + tid < m) {
      const float* xr = x + (int64_t)(row0 + tid) * d;
      for (int c = 0; c < d; ++c) {
        const float v = xr[c];
        s2 = fmaf(v, v, s2);
        sz = fmaf(v, __ldg(zero + c), sz);
      }
    }
    sqx[tid] = s2;
    xz[tid] = sz;
  }
}

// x * scale's three bf16 planes: hi, mid = bf16(xs - hi), lo = bf16(xs - hi - mid)
__device__ __forceinline__ void split3(__nv_bfloat16* Xp, int plane, int idx, float xs) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(xs);
  const float r1 = __fsub_rn(xs, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const float r2 = __fsub_rn(r1, __bfloat162float(mid));
  Xp[idx] = hi;
  Xp[plane + idx] = mid;
  Xp[2 * plane + idx] = __float2bfloat16_rn(r2);
}

template <int KSTEPS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gram_q8_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, const float* __restrict__ zero, float gamma,
               float* __restrict__ out, int m, int n, int d, int per_split) {
  using L = Layout<KSTEPS>;
  constexpr int KP = L::KP, LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xp = reinterpret_cast<__nv_bfloat16*>(smem);  // [PLANES][BM][LD]
  __nv_bfloat16* Bq = Xp + L::XP;                                // [2][BN][LD]
  int8_t* raw = reinterpret_cast<int8_t*>(Bq + L::BQ);           // [2][BN * KP]
  float* sqs = reinterpret_cast<float*>(raw + L::RAW);           // [2][BN]
  float* sqx = sqs + 2 * BN;                                     // [BM]
  float* xz = sqx + BM;                                          // [BM]
  float* sc = xz + BM;                                           // [KP]
  float* ze = sc + KP;                                           // [KP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const int tiles = (n + BN - 1) / BN;
  const int t0 = blockIdx.y * per_split;
  const int T = min(per_split, tiles - t0);

  // first raw tiles in flight while the x side is staged
  load_raw(raw, q, (int64_t)t0 * BN, n, d, tid);
  cp_async_commit();
  if (T > 1) load_raw(raw + BN * KP, q, (int64_t)(t0 + 1) * BN, n, d, tid);
  cp_async_commit();

  for (int c = tid; c < KP; c += THREADS) {
    sc[c] = c < d ? scale[c] : 0.f;
    ze[c] = c < d ? zero[c] : 0.f;
  }
  __syncthreads();

  // the stripe's three planes of x * scale
  for (int e = tid; e < BM * KP; e += THREADS) {
    const int r = e / KP, c = e % KP;
    const bool valid = row0 + r < m && c < d;
    split3(Xp, BM * LD, r * LD + c,
           valid ? __fmul_rn(x[(int64_t)(row0 + r) * d + c], sc[c]) : 0.f);
  }
  // each row's |x|^2 and x.zero, fmaf chains over ascending features
  stripe_terms(sqx, xz, x, zero, m, d, row0, tid);

  cp_async_wait_all();  // (also waits for tile t0 + 1; the ring is only two deep)
  __syncthreads();
  convert_tile<KSTEPS>(Bq, sqs, raw, sc, ze, d, tid);
  __syncthreads();

  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float rsq[MT][2], rxz[MT][2];
  row_terms(rsq, rxz, sqx, xz, wm, lane);
  const float ngl2 = -gamma * LOG2E;

  for (int i = 0; i < T; ++i) {
    const int buf = i & 1;
    if (i + 2 < T)  // raw slot buf held tile i, converted before the last barrier
      load_raw(raw + buf * BN * KP, q, (int64_t)(t0 + i + 2) * BN, n, d, tid);
    cp_async_commit();
    if (i + 1 < T)  // converted slot buf ^ 1 was last read before the last barrier
      convert_tile<KSTEPS>(Bq + (buf ^ 1) * BN * LD, sqs + (buf ^ 1) * BN,
                              raw + (buf ^ 1) * BN * KP, sc, ze, d, tid);

    const __nv_bfloat16* Bt = Bq + buf * BN * LD;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) mma_kstep(acc, Xp, Bt, LD, ks, wm, wn, lane);

    store_tile(acc, rsq, rxz, sqs + buf * BN, ngl2, out, m, n, row0, t0 + i, wm, wn, lane);
    cp_async_wait_all();
    __syncthreads();
  }
}

// Any d: the feature dim in chunks of CK (see the header). Per support tile,
// per chunk: one barrier before the chunk's scale and zero are staged, one
// before the planes and the bf16 tile are read; the tile's norms and the
// epilogue after the last chunk.
__global__ void __launch_bounds__(THREADS, 2)
gram_q8_chunked_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, const float* __restrict__ zero,
                       float gamma, float* __restrict__ out, int m, int n, int d,
                       int per_split) {
  using L = ChunkLayout;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Xp = reinterpret_cast<__nv_bfloat16*>(smem);  // [PLANES][BM][LD]
  __nv_bfloat16* Bt = Xp + L::XP;                                // [BN][LD]
  float* sqs = reinterpret_cast<float*>(Bt + L::BT);             // [BN]
  float* sqx = sqs + BN;                                         // [BM]
  float* xz = sqx + BM;                                          // [BM]
  float* sc = xz + BM;                                           // [CK]
  float* ze = sc + CK;                                           // [CK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const int tiles = (n + BN - 1) / BN;
  const int t0 = blockIdx.y * per_split;
  const int T = min(per_split, tiles - t0);
  const int kp = (d + KSTEP - 1) / KSTEP * KSTEP;  // the padded feature dim
  const int half = kp / 2;                         // the support norms' two chains
  const int chunks = (kp + CK - 1) / CK;

  stripe_terms(sqx, xz, x, zero, m, d, row0, tid);
  __syncthreads();
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float rsq[MT][2], rxz[MT][2];
  row_terms(rsq, rxz, sqx, xz, wm, lane);
  const float ngl2 = -gamma * LOG2E;
  const int nr = tid >> 1, nh = tid & 1;  // the norm chain this thread carries: row, half

  for (int i = 0; i < T; ++i) {
    const int64_t j0 = (int64_t)(t0 + i) * BN;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    float nrm = 0.f;

    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * CK;
      __syncthreads();  // every warp is done with the last chunk's tiles
      for (int c = tid; c < CK; c += THREADS) {
        sc[c] = c0 + c < d ? __ldg(scale + c0 + c) : 0.f;
        ze[c] = c0 + c < d ? __ldg(zero + c0 + c) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < BM * CK; e += THREADS) {
        const int r = e / CK, c = e % CK;
        const bool valid = row0 + r < m && c0 + c < d;
        split3(Xp, BM * LD, r * LD + c,
               valid ? __fmul_rn(x[(int64_t)(row0 + r) * d + c0 + c], sc[c]) : 0.f);
      }
      // the tile's int8 chunk, a pair of features a thread at a time, exact in bf16
      for (int e = tid; e < BN * CK / 2; e += THREADS) {
        const int r = e / (CK / 2), c = 2 * (e % (CK / 2));
        const int64_t j = j0 + r;
        const int g = c0 + c;
        const int8_t* src = q + j * d + g;
        const float q0 = j < n && g < d ? static_cast<float>(__ldg(src)) : 0.f;
        const float q1 = j < n && g + 1 < d ? static_cast<float>(__ldg(src + 1)) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(Bt + r * LD + c) = __floats2bfloat162_rn(q0, q1);
      }
      __syncthreads();
      {  // this chunk's part of the thread's half of its row's norm, ascending
        const int lo = max(c0, nh * half), hi = min(min(c0 + CK, d), (nh + 1) * half);
        const __nv_bfloat16* br = Bt + nr * LD - c0;
        for (int g = lo; g < hi; ++g) {
          const float s = __fadd_rn(__fmul_rn(__bfloat162float(br[g]), sc[g - c0]), ze[g - c0]);
          nrm = fmaf(s, s, nrm);
        }
      }
      const int ksteps = min(MAX_KSTEPS, (kp - c0) / KSTEP);
#pragma unroll
      for (int ks = 0; ks < MAX_KSTEPS; ++ks)
        if (ks < ksteps) mma_kstep(acc, Xp, Bt, LD, ks, wm, wn, lane);
    }
    const float other = __shfl_xor_sync(0xffffffffu, nrm, 1);
    if (nh == 0) sqs[nr] = __fadd_rn(nrm, other);
    __syncthreads();
    store_tile(acc, rsq, rxz, sqs, ngl2, out, m, n, row0, t0 + i, wm, wn, lane);
  }
}

template <int KSTEPS>
int launch(const float* x, const int8_t* q, const float* scale, const float* zero, float gamma,
           float* out, int m, int n, int d, int per_split, int splits, cudaStream_t stream) {
  constexpr int bytes = Layout<KSTEPS>::BYTES;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_q8_kernel<KSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((m + BM - 1) / BM, splits);
  gram_q8_kernel<KSTEPS><<<grid, THREADS, bytes, stream>>>(x, q, scale, zero, gamma, out,
                                                              m, n, d, per_split);
  return static_cast<int>(cudaGetLastError());
}

int launch_chunked(const float* x, const int8_t* q, const float* scale, const float* zero,
                   float gamma, float* out, int m, int n, int d, int per_split, int splits,
                   cudaStream_t stream) {
  constexpr int bytes = ChunkLayout::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      gram_q8_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM, splits);
  gram_q8_chunked_kernel<<<grid, THREADS, bytes, stream>>>(x, q, scale, zero, gamma, out, m, n,
                                                           d, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rbf_gram_q8_launch(const float* x, const int8_t* q, const float* scale,
                                  const float* zero, float gamma, float* out, int m, int n,
                                  int d, int per_split, int splits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + KSTEP - 1) / KSTEP) {  // the staged kernel for d <= MAX_KSTEPS * KSTEP
    case 1: return launch<1>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 2: return launch<2>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 3: return launch<3>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 4: return launch<4>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 5: return launch<5>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 6: return launch<6>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case 7: return launch<7>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    case MAX_KSTEPS:
      return launch<MAX_KSTEPS>(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
    default:
      if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_chunked(x, q, scale, zero, gamma, out, m, n, d, per_split, splits, s);
  }
}

// the chunked kernel at any d: the checks hold it bit for bit to the staged
// kernel where both run
extern "C" int rbf_gram_q8_chunked_launch(const float* x, const int8_t* q, const float* scale,
                                          const float* zero, float gamma, float* out, int m,
                                          int n, int d, int per_split, int splits,
                                          void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_chunked(x, q, scale, zero, gamma, out, m, n, d, per_split, splits,
                        static_cast<cudaStream_t>(stream));
}
