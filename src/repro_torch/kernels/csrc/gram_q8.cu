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
// Feature dims past 128 (MAX_KSTEPS k steps) take the chunked route, which
// runs the same arithmetic in the same order from scratch the wrapper
// allocates (kernels/rbf_gram_q8.py::chunked_scratch), one launch of two
// kernels:
//
//   q8_prologue (once a call): a query row (rows padded to a multiple of
//           CBM) gets its three bf16 planes of fl(x * scale), split as
//           split3 does, and a support row (padded to a multiple of CBN) its
//           bf16 image of q (exact), each padded with zeros to ldk = d rounded
//           up to SLAB features. A block takes PRO_ROWS rows, PRO_CH features
//           at a time: its warps convert them and stage their values in
//           shared memory, then one thread a chain walks its row there: |x|^2
//           and x.zero (stripe_terms' fmaf chains over ascending features), or
//           the two halves of |s|^2 (convert_tile's chains over the halves of
//           the k steps' padded range of s dequantised as a rounded multiply,
//           then a rounded add), added. So x is split once a call, not once a
//           support tile; q is converted and each support norm taken once,
//           not once a stripe. At 8,192 x 4,096 x 784 the scratch holds 45.9
//           MB of planes and q, which stay in the 50 MB L2 for the kernel.
//   gram_q8_chunked_kernel  grid (stripes of CBM = 128 rows, splits), one
//           block an SM (STAGES x 40,960 bytes of shared memory, 288
//           threads): block (stripe, split) walks (support tile of CBN = 256,
//           slab of SLAB = 32 features) steps of the split's tiles
//           (split_plan at CHUNKED_TARGET_BLOCKS, one wave). A copy warp
//           issues each step's slab, the stripe's three planes and the tile's
//           q (640 rows of 64 bytes), as four TMA boxes with the 64-byte
//           swizzle (chunk c of row r at c ^ ((r / 2) % 4)) into a ring of
//           STAGES slots, each with a full and an empty mbarrier; it runs
//           ahead across tile boundaries, so a tile's epilogue overlaps the
//           next tile's copies. Two warpgroups each own 64 rows x 256
//           supports of the tile (128 fp32 accumulators a thread): for each k
//           step of the slab, ascending, one wgmma.m64n256k16 a plane, hi,
//           mid, lo, A and B read by descriptor from the ring; once a step's
//           products are issued, wgmma.wait_group 1 retires the step before,
//           and its slot is freed. The k steps past the real features' (d
//           rounded up to 16) are skipped. After a tile's last slab
//           store_tile runs on the fragments, with |x|^2, x.zero and |s|^2
//           from the prologue. A 128 x 256 tile reads (3 / 256 + 1 / 128) x 2
//           bytes from L2 an output and feature, 0.63x a 128 x 128 tile's.
//           The products hold the kernel, not that stream: without the
//           copies it takes the same time, and the epilogue, which both
//           warpgroups run at once while the tensor cores wait, is a quarter
//           of it (PERF.md section 6).
//
// So each output's accumulator sees the staged kernel's mma sequence, k step
// after k step ascending, hi, mid, lo (wgmma sums a step's 16 products into
// the accumulator as mma.sync does: the same bits), and the same epilogue:
// the chunked route gives the staged kernel's bits where both run (d <= 128,
// through rbf_gram_q8_chunked_launch), and an output depends on its row and
// its support alone, never on m, n, the tiling or the split.
//
// Bound on the H100: bytes at the student's 8192 x 4096 x 32, where the 134
// MB output takes 0.040 ms at 3.35 TB/s; the tensor-core work (3 planes) is
// ~6.4 GFLOP of bf16, the epilogue ~6 instructions a pair on the CUDA cores.
// At d 784 operations: the cross term's 2 m n d at 989 / 3 TFLOP/s (three
// bf16 plane products, obs/profile.py::kernel_bound), 0.1596 ms.
#include <cuda.h>
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
constexpr int MAX_KSTEPS = 8; // the staged kernel's d <= 128
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

// the chunked route: block tiles of CBM rows x CBN supports, two warpgroups
// of WG_ROWS rows x CBN supports (wgmma m64n256k16) and a copy warp; a ring
// of STAGES slabs, each SLAB features of SROWS rows (the stripe's three
// planes, then the tile's q), 64 bytes a row
constexpr int CBM = 128;
constexpr int CBN = 256;
constexpr int WG_ROWS = 64;
constexpr int SLAB = 32;
constexpr int STAGES = 5;
constexpr int CTHREADS = THREADS + 32;  // the two wgmma warpgroups and the copy warp
constexpr int SROWS = PLANES * CBM + CBN;
constexpr int SROW_BYTES = 2 * SLAB;
constexpr int STAGE_BYTES = SROWS * SROW_BYTES;
constexpr int PRO_ROWS = 16;                      // rows a block of q8_prologue
constexpr int PRO_CH = 128;                       // features it stages at a time: 4 a lane
static_assert(CBM / WG_ROWS * 128 == THREADS && CBN == 256, "two warpgroups of m64n256");
static_assert(CBM % PRO_ROWS == 0 && 2 * PRO_ROWS <= THREADS && PRO_ROWS % 16 == 0 &&
                  PRO_CH == 4 * 32,
              "prologue blocks of whole rows, their chains in whole warps");

// the ring, then its full and empty mbarriers
constexpr int chunked_smem_bytes() { return STAGES * STAGE_BYTES + 2 * STAGES * 8; }

// the chunked route's scratch, laid out by the launcher: rows padded to CBM,
// supports to CBN, each row ldk = slab_dim(d) bf16 features; the three
// planes of x * scale ([PLANES][rows][ldk]), then q's image ([supports][ldk]);
// then |x|^2 and x.zero ([rows] each) and |s|^2 ([supports]) in fp32
__host__ __device__ constexpr int padded_k(int d) { return (d + KSTEP - 1) / KSTEP * KSTEP; }
constexpr int slab_dim(int d) { return (d + SLAB - 1) / SLAB * SLAB; }
constexpr int padded_rows(int m) { return (m + CBM - 1) / CBM * CBM; }
constexpr int padded_supports(int n) { return (n + CBN - 1) / CBN * CBN; }

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

// wgmma (the chunked kernel): a K-major bf16 tile in shared memory laid out
// with the 64-byte swizzle (chunk c of row r at c ^ ((r / 2) % 4), rows 64
// bytes apart, 8-row groups 512 bytes apart) as its matrix descriptor
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * 64 >> 4) << 32) | ((uint64_t)2 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators are not read or written across a wgmma in flight
__device__ __forceinline__ void fence_operands(float (&d)[CBN / 8][4]) {
#pragma unroll
  for (int j = 0; j < CBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// d += a b for a 64 x 256 x 16 tile of the warpgroup: a (64 rows) and b (256
// rows) K-major bf16 by descriptor, d fp32 in m16n8 fragment order (d[j] the
// thread's fragment of columns 8 j .. 8 j + 7)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[CBN / 8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(1));
}


// the chunked kernel's ring: mbarriers in shared memory, and TMA boxes that
// complete on them
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
// wait for the phase of parity `parity` to complete; after ~2^30 tries trap,
// so that a lost arrive fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int64_t i = 0; !done; ++i) {
    asm volatile(
        "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (i > (1ll << 30)) __trap();
  }
}
__device__ __forceinline__ void tensor_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
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

// the epilogue on the fragments of support tile `tile` (tiles of BN_
// supports, warps of WM_ x WN_): cross = acc + x.zero, d2, the RBF, and the
// real (m, n) outputs stored; sq holds the tile's support norms
template <int WM_, int WN_, int BN_, int MT_, int NT_>
__device__ __forceinline__ void store_tile(const float (&acc)[MT_][NT_][4],
                                           const float (&rsq)[MT_][2], const float (&rxz)[MT_][2],
                                           const float* sq, float ngl2, float* out, int m,
                                           int n, int row0, int tile, int wm, int wn,
                                           int lane) {
  const int g = lane / 4, c2 = (lane % 4) * 2;  // fragment row group and column pair
  const bool pairs = (n & 1) == 0;
  const int col_t = tile * BN_ + wn * WN_ + c2;  // + nt * 8
  const float* sq_t = sq + wn * WN_ + c2;
#pragma unroll
  for (int nt = 0; nt < NT_; ++nt) {
    const float2 s = *reinterpret_cast<const float2*>(sq_t + nt * 8);
    const int c = col_t + nt * 8;
#pragma unroll
    for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row0 + wm * WM_ + mt * 16 + hf * 8 + g;
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

// the thread's rows' |x|^2 and x.zero (rows wm * WM_ + mt * 16 + hf * 8 + g
// of the arrays sqx and xz)
template <int WM_, int MT_>
__device__ __forceinline__ void row_terms(float (&rsq)[MT_][2], float (&rxz)[MT_][2],
                                          const float* sqx, const float* xz, int wm, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT_; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * WM_ + mt * 16 + hf * 8 + lane / 4;
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
__device__ __forceinline__ void split3_values(float xs, __nv_bfloat16 (&h)[PLANES]) {
  h[0] = __float2bfloat16_rn(xs);
  const float r1 = __fsub_rn(xs, __bfloat162float(h[0]));
  h[1] = __float2bfloat16_rn(r1);
  h[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h[1])));
}
__device__ __forceinline__ void split3(__nv_bfloat16* Xp, int plane, int idx, float xs) {
  __nv_bfloat16 h[PLANES];
  split3_values(xs, h);
  Xp[idx] = h[0];
  Xp[plane + idx] = h[1];
  Xp[2 * plane + idx] = h[2];
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
  row_terms<WM>(rsq, rxz, sqx, xz, wm, lane);
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

    store_tile<WM, WN, BN>(acc, rsq, rxz, sqs + buf * BN, ngl2, out, m, n, row0, t0 + i, wm, wn,
                           lane);
    cp_async_wait_all();
    __syncthreads();
  }
}

// The chunked route's prologue (see the header). Blocks 0 .. xblocks - 1
// take the query rows (padded to CBM), the rest the support rows (padded to
// CBN), PRO_ROWS rows a block, PRO_CH features at a time: warp w converts
// rows w, w + WARPS, ... of the chunk (lane l features 4 l .. 4 l + 3) and
// stages their values in shared memory; then thread t < 2 PRO_ROWS carries
// chain t % 2 of row t / 2 across the chunk, reading along its staged row
// (rows PRO_CH + 1 floats apart: the 16 rows' reads fall on 16 banks).
__global__ void __launch_bounds__(THREADS)
q8_prologue(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, const float* __restrict__ zero, int m, int n,
            int d, int ldk, int64_t plane, int xblocks, __nv_bfloat16* __restrict__ xp,
            __nv_bfloat16* __restrict__ qb, float* __restrict__ sqx, float* __restrict__ xz,
            float* __restrict__ sqs) {
  __shared__ float staged[PRO_ROWS][PRO_CH + 1];
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const bool xside = blockIdx.x < xblocks;
  const int row0 = (xside ? blockIdx.x : blockIdx.x - xblocks) * PRO_ROWS;
  const int rows = xside ? m : n;
  // the chain this thread carries: row cr, chain h (|x|^2 / x.zero, or half h
  // of the k steps' padded range [0, padded_k(d)) of |s|^2)
  const int cr = tid / 2, h = tid & 1;
  const int half = padded_k(d) / 2, lo = h * half, hi = min(d, lo + half);
  const bool chained = tid < 2 * PRO_ROWS && row0 + cr < rows;
  float chain = 0.f;
  for (int c0 = 0; c0 < ldk; c0 += PRO_CH) {
    const int c = c0 + 4 * lane;
    for (int r = w; r < PRO_ROWS; r += THREADS / 32) {
      const bool real = row0 + r < rows;
      float v[4];
      if (xside) {
        const float* xr = x + (int64_t)(real ? row0 + r : 0) * d;
        __nv_bfloat16 hs[4][PLANES];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = real && c + j < d ? __ldg(xr + c + j) : 0.f;
          split3_values(c + j < d ? __fmul_rn(v[j], __ldg(scale + c + j)) : 0.f, hs[j]);
        }
        if (c < ldk) {
          __nv_bfloat16* dst = xp + (int64_t)(row0 + r) * ldk + c;
#pragma unroll
          for (int p = 0; p < PLANES; ++p) {
            const __nv_bfloat162 lo2 = __halves2bfloat162(hs[0][p], hs[1][p]);
            const __nv_bfloat162 hi2 = __halves2bfloat162(hs[2][p], hs[3][p]);
            *reinterpret_cast<uint2*>(dst + p * plane) =
                make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                           *reinterpret_cast<const uint32_t*>(&hi2));
          }
        }
      } else {
        const int8_t* qr = q + (int64_t)(real ? row0 + r : 0) * d;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = real && c + j < d ? static_cast<float>(__ldg(qr + c + j)) : 0.f;
        if (c < ldk) {
          const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[0], v[1]);  // exact
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(qb + (int64_t)(row0 + r) * ldk + c) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                         *reinterpret_cast<const uint32_t*>(&hi2));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) staged[r][4 * lane + j] = v[j];
    }
    __syncthreads();
    if (chained) {
      const float* sr = staged[cr] - c0;
      if (xside) {  // fmaf chains over ascending features
        const int end = min(c0 + PRO_CH, d);
#pragma unroll 8
        for (int f = c0; f < end; ++f) chain = fmaf(sr[f], h ? __ldg(zero + f) : sr[f], chain);
      } else {  // s = q * scale + zero, each rounded
        const int end = min(c0 + PRO_CH, hi);
#pragma unroll 8
        for (int f = max(c0, lo); f < end; ++f) {
          const float sv = __fadd_rn(__fmul_rn(sr[f], __ldg(scale + f)), __ldg(zero + f));
          chain = fmaf(sv, sv, chain);
        }
      }
    }
    __syncthreads();
  }
  if (xside) {
    if (tid < 2 * PRO_ROWS) (h ? xz : sqx)[row0 + cr] = chain;  // 0 past m
  } else if (tid < 2 * PRO_ROWS) {  // whole warps: the shuffle has all its lanes
    const float other = __shfl_xor_sync(0xffffffffu, chain, 1);
    if (h == 0) sqs[row0 + cr] = __fadd_rn(chain, other);  // (half 0) + (half 1); 0 past n
  }
}

// The chunked kernel (see the header): xmap the planes of x * scale as
// (PLANES mp, ldk), qmap q's image as (np, ldk); kp = padded_k(d).
__global__ void __launch_bounds__(CTHREADS, 1)
gram_q8_chunked_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap qmap, const float* __restrict__ sqx,
                       const float* __restrict__ xz, const float* __restrict__ sqs, int mp,
                       float gamma, float* __restrict__ out, int m, int n, int kp, int ldk,
                       int per_split) {
  extern __shared__ __align__(1024) unsigned char ring_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int row0 = blockIdx.x * CBM;
  const int tiles = (n + CBN - 1) / CBN;
  const int t0 = blockIdx.y * per_split;
  const int T = min(per_split, tiles - t0);
  const int slabs = ldk / SLAB;
  const int steps = T * slabs;
  const uint32_t ring = smem_addr(ring_smem);
  const uint32_t full = ring + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);  // one arrive a wgmma warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == THREADS / 32) {  // the copy warp: lane 0 issues every slab's boxes
    if (lane == 0) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % STAGES, use = s / STAGES;
        if (use > 0) mbar_wait(empty + 8 * slot, (use - 1) & 1);
        const int t = s / slabs, k0 = (s - t * slabs) * SLAB;
        const uint32_t dst = ring + slot * STAGE_BYTES, bar = full + 8 * slot;
        mbar_expect(bar, STAGE_BYTES);
        for (int p = 0; p < PLANES; ++p)
          tensor_load(dst + p * CBM * SROW_BYTES, &xmap, k0, p * mp + row0, bar);
        tensor_load(dst + PLANES * CBM * SROW_BYTES, &qmap, k0, (t0 + t) * CBN, bar);
      }
    }
    return;
  }
  // the wgmma warpgroups: warp w of warpgroup g holds rows 64 g + 16 w .. + 15
  // of the tile and all CBN supports, 32 m16n8 fragments, 128 fp32
  // accumulators a thread
  const float ngl2 = -gamma * LOG2E;
  float acc[CBN / 8][4];
#pragma unroll
  for (int j = 0; j < CBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const bool releaser = tid % 128 == 0;  // one arrive a warpgroup on an empty mbarrier
  int k = 0, t = t0, pending = -1;  // the tile's slab, the tile, the step whose slot is held
  for (int s = 0; s < steps; ++s) {
    const int slot = s % STAGES;
    mbar_wait(full + 8 * slot, (s / STAGES) & 1);  // the slab's boxes have landed
    const uint32_t base = ring + slot * STAGE_BYTES;
    const int ksteps = min(SLAB / KSTEP, (kp - k * SLAB) / KSTEP);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < SLAB / KSTEP; ++ks)
      if (ks < ksteps) {
        const uint64_t db = sw64_desc(base + PLANES * CBM * SROW_BYTES + 2 * KSTEP * ks);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          wgmma_m64n256k16(
              acc, sw64_desc(base + (p * CBM + wg * WG_ROWS) * SROW_BYTES + 2 * KSTEP * ks), db);
      }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step s - 1 are done: free its slot
    if (pending >= 0 && releaser) mbar_arrive(empty + 8 * (pending % STAGES));
    pending = s;
    if (++k == slabs) {
      wgmma_wait<0>();
      if (releaser) mbar_arrive(empty + 8 * slot);
      pending = -1;
      fence_operands(acc);
      float rsq[1][2], rxz[1][2];
      row_terms<16>(rsq, rxz, sqx + row0, xz + row0, warp, lane);
      store_tile<16, CBN, CBN>(*reinterpret_cast<float (*)[1][CBN / 8][4]>(&acc), rsq, rxz,
                               sqs + (int64_t)t * CBN, ngl2, out, m, n, row0, t, warp, 0, lane);
#pragma unroll
      for (int j = 0; j < CBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      k = 0;
      ++t;
    }
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

// cuTensorMapEncodeTiled from the driver, found through the runtime
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
// rows x ldk bf16 at p, read in boxes of SLAB features x box_rows rows, SW64
bool slab_map(CUtensorMap* map, void* p, int64_t rows, int ldk, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldk), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldk) * 2};
  const cuuint32_t box[2] = {SLAB, static_cast<cuuint32_t>(box_rows)}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// the prologue, then the chunked kernel, on the scratch at planes (bf16) and
// norms (fp32), laid out as padded_rows, padded_supports and slab_dim say
int launch_chunked(const float* x, const int8_t* q, const float* scale, const float* zero,
                   float gamma, float* out, void* planes, float* norms, int m, int n, int d,
                   int per_split, int splits, cudaStream_t stream) {
  if (d < 1 || planes == nullptr || norms == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = chunked_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      gram_q8_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ldk = slab_dim(d), mp = padded_rows(m), np = padded_supports(n);
  const int64_t plane = (int64_t)mp * ldk;
  __nv_bfloat16* xp = static_cast<__nv_bfloat16*>(planes);
  __nv_bfloat16* qb = xp + PLANES * plane;
  float* sqx = norms;
  float* xz = sqx + mp;
  float* sqs = xz + mp;
  CUtensorMap xmap, qmap;
  if (!slab_map(&xmap, xp, (int64_t)PLANES * mp, ldk, CBM) || !slab_map(&qmap, qb, np, ldk, CBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xblocks = mp / PRO_ROWS;
  q8_prologue<<<xblocks + np / PRO_ROWS, THREADS, 0, stream>>>(
      x, q, scale, zero, m, n, d, ldk, plane, xblocks, xp, qb, sqx, xz, sqs);
  const cudaError_t pro_err = cudaGetLastError();
  if (pro_err != cudaSuccess) return static_cast<int>(pro_err);
  gram_q8_chunked_kernel<<<dim3(mp / CBM, splits), CTHREADS, smem, stream>>>(
      xmap, qmap, sqx, xz, sqs, mp, gamma, out, m, n, padded_k(d), ldk, per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rbf_gram_q8_chunked_smem_bytes() { return chunked_smem_bytes(); }
// the chunked route's scratch: (PLANES x rows + supports) x slab_dim(d) bf16
// and 2 x rows + supports fp32, rows = rbf_gram_q8_padded_rows(m), supports =
// rbf_gram_q8_padded_supports(n)
extern "C" int rbf_gram_q8_padded_rows(int m) { return padded_rows(m); }
extern "C" int rbf_gram_q8_padded_supports(int n) { return padded_supports(n); }
extern "C" int rbf_gram_q8_slab_dim(int d) { return slab_dim(d); }

// ``per_split`` tiles per split and ``splits`` from kernels/rbf_gram_q8.py::
// split_plan (the staged kernel's tiles of BN supports up to d 128, the
// chunked route's of CBN past it); ``planes`` and ``norms`` the chunked
// route's scratch (unread up to d 128)
extern "C" int rbf_gram_q8_launch(const float* x, const int8_t* q, const float* scale,
                                  const float* zero, float gamma, float* out, void* planes,
                                  float* norms, int m, int n, int d, int per_split, int splits,
                                  void* stream) {
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
      return launch_chunked(x, q, scale, zero, gamma, out, planes, norms, m, n, d, per_split,
                            splits, s);
  }
}

// the chunked route at any d: the checks hold it bit for bit to the staged
// kernel where both run
extern "C" int rbf_gram_q8_chunked_launch(const float* x, const int8_t* q, const float* scale,
                                          const float* zero, float gamma, float* out,
                                          void* planes, float* norms, int m, int n, int d,
                                          int per_split, int splits, void* stream) {
  return launch_chunked(x, q, scale, zero, gamma, out, planes, norms, m, n, d, per_split,
                        splits, static_cast<cudaStream_t>(stream));
}
