// GQA flash attention on 16-bit tensor cores for Hopper (sm_90a):
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] / sqrt(hd)) v[b, j, h / rep]
// over the keys j that the causal (j <= i) and sliding-window (j > i - window)
// masks leave, with rep = H / K query heads per KV head. q, k, v and o all
// bfloat16 (this file's library) or all float16 (flash_attention_tc_f16.cu
// builds the same code for __half); float32 and mixed inputs go to
// flash_attention.cu.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU),
// whose sequential kv grid dimension carries the softmax statistics and the
// accumulator in VMEM. Here the kv loop runs inside the block, in the
// FlashAttention-2 shape on mma.sync (not wgmma/TMA):
//
//   one block per (128 query rows, query head, batch), 8 warps, the three
//   folded into one grid dimension (query tiles fastest) so that any B and H
//   take one launch; warp w owns rows 16 w .. 16 w + 15 of the tile, and the
//   8 warps share each staged K and V tile (half the L2 traffic of 64-row
//   blocks). The q tile and, per step, a 64-key K and V tile are copied in
//   place from the (B, S, heads, hd) layout into shared memory with 16-byte
//   cp.async, K/V double-buffered so the next tile loads while this one
//   computes. Rows are padded by 16 bytes, so the 8 rows one ldmatrix reads
//   fall on 8 distinct 16-byte bank groups.
//   Up to HD 128 Q's A fragments are loaded once with ldmatrix and kept in
//   registers; past it (HD 192, 256) they are read from the staged q tile at
//   each k step, as FlashAttention-2 does at hd 256, which leaves the
//   registers to the 16 x HD accumulator (128 a thread at 256).
//   S = Q K^T runs as mma.sync.m16n8k16 (bf16 or f16 inputs, fp32
//   accumulators) with K's B fragments from ldmatrix; masks and the online
//   softmax run on the fp32 accumulator fragments in registers (a row's four
//   owners reduce its max with two __shfl_xor steps; its sum is kept per
//   thread and reduced once at the end). P becomes A fragments in registers,
//   with no shared-memory round trip, and O += P V runs on mma.sync with V's
//   B fragments from ldmatrix.trans.
//
// Head dims. The kernel is built for the padded widths HD 16, 32, 64, 96,
// 128, 192 and 256; a call's hd is rounded up to the next one, and the
// columns from hd up to HD are zero-filled in shared memory: they add
// nothing to Q K^T, their O columns are never written, and the scale stays
// 1 / sqrt(hd) of the real hd. Each width is built twice: for calls whose hd
// is the width and whose rows are 16-byte rows (hd, strides and copies
// compile-time constants), and for every other hd up to it. A row of hd
// 16-bit values is a 16-byte row only when hd % 8 == 0 and the tensors
// start on 16-byte boundaries (a head starts h * hd elements into its
// row); otherwise the tiles come by 8- or 4-byte cp.async, or by plain
// 2-byte loads for an odd hd or a tensor 2 bytes off. Past hd 256 the
// chunked kernel below splits hd over a cluster of CTAs (flash_chunked.cuh):
// each stages its 256-column slice of q once and its slice of K and V in a
// three-step ring of 32-key tiles, sums its part of S, and the cluster adds
// the parts in rank order, so S is computed once a (query tile, kv tile).
//
// Numerics. The products of 16-bit q and k are exact in the fp32
// accumulator, as in the reference up to summation order. The reference
// keeps P in fp32 for P V, so P is split as P_hi = T(p), P_lo = T(p - P_hi)
// and both are multiplied by V: P_hi + P_lo keeps about 16 bits of p in bf16
// (one bf16 would keep 8) and about 22 in fp16, for one extra mma per
// product. The softmax runs in the log2 domain: scores are scaled by
// log2(e) / sqrt(hd) and exponentiated with ex2.approx (relative error
// ~2^-22). Statistics and the accumulator are fp32; the output is
// acc / max(l, 1e-20) rounded once to T.
//
// Masking as in flash_attention.cu, so both agree with the reference's
// oracle: keys at or past Skv get -inf on every call; causal and window
// masks give NEG_INF = -1e9 (the running max starts there, so
// exp2(-inf - m) is 0 and never NaN). The kv loop starts at the window's
// first tile and stops at the causal frontier of the tile's last row; a
// fully masked tile seen before a row's first valid key adds p = 1 junk that
// the next valid tile's correction exp2(-1e9 - m) = 0 wipes exactly. A row
// with no valid key (a window that leaves every key behind it) gets the mean
// of v over all Skv keys, because such a block walks every tile. Masks are
// evaluated only on the tiles that straddle a boundary for the warp's rows.
//
// Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32, K 8,
// hd 64, causal) the work is 68.75 GFLOP against 83.9 MB of q, k, v and o:
// 0.0695 ms at 989 TFLOP/s bf16. The P V product's split doubles its mma
// count, so this kernel issues 1.5x the bound's tensor work (and a padded hd
// the padding's share more). The chunked kernel at hd 512 (B 1, S 2048, H 8,
// causal: 0.0348 ms) issues the same 1.5x; per 32-key step it adds one
// cluster exchange (a GPU-scope fence, the cluster barrier, one batch of
// ld.shared::cluster), ~20 % of its time on an H100 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_chunked.cuh"

namespace {

constexpr int BQ = 128;       // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 8 warps x 16 query rows
constexpr int CW = 256;       // the chunked kernel's staged slice of q, k, v and o, in columns
constexpr int CBK = 32;       // the chunked kernel's keys a step
constexpr int CSTAGES = 3;    // the chunked kernel's ring of K and V steps
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;                  // 16-bit row stride in shared memory
  static constexpr int ELEMS = BQ * LD + 4 * BK * LD;  // Q, K[2], V[2]
  static constexpr int BYTES = ELEMS * 2;
};

// the chunked kernel: Q's slice, the ring of K and V steps, its warps' parts of S
struct ChunkTile {
  static constexpr int LD = CW + 8;
  static constexpr int STAGE = 2 * CBK * LD;  // 16-bit elements of one step's K and V
  static constexpr int BYTES = 2 * (BQ * LD + CSTAGES * STAGE) + 4 * BQ * CBK;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global to shared memory, zero-filled when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The element type's tensor-core product and conversions.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  // d += a b for one 16 x 8 x 16 tile: a row-major (4 regs), b column-major
  // (2 regs), d fp32 (4 regs)
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // p0, p1 (two neighbouring keys of one row) -> the pairs P_hi and P_lo
  static __device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                                    uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    const float2 hf = __bfloat1622float2(h);
    hi = bits2(h);
    lo = bits2(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    return bits2(__floats2bfloat162_rn(a, b));
  }
  static __device__ __forceinline__ uint16_t one(float a) {
    const __nv_bfloat16 x = __float2bfloat16_rn(a);
    return *reinterpret_cast<const uint16_t*>(&x);
  }
  static __device__ __forceinline__ uint32_t bits2(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                                    uint32_t& lo) {
    const __half2 h = __floats2half2_rn(p0, p1);
    const float2 hf = __half22float2(h);
    hi = bits2(h);
    lo = bits2(__floats2half2_rn(p0 - hf.x, p1 - hf.y));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    return bits2(__floats2half2_rn(a, b));
  }
  static __device__ __forceinline__ uint16_t one(float a) {
    const __half x = __float2half_rn(a);
    return *reinterpret_cast<const uint16_t*>(&x);
  }
  static __device__ __forceinline__ uint32_t bits2(__half2 x) {
    return *reinterpret_cast<uint32_t*>(&x);
  }
};

// 2^x; the softmax's arguments are <= 0, and -inf or -1e9 give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 .. r0 + ROWS - 1 of one head of a (B, S, heads, hd) tensor into a
// padded [ROWS][W + 8] tile of W columns: columns from `cols` on and rows at
// or past S are zero-filled. BYTES-wide cp.async chunks; the launcher's
// `vec` guarantees that every row start and `cols` allow them. A masked
// chunk names `head` itself: picking its row and column apart before the
// 64-bit product instead shortens the HD-128 K/V stage but makes HD 64
// spill more under the two-block bound, and run slower.
template <int W, int ROWS, int BYTES>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* head,
                                          int64_t row_stride, int r0, int S, int cols, int tid) {
  constexpr int E = BYTES / 2, CPR = W / E, CHUNKS = ROWS * CPR;  // chunks per row, per tile
  if constexpr (BYTES == 16) {
#pragma unroll
    for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
      const int i = tid + it * THREADS;
      if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
      const int r = i / CPR, c = (i % CPR) * E, pos = r0 + r;
      const bool valid = pos < S && c < cols;
      cp_async<16>(dst + r * (W + 8) + c, head + (valid ? pos * row_stride + c : 0), valid);
    }
  } else {
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * E, pos = r0 + r;
      const bool valid = pos < S && c < cols;
      cp_async<BYTES>(dst + r * (W + 8) + c, head + (valid ? pos * row_stride + c : 0), valid);
    }
  }
}

// The same tile by plain 2-byte loads: rows that start 2 bytes off a 4-byte
// boundary (an odd hd, or a tensor that starts so)
template <int W, int ROWS>
__device__ __forceinline__ void load_rows_plain(uint16_t* dst, const uint16_t* head,
                                                int64_t row_stride, int r0, int S, int cols,
                                                int tid) {
  for (int i = tid; i < ROWS * W; i += THREADS) {
    const int r = i / W, c = i % W, pos = r0 + r;
    dst[r * (W + 8) + c] = (pos < S && c < cols) ? head[pos * row_stride + c] : uint16_t(0);
  }
}

template <int W, int ROWS, bool EXACT = false>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* head, int64_t row_stride,
                                          int r0, int S, int cols, int vec, int tid) {
  if constexpr (EXACT) {  // hd is W and every row a 16-byte row: the one path
    load_rows<W, ROWS, 16>(dst, head, row_stride, r0, S, W, tid);
    return;
  }
  switch (vec) {
    case 16: load_rows<W, ROWS, 16>(dst, head, row_stride, r0, S, cols, tid); break;
    case 8: load_rows<W, ROWS, 8>(dst, head, row_stride, r0, S, cols, tid); break;
    case 4: load_rows<W, ROWS, 4>(dst, head, row_stride, r0, S, cols, tid); break;
    default: load_rows_plain<W, ROWS>(dst, head, row_stride, r0, S, cols, tid); break;
  }
}

// Q's A fragment of k step kk for this warp's 16 rows, from a [BQ][LD] tile
template <int LD>
__device__ __forceinline__ void load_q_frag(uint32_t (&a)[4], const uint16_t* Qs, int warp,
                                            int lane, int kk) {
  const int mi = lane / 8;
  ldmatrix_x4(a, Qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * LD + kk * 16 + (mi >> 1) * 8);
}

// s += A K^T for one 16-column k step: KT / 8 column tiles of 8 keys
template <typename T, int LD, int KT = BK>
__device__ __forceinline__ void qk_step(float (&s)[KT / 8][4], const uint32_t (&a)[4],
                                        const uint16_t* Kt, int lane, int kk) {
#pragma unroll
  for (int jp = 0; jp < KT / 16; ++jp) {
    uint32_t kf[4];
    ldmatrix_x4(kf, Kt + (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        ((lane / 8) & 1) * 8);
    Elem<T>::mma(s[2 * jp], a, kf[0], kf[1]);
    Elem<T>::mma(s[2 * jp + 1], a, kf[2], kf[3]);
  }
}

// The rows' running statistics and O accumulator of one warp.
template <int NT>
struct RowState {
  float acc[NT][4];
  float m0, m1, l0, l1;
};

// One kv tile's scores S (fp32 fragments) into the warp's state: scale into
// the log2 domain, mask where the tile crosses a boundary for this warp's
// rows, the online softmax, then O += (P_hi + P_lo) V, 16 keys at a time,
// P's accumulator fragments being the A fragments of the product. Vt is the
// tile's [KT][LD] V rows, from column 0 of the O columns this state holds.
template <typename T, int NT, int LD, int KT = BK>
__device__ __forceinline__ void softmax_pv(RowState<NT>& st, float (&s)[KT / 8][4],
                                           const uint16_t* Vt, int k0, int Skv, int w0,
                                           int row0, int row1, int causal, int window,
                                           float scale2, int c4, int lane) {
  const bool masked = k0 + KT > Skv || (causal && k0 + KT - 1 > w0) ||
                      (window > 0 && k0 <= w0 + 15 - window);
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = s[j][e] * scale2;
      if (masked) {
        const int kp = k0 + j * 8 + c4 * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool hidden = (causal && kp > row) || (window > 0 && kp <= row - window);
        val = kp >= Skv ? -INFINITY : hidden ? NEG_INF : val;
      }
      s[j][e] = val;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  // a row's KT keys are spread over the 4 lanes of its quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float corr0 = ex2(st.m0 - mx0), corr1 = ex2(st.m1 - mx1);
  st.m0 = mx0;
  st.m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s[j][0] = ex2(s[j][0] - mx0);
    s[j][1] = ex2(s[j][1] - mx0);
    s[j][2] = ex2(s[j][2] - mx1);
    s[j][3] = ex2(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  st.l0 = corr0 * st.l0 + sum0;  // this lane's share of the row sum
  st.l1 = corr1 * st.l1 + sum1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.acc[n][0] *= corr0;
    st.acc[n][1] *= corr0;
    st.acc[n][2] *= corr1;
    st.acc[n][3] *= corr1;
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    uint32_t phi[4], plo[4];
    Elem<T>::split_pair(s[2 * kk][0], s[2 * kk][1], phi[0], plo[0]);
    Elem<T>::split_pair(s[2 * kk][2], s[2 * kk][3], phi[1], plo[1]);
    Elem<T>::split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], phi[2], plo[2]);
    Elem<T>::split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], phi[3], plo[3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t vf[4];
      const int mi = lane / 8;
      ldmatrix_x4_trans(vf, Vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD + np * 16 +
                                (mi >> 1) * 8);
      Elem<T>::mma(st.acc[2 * np], phi, vf[0], vf[1]);
      Elem<T>::mma(st.acc[2 * np + 1], phi, vf[2], vf[3]);
      Elem<T>::mma(st.acc[2 * np], plo, vf[0], vf[1]);
      Elem<T>::mma(st.acc[2 * np + 1], plo, vf[2], vf[3]);
    }
  }
}

// o's rows row0 and row1 of this warp: acc / max(l, 1e-20) rounded once to T,
// at O columns c0 + n * 8 + 2 c4 (+1) below hd (the chunked kernel passes
// the end of its CTA's columns, even or hd). oh points at column 0 of the
// head in row 0; pairs: 4-byte stores (hd even), else one element at a time.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(RowState<NT>& st, uint16_t* oh, int64_t qstride,
                                           int Sq, int row0, int row1, int c0, int hd, int c4,
                                           bool pairs) {
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 1);
  st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, 2);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 1);
  st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, 2);
  const float den0 = fmaxf(st.l0, 1e-20f), den1 = fmaxf(st.l1, 1e-20f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = c0 + n * 8 + c4 * 2;
    if (c >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= Sq) continue;
      const float den = half ? den1 : den0;
      const float a = st.acc[n][2 * half] / den, b = st.acc[n][2 * half + 1] / den;
      uint16_t* p = oh + row * qstride + c;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(p) = Elem<T>::pack(a, b);
      } else {
        p[0] = Elem<T>::one(a);
        if (c + 1 < hd) p[1] = Elem<T>::one(b);
      }
    }
  }
}

// The kv tiles [t_lo, t_hi) of TBK keys a query tile walks; keyless: a row
// of it has no valid key (then it walks every tile)
template <int TBK = BK>
__device__ __forceinline__ void tile_range(int q0, int Sq, int Skv, int causal, int window,
                                           int& t_lo, int& t_hi, bool& keyless) {
  const int q_last = min(q0 + BQ, Sq) - 1;  // the tile's last real row
  t_lo = 0;
  t_hi = (Skv + TBK - 1) / TBK;
  keyless = window > 0 && q_last - window + 1 >= Skv;
  if (!keyless) {
    if (causal) t_hi = min(t_hi, q_last / TBK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / TBK;
  }
}

// Two blocks an SM up to hd 64; hd 128 needs ~250 registers a thread.
// EXACT: the call's hd is HD and its rows are 16-byte rows, so the head dim,
// the strides and the copies are compile-time constants (the width's other
// calls take its general instantiation, whose runtime hd and copy width
// cost registers: at HD 32 and 64 they spill under the two-block bound).
template <typename T, int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_tc_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int Sq, int Skv, int H,
                int Kh, int hd_arg, int nq, int causal, int window, float scale, int vec) {
  const int hd = EXACT ? HD : hd_arg;
  constexpr int LD = Tile<HD>::LD;
  constexpr int KSTEPS = HD / 16;  // k steps of Q K^T
  constexpr int NT = HD / 8;       // 8-wide column tiles of O
  constexpr bool QREG = HD <= 128;  // Q's fragments in registers, else from shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Ks = Qs + BQ * LD;      // [2][BK][LD]
  uint16_t* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  // (query tile, head, batch) with query tiles fastest; the causal tiles
  // furthest down the sequence do the most work: start them first
  const int qi = nq - 1 - static_cast<int>(blockIdx.x % nq);
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;  // mma fragment row group and column pair
  const int w0 = q0 + warp * 16;          // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;
  const float scale2 = scale * LOG2E;

  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;
  const uint16_t* qh = q + (int64_t)b * Sq * qstride + (int64_t)h * hd;
  const uint16_t* kh = k + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;
  const uint16_t* vh = v + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;

  int t_lo, t_hi;
  bool keyless_row;
  tile_range(q0, Sq, Skv, causal, window, t_lo, t_hi, keyless_row);

  load_tile<HD, BQ, EXACT>(Qs, qh, qstride, q0, Sq, hd, vec, tid);
  load_tile<HD, BK, EXACT>(Ks, kh, kvstride, t_lo * BK, Skv, hd, vec, tid);
  load_tile<HD, BK, EXACT>(Vs, vh, kvstride, t_lo * BK, Skv, hd, vec, tid);
  cp_async_commit();

  uint32_t qf[QREG ? KSTEPS : 1][4];
  RowState<NT> st;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  st.m0 = NEG_INF;
  st.m1 = NEG_INF;
  st.l0 = 0.f;
  st.l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the other stage was last read before the previous barrier
      load_tile<HD, BK, EXACT>(Ks + (stage ^ 1) * BK * LD, kh, kvstride, (t + 1) * BK, Skv, hd,
                               vec, tid);
      load_tile<HD, BK, EXACT>(Vs + (stage ^ 1) * BK * LD, vh, kvstride, (t + 1) * BK, Skv, hd,
                               vec, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, on the first step, q) has landed
    __syncthreads();

    if constexpr (QREG) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) load_q_frag<LD>(qf[kk], Qs, warp, lane, kk);
      }
    }
    // A tile wholly past the causal frontier of this warp's 16 rows would add
    // p = exp2(-1e9 - m) = 0 to rows that have all seen a valid key (their
    // own), so the warp skips it; a block with a keyless row walks everything.
    const int k0 = t * BK;
    if (!(causal && !keyless_row && k0 > w0 + 15)) {
      const uint16_t* Kt = Ks + stage * BK * LD;
      const uint16_t* Vt = Vs + stage * BK * LD;

      // S = Q K^T: 8 column tiles of 8 keys, fp32 accumulators
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if constexpr (QREG) {
          qk_step<T, LD>(s, qf[kk], Kt, lane, kk);
        } else {
          uint32_t a[4];
          load_q_frag<LD>(a, Qs, warp, lane, kk);
          qk_step<T, LD>(s, a, Kt, lane, kk);
        }
      }
      softmax_pv<T, NT, LD>(st, s, Vt, k0, Skv, w0, row0, row1, causal, window, scale2, c4,
                            lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const bool pairs = EXACT || ((hd & 1) == 0 && (reinterpret_cast<uintptr_t>(o) & 3) == 0);
  store_rows<T, NT>(st, o + (int64_t)b * Sq * qstride + (int64_t)h * hd, qstride, Sq, row0, row1,
                    0, hd, c4, pairs);
}

// Rows r0 .. r0 + ROWS - 1 of the chunked kernel's slice of one head into a
// padded [ROWS][CW + 8] tile: columns from `cols` on and rows at or past S
// zero-filled; BYTES-wide copies (2: plain loads), the loop not unrolled
// (unrolled, its per-copy offsets stay live across the kv loop and spill)
template <int ROWS, int BYTES>
__device__ __forceinline__ void load_chunk(uint16_t* dst, const uint16_t* head,
                                           int64_t row_stride, int r0, int S, int cols, int tid) {
  constexpr int E = BYTES / 2, CPR = CW / E;
#pragma unroll 1
  for (int i = tid; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * E, pos = r0 + r;
    const bool valid = pos < S && c < cols;
    if constexpr (BYTES == 2) {
      dst[r * (CW + 8) + c] = valid ? head[pos * row_stride + c] : uint16_t(0);
    } else {
      cp_async<BYTES>(dst + r * (CW + 8) + c, head + (valid ? pos * row_stride + c : 0), valid);
    }
  }
}

// The same by the widest copy the call allows (V16: 16 bytes, the main path)
template <int ROWS, bool V16>
__device__ __forceinline__ void load_slice(uint16_t* dst, const uint16_t* head,
                                           int64_t row_stride, int r0, int S, int cols, int vec,
                                           int tid) {
  if (V16 || vec == 16) {
    load_chunk<ROWS, 16>(dst, head, row_stride, r0, S, cols, tid);
  } else if (vec == 8) {
    load_chunk<ROWS, 8>(dst, head, row_stride, r0, S, cols, tid);
  } else if (vec == 4) {
    load_chunk<ROWS, 4>(dst, head, row_stride, r0, S, cols, tid);
  } else {
    load_chunk<ROWS, 2>(dst, head, row_stride, r0, S, cols, tid);
  }
}

// Past hd 256: one cluster of nc CTAs per (query tile of 128 rows, O group,
// head, batch), the four folded into one grid dimension of clusters
// (flash_chunked.cuh has the plan). CTA r stages its slice of q once (ss
// columns; past hd 2,048 one 256-column sub-chunk a step) and, per step, a
// 32-key tile of its slice of K and, on a kv tile's last step, of V's
// columns that its O group holds, in a ring of CSTAGES steps filled by
// cp.async. Warp w holds rows 16 w .. 16 w + 15 and all the slice's
// columns, as the one-pass kernel at HD 256: it adds its rows' part of
// S = Q K^T up over the slice in fp32 fragments and stores it in Xs; after
// the cluster barrier it reads the same rows' parts from the other CTAs
// (one batch of loads a CTA, ld.shared::cluster) and every CTA forms
// ((p0 + p1) + p2) + ..., its own part entering at its rank from its
// registers, so all nc hold the same S bit for bit; then the online
// softmax and O += (P_hi + P_lo) V on its slice, as the one-pass kernel
// does them. A step's copies are issued after the publishing fence (a
// GPU-scope membar waits for every copy in flight), CSTAGES - 1 steps
// ahead. Xs is written again only after every CTA has read it: the second
// half of the barrier (cluster_done after P V, cluster_wait before the next
// write) costs no wait in the common case, and one before the exit keeps a
// CTA's shared memory alive until its peers are done with it.
template <typename T, bool V16>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_chunked_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int Sq, int Skv,
                        int H, int Kh, int hd, int nq, int nc, int ss, int nsub, int causal,
                        int window, float scale, int vec) {
  namespace fc = flash_chunked;
  constexpr int LD = ChunkTile::LD;
  constexpr int KSTEPS = CW / 16, NT = CW / 8, NJ = CBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);  // [BQ][LD]
  uint16_t* Ring = Qs + BQ * LD;                     // [CSTAGES][K, V][CBK][LD]
  float4* Xs = reinterpret_cast<float4*>(Ring + CSTAGES * ChunkTile::STAGE);  // [8][NJ][32]

  const int rank = static_cast<int>(fc::cluster_rank());
  const int cid = static_cast<int>(blockIdx.x) / nc;
  const int qi = nq - 1 - cid % nq;  // the heaviest causal tiles first
  int rest = cid / nq;
  const int grp = rest % nsub;
  rest /= nsub;
  const int h = rest % H, b = rest / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int w0 = q0 + warp * 16;
  const int row0 = w0 + g, row1 = row0 + 8;
  const float scale2 = scale * LOG2E;
  // this CTA's slice of hd, and its O group's columns (none in a short last slice)
  const int sc0 = rank * ss, se = min(sc0 + ss, hd);
  const int oc0 = sc0 + grp * CW, oce = min(oc0 + CW, se);

  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;
  const uint16_t* qh = q + (int64_t)b * Sq * qstride + (int64_t)h * hd;
  const uint16_t* kh = k + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;
  const uint16_t* vh = v + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;

  int t_lo, t_hi;
  bool keyless_row;
  tile_range<CBK>(q0, Sq, Skv, causal, window, t_lo, t_hi, keyless_row);
  const int nsteps = (t_hi - t_lo) * nsub;

  auto issue = [&](int it) {
    uint16_t* Kd = Ring + (it % CSTAGES) * ChunkTile::STAGE;
    const int t = t_lo + it / nsub, j = it % nsub, c = sc0 + j * CW;
    load_slice<CBK, V16>(Kd, kh + (c < hd ? c : 0), kvstride, t * CBK, Skv, min(CW, se - c),
                         vec, tid);
    if (j == nsub - 1)
      load_slice<CBK, V16>(Kd + CBK * LD, vh + (oc0 < hd ? oc0 : 0), kvstride, t * CBK, Skv,
                           oce - oc0, vec, tid);
  };
  load_slice<BQ, V16>(Qs, qh + sc0, qstride, q0, Sq, min(CW, se - sc0), vec, tid);
#pragma unroll
  for (int p = 0; p < CSTAGES - 1; ++p) {
    if (p < nsteps) issue(p);
    cp_async_commit();  // the first group holds q too
  }

  RowState<NT> st;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.acc[n][e] = 0.f;
  st.m0 = NEG_INF;
  st.m1 = NEG_INF;
  st.l0 = 0.f;
  st.l1 = 0.f;
  float s[NJ][4];
  const uint32_t xa = fc::smem_u32(Xs + warp * NJ * 32 + lane);  // this thread's part of S

  for (int it = 0; it < nsteps; ++it) {
    const int t = t_lo + it / nsub, j = it % nsub, k0 = t * CBK;
    const bool last = j == nsub - 1;
    cp_async_wait<CSTAGES - 2>();  // step it (and, first, q) has landed
    __syncthreads();  // ... for every thread; and every warp is done with step it - 1
    if (nsub > 1 && it > 0) {  // q's sub-chunk j, in place of the last step's
      const int c = sc0 + j * CW;
      load_slice<BQ, V16>(Qs, qh + (c < hd ? c : 0), qstride, q0, Sq, min(CW, se - c), vec,
                          tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    // a tile wholly past the causal frontier of this warp's 16 rows: skipped,
    // as in the one-pass kernel (the same warps of every CTA skip it)
    const bool active = !(causal && !keyless_row && k0 > w0 + 15);
    const uint16_t* Kt = Ring + (it % CSTAGES) * ChunkTile::STAGE;
    if (j == 0) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        load_q_frag<LD>(a, Qs, warp, lane, kk);
        qk_step<T, LD, CBK>(s, a, Kt, lane, kk);
      }
    }
    if (last) {
      if (it >= nsub) fc::cluster_wait();  // every CTA has read the last tile's parts
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        Xs[(warp * NJ + jj) * 32 + lane] = make_float4(s[jj][0], s[jj][1], s[jj][2], s[jj][3]);
      fc::cluster_publish();
    }
    if (it + CSTAGES - 1 < nsteps) issue(it + CSTAGES - 1);  // into step it - 1's stage
    cp_async_commit();
    if (!last) continue;

    fc::cluster_wait();  // every CTA's part of this tile is in its Xs
    if (active) {
      // S: the nc parts added in rank order, ((p0 + p1) + p2) + ...: this
      // CTA's own part enters at its rank, from its registers (an fp32 sum
      // is commutative, so (...) + s and s + (...) are the same bits)
      float4 t[NJ];
      auto add_to_s = [&]() {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          s[jj][0] += t[jj].x;
          s[jj][1] += t[jj].y;
          s[jj][2] += t[jj].z;
          s[jj][3] += t[jj].w;
        }
      };
      for (int rr = 0; rr < nc; ++rr) {
        if (rr == rank) continue;
        const uint32_t at = fc::map_rank(xa, rr);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 x = fc::ld_cluster(at + jj * 32 * 16);
          if (rr == 0 || rr > rank) t[jj] = x;
          else fc::add4(t[jj], x);   // the ranks before this one, summed first
        }
        if (rr == rank - 1 || rr > rank) add_to_s();
      }
      softmax_pv<T, NT, LD, CBK>(st, s, Kt + CBK * LD, k0, Skv, w0, row0, row1, causal, window,
                                 scale2, c4, lane);
    }
    fc::cluster_done();  // the parts read went into P V's mma (asm volatile, in order)
  }
  fc::cluster_wait();  // no CTA reads this one's Xs any more

  const bool pairs = (hd & 1) == 0 && (reinterpret_cast<uintptr_t>(o) & 3) == 0;
  store_rows<T, NT>(st, o + (int64_t)b * Sq * qstride + (int64_t)h * hd, qstride, Sq, row0, row1,
                    oc0, oce, c4, pairs);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int HD, bool EXACT>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Kh, int hd, int causal, int window, float scale, int vec,
              cudaStream_t stream) {
  constexpr int smem = Tile<HD>::BYTES;
  const int err = set_smem(flash_tc_kernel<T, HD, EXACT>, smem);
  if (err != 0) return err;
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)nq * H * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_tc_kernel<T, HD, EXACT><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), Sq, Skv, H, Kh, hd, nq, causal,
      window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool V16>
int launch_chunked_v(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                     int Skv, int H, int Kh, int hd, int causal, int window, float scale, int vec,
                     cudaStream_t stream) {
  constexpr int smem = ChunkTile::BYTES;
  const int err = set_smem(flash_tc_chunked_kernel<T, V16>, smem);
  if (err != 0) return err;
  const flash_chunked::Plan p = flash_chunked::plan(hd, CW);
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)nq * p.nsub * H * B * p.nc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_chunked::ClusterLaunch launch(static_cast<unsigned>(blocks), THREADS, p.nc, smem, stream);
  const cudaError_t rc = cudaLaunchKernelEx(
      &launch.cfg, flash_tc_chunked_kernel<T, V16>, static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
      Sq, Skv, H, Kh, hd, nq, p.nc, p.ss, p.nsub, causal, window, scale, vec);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunked(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                   int H, int Kh, int hd, int causal, int window, float scale, int vec,
                   cudaStream_t stream) {
  if (vec == 16)
    return launch_chunked_v<T, true>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,
                                     vec, stream);
  return launch_chunked_v<T, false>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,
                                    vec, stream);
}

// The widest copy (16, 8, 4 or 2 bytes) that every row start of q, k and v
// allows: it must divide a row's hd * 2 bytes and the three base addresses.
int copy_bytes(const void* q, const void* k, const void* v, int hd) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  int vec = 16;
  while (vec > 2 && ((2 * (int64_t)hd) % vec != 0 || addr % vec != 0)) vec /= 2;
  return vec;
}

// q, k, v and o of element type T, (B, S, heads, hd) and contiguous; o's hd
// columns from the next of the instantiated widths, or the chunked kernel
// past 256
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int H,
             int Kh, int hd, int causal, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || Kh < 1 || H % Kh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = copy_bytes(q, k, v, hd);
#define FLASH_TC_WIDTH(W)                                                                  \
  if (hd == W && vec == 16)                                                                \
    return launch_hd<T, W, true>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,   \
                                 vec, s);                                                  \
  if (hd <= W)                                                                             \
    return launch_hd<T, W, false>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,  \
                                  vec, s);
  FLASH_TC_WIDTH(16)
  FLASH_TC_WIDTH(32)
  FLASH_TC_WIDTH(64)
  FLASH_TC_WIDTH(96)
  FLASH_TC_WIDTH(128)
  FLASH_TC_WIDTH(192)
  FLASH_TC_WIDTH(256)
#undef FLASH_TC_WIDTH
  return launch_chunked<T>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, vec, s);
}

}  // namespace

#ifndef FLASH_TC_F16
// q, k, v and o bfloat16, (B, S, heads, hd) and contiguous
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                                         int B, int Sq, int Skv, int H, int Kh, int hd,
                                         int causal, int window, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale,
                                 stream);
}
#endif
