// GQA flash attention on bf16 tensor cores for Hopper (sm_90a):
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] / sqrt(hd)) v[b, j, h / rep]
// over the keys j that the causal (j <= i) and sliding-window (j > i - window)
// masks leave, with rep = H / K query heads per KV head. bfloat16 q, k, v and
// o; float32 inputs go to flash_attention.cu.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU),
// whose sequential kv grid dimension carries the softmax statistics and the
// accumulator in VMEM. Here the kv loop runs inside the block, in the
// FlashAttention-2 shape on mma.sync (not wgmma/TMA):
//
//   one block per (128 query rows, query head, batch), 8 warps; warp w owns
//   rows 16 w .. 16 w + 15 of the tile, and the 8 warps share each staged
//   K and V tile (half the L2 traffic of 64-row blocks). The q tile and, per
//   step, a 64-key K and V tile are copied in place from the (B, S, heads,
//   hd) layout into shared memory with 16-byte cp.async, K/V
//   double-buffered so the next tile loads while this one computes. Rows
//   are padded by 16 bytes, so the 8 rows one ldmatrix reads fall on 8
//   distinct 16-byte bank groups.
//   Q's A fragments are loaded once with ldmatrix and kept in registers.
//   S = Q K^T runs as mma.sync.m16n8k16 bf16 x bf16 -> fp32 with K's B
//   fragments from ldmatrix; masks and the online softmax run on the fp32
//   accumulator fragments in registers (a row's four owners reduce its max
//   with two __shfl_xor steps; its sum is kept per thread and reduced once at
//   the end). P becomes A fragments in registers, with no shared-memory
//   round trip, and O += P V runs on mma.sync with V's B fragments from
//   ldmatrix.trans.
//
// Numerics. The products of bf16 q and k are exact in the fp32 accumulator,
// as in the reference up to summation order. The reference keeps P in fp32
// for P V, so P is split as P_hi = bf16(p), P_lo = bf16(p - P_hi) and both
// are multiplied by V: P_hi + P_lo keeps about 16 bits of p (one bf16 would
// keep 8), for one extra mma per product. The softmax runs in the log2
// domain: scores are scaled by log2(e) / sqrt(hd) and exponentiated with
// ex2.approx (relative error ~2^-22). Statistics and the accumulator are fp32; the output is
// acc / max(l, 1e-20) rounded once to bf16.
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
// count, so this kernel issues 1.5x the bound's tensor work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 8 warps x 16 query rows
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;                  // bf16 row stride in shared memory
  static constexpr int ELEMS = BQ * LD + 4 * BK * LD;  // Q, K[2], V[2]
  static constexpr int BYTES = ELEMS * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p0, p1 (two neighbouring keys of one row) -> the bf16 pairs P_hi and P_lo
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// 2^x; the softmax's arguments are <= 0, and -inf or -1e9 give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows r0 .. r0 + ROWS - 1 of one head of a (B, S, heads, HD) tensor into a
// padded [ROWS][LD] tile; rows at or past S are zero-filled
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* head,
                                          int64_t row_stride, int r0, int S, int tid) {
  constexpr int CPR = HD / 8, CHUNKS = ROWS * CPR;  // 16-byte chunks per row, per tile
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
    const int r = i / CPR, c = (i % CPR) * 8, pos = r0 + r;
    const bool valid = pos < S;
    cp_async16(dst + r * Tile<HD>::LD + c, head + (valid ? pos : 0) * row_stride + c, valid);
  }
}

// two blocks an SM up to hd 64; hd 128 needs ~250 registers a thread
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                int Skv, int H, int Kh, int causal, int window, float scale) {
  constexpr int LD = Tile<HD>::LD;
  constexpr int KSTEPS = HD / 16;  // k steps of Q K^T
  constexpr int NT = HD / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;  // [2][BK][LD]

  // the causal tiles furthest down the sequence do the most work: start them first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;  // mma fragment row group and column pair
  const int w0 = q0 + warp * 16;          // the warp's first row
  const int row0 = w0 + g, row1 = row0 + 8;
  const float scale2 = scale * LOG2E;

  const int64_t qstride = (int64_t)H * HD, kvstride = (int64_t)Kh * HD;
  const __nv_bfloat16* qh = q + (int64_t)b * Sq * qstride + (int64_t)h * HD;
  const __nv_bfloat16* kh = k + (int64_t)b * Skv * kvstride + (int64_t)kvh * HD;
  const __nv_bfloat16* vh = v + (int64_t)b * Skv * kvstride + (int64_t)kvh * HD;

  const int q_last = min(q0 + BQ, Sq) - 1;  // the tile's last real row
  int t_lo = 0, t_hi = (Skv + BK - 1) / BK;
  const bool keyless_row = window > 0 && q_last - window + 1 >= Skv;
  if (!keyless_row) {
    if (causal) t_hi = min(t_hi, q_last / BK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / BK;
  }

  load_tile<HD, BQ>(Qs, qh, qstride, q0, Sq, tid);
  load_tile<HD, BK>(Ks, kh, kvstride, t_lo * BK, Skv, tid);
  load_tile<HD, BK>(Vs, vh, kvstride, t_lo * BK, Skv, tid);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the other stage was last read before the previous barrier
      load_tile<HD, BK>(Ks + (stage ^ 1) * BK * LD, kh, kvstride, (t + 1) * BK, Skv, tid);
      load_tile<HD, BK>(Vs + (stage ^ 1) * BK * LD, vh, kvstride, (t + 1) * BK, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, on the first step, q) has landed
    __syncthreads();

    if (t == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int mi = lane / 8;
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (mi & 1) * 8 + lane % 8) * LD + kk * 16 +
                                (mi >> 1) * 8);
      }
    }
    // A tile wholly past the causal frontier of this warp's 16 rows would add
    // p = exp2(-1e9 - m) = 0 to rows that have all seen a valid key (their
    // own), so the warp skips it; a block with a keyless row walks everything.
    const int k0 = t * BK;
    if (!(causal && !keyless_row && k0 > w0 + 15)) {
      const __nv_bfloat16* Kt = Ks + stage * BK * LD;
      const __nv_bfloat16* Vt = Vs + stage * BK * LD;

      // S = Q K^T: 8 column tiles of 8 keys, fp32 accumulators
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (jp * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                              ((lane / 8) & 1) * 8);
          mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scale into the log2 domain; mask only where the tile crosses a boundary
      // for this warp's rows
      const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > w0) ||
                          (window > 0 && k0 <= w0 + 15 - window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
      // a row's 64 keys are spread over the 4 lanes of its quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = ex2(m0 - mx0), corr1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = ex2(s[j][0] - mx0);
        s[j][1] = ex2(s[j][1] - mx0);
        s[j][2] = ex2(s[j][2] - mx1);
        s[j][3] = ex2(s[j][3] - mx1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = corr0 * l0 + sum0;  // this lane's share of the row sum
      l1 = corr1 * l1 + sum1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr0;
        acc[n][1] *= corr0;
        acc[n][2] *= corr1;
        acc[n][3] *= corr1;
      }

      // O += (P_hi + P_lo) V, 16 keys at a time; P's accumulator fragments are
      // the A fragments of the product
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t phi[4], plo[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], phi[0], plo[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], phi[1], plo[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], phi[2], plo[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], phi[3], plo[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          const int mi = lane / 8;
          ldmatrix_x4_trans(vf, Vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD + np * 16 +
                                    (mi >> 1) * 8);
          mma_bf16(acc[2 * np], phi, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], phi, vf[2], vf[3]);
          mma_bf16(acc[2 * np], plo, vf[0], vf[1]);
          mma_bf16(acc[2 * np + 1], plo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-20f), den1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* oh = o + (int64_t)b * Sq * qstride + (int64_t)h * HD + c4 * 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row0 * qstride + n * 8) =
          __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + row1 * qstride + n * 8) =
          __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Kh, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Tile<HD>::BYTES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_tc_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, Kh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o bfloat16, (B, S, heads, hd) and contiguous, 16-byte aligned
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o,
                                         int B, int Sq, int Skv, int H, int Kh, int hd,
                                         int causal, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, s);
    case 32: return launch_hd<32>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, s);
    case 64: return launch_hd<64>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, s);
    case 128: return launch_hd<128>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
