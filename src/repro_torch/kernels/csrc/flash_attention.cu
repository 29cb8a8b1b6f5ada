// GQA flash attention with online softmax for Hopper (sm_90a), float32:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] / sqrt(hd)) v[b, j, h / rep]
// over the keys j that the causal (j <= i) and sliding-window (j > i - window)
// masks leave, with rep = H / K query heads per KV head. bfloat16 and float16
// inputs go to flash_attention_tc.cu (tensor cores); this kernel serves
// float32, where the tensor cores have no full-precision product, and the
// wrapper's fp32 copies of mixed-type or float64 inputs (the reference casts
// each of q, k and v to fp32 itself).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU). The
// TPU kernel pads q, k and v to 128-row tiles, transposes them to (B, H, S, hd)
// and walks a (B, H, q tile, kv tile) grid whose innermost, sequential kv
// dimension carries the running max, sum and (bq, hd) accumulator in VMEM
// scratch. CUDA blocks run in parallel and in no order, so here the kv loop
// moves inside the block:
//
//   one block per (query tile of 64 rows, query head, batch), folded into one
//   grid dimension (query tiles fastest) so that any B and H take one launch;
//   256 threads as 16 x 16: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the
//   tile; the q tile and, per step, one 64-key K and V tile are read in place
//   from the (B, S, heads, hd) layout (no transpose, no padded copy) and
//   staged in shared memory;
//   S = q k^T: each thread computes a 4 x 4 block (its rows, keys tx + 16 c)
//   with fp32 FMAs; each row's max and sum are reduced over the 16 threads
//   that share the row with warp shuffles and kept, redundantly, by all 16;
//   P goes through shared memory and each thread adds P V into its slice of
//   the (64, hd) accumulator (its 4 rows, columns tx + 16 j) in registers.
//
// Head dims: built for the padded widths HD 16, 32, 64, 96, 128, 192 and
// 256, each twice (for a call whose hd is the width, with the head dim and
// strides compile-time constants, and for every other hd up to it); a
// call's hd is rounded up to the next one, the tiles' columns from hd
// up to HD are zero-filled (they add exact zeros to q k^T), and only the hd
// real columns of o are written. Loads are 4-byte, so any hd and any
// alignment of a row start work. Past hd 256 the chunked kernel gives each
// block one 128-column slab of o and adds q k^T up over 128-column chunks of
// q and k staged in turn, recomputing S for each slab.
//
// Statistics, P and the accumulator are fp32 (the TPU kernel casts its tiles
// to fp32 before both products, so P stays fp32 for PV); the output is
// acc / max(l, 1e-20). Masked scores are NEG_INF = -1e9, as in the
// reference, not -inf: exp(-inf - (-inf)) would be NaN.
//
// Keys at or past Skv are masked by length on every call, whatever causal and
// window say, with -inf so they never count (the TPU kernel relies on the
// causal test to mask its padded keys and so attends to them when it runs
// non-causal with a window). The kv loop starts at the window's first tile and
// stops at the causal frontier of the tile's last row: a fully masked tile
// seen before a row's first valid key adds p = exp(0) = 1 junk that the next
// valid tile's corr = exp(-1e9 - m) = 0 wipes exactly, and one seen after adds
// p = 0. A row with no valid key at all (possible only when a window leaves
// every key behind it, Sq > Skv) gets the reference's answer, the mean of v
// over all Skv keys, because such a block walks every tile.
//
// Bound on the H100: operations. At the serve shape (B 4, S 2048, H 32, K 8,
// hd 64, causal) in fp32 the work is 68.75 GFLOP: 1.03 ms at 67 TFLOP/s
// outside the tensor cores. Its inner loops read shared memory once per two
// FMAs, so they run below even that.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16: 4 rows x 4 keys of S, 4 rows x hd/16 of o each
constexpr int CW = 128;       // the chunked kernel's q/k chunk and o slab, in columns
constexpr int PLD = BK + 1;   // padded row stride of P
constexpr float NEG_INF = -1e9f;

template <int HD>
constexpr int smem_floats() {
  // Qs [BQ][HD + 1], Ks [BK][HD + 1], Vs [BK][HD], Ps [BQ][BK + 1]
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

// The kv tiles [t_lo, t_hi) a query tile walks; keyless: a row of it has no
// valid key (then it walks every tile)
__device__ __forceinline__ void tile_range(int q0, int Sq, int Skv, int causal, int window,
                                           int& t_lo, int& t_hi) {
  const int q_last = min(q0 + BQ, Sq) - 1;  // the tile's last real row
  t_lo = 0;
  t_hi = (Skv + BK - 1) / BK;
  const bool keyless_row = window > 0 && q_last - window + 1 >= Skv;
  if (!keyless_row) {
    if (causal) t_hi = min(t_hi, q_last / BK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / BK;
  }
}

// s[i][c] += q k^T over W staged columns: this thread's rows 4 ty + i, keys tx + 16 c
template <int W, int LD>
__device__ __forceinline__ void qk(float (&s)[4][4], const float* Qs, const float* Ks, int ty,
                                   int tx) {
#pragma unroll 8
  for (int d = 0; d < W; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
  }
}

// One kv tile's scores into the rows' statistics: scale and mask, the
// online softmax, P into shared memory, the accumulator rescaled
template <int CPT>
__device__ __forceinline__ void softmax_tile(float (&s)[4][4], float (&m)[4], float (&l)[4],
                                             float (&acc)[4][CPT], float* Ps, int q0, int k0,
                                             int Skv, int causal, int window, float scale,
                                             int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    float mx = m[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      float val = s[i][c] * scale;
      if (kp >= Skv) val = -INFINITY;
      else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) val = NEG_INF;
      s[i][c] = val;
      mx = fmaxf(mx, val);
    }
    // the 16 threads of a row are lanes that differ in their low four bits
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float corr = expf(m[i] - mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p = expf(s[i][c] - mx);
      Ps[(ty * 4 + i) * PLD + tx + 16 * c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = corr * l[i] + sum;
    m[i] = mx;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
  }
}

// acc += P V over the tile's 64 keys; Vs rows of VLD floats, this thread's
// columns tx + 16 j
template <int CPT, int VLD>
__device__ __forceinline__ void pv(float (&acc)[4][CPT], const float* Ps, const float* Vs, int ty,
                                   int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p4[i] = Ps[(ty * 4 + i) * PLD + kk];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float vv = Vs[kk * VLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p4[i], vv, acc[i][j]);
    }
  }
}

// this thread's rows of o: acc / max(l, 1e-20) at columns c0 + tx + 16 j below hd
template <int CPT>
__device__ __forceinline__ void store_rows(const float (&acc)[4][CPT], const float (&l)[4],
                                           float* oh, int64_t qstride, int q0, int Sq, int c0,
                                           int hd, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    float* row = oh + qp * qstride;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (c0 + tx + 16 * j < hd) row[c0 + tx + 16 * j] = acc[i][j] / den;
  }
}

// EXACT: the call's hd is HD, so the head dim and the strides are
// compile-time constants (the width's other calls take its general
// instantiation, with hd at run time)
template <int HD, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H, int Kh,
             int hd_arg, int nq, int causal, int window, float scale) {
  const int hd = EXACT ? HD : hd_arg;
  constexpr int LD = HD + 1;   // padded row stride of the q and K tiles
  constexpr int CPT = HD / 16; // accumulator columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;

  // (query tile, head, batch) with query tiles fastest; the causal tiles
  // furthest down the sequence do the most work: start them first
  const int qi = nq - 1 - static_cast<int>(blockIdx.x % nq);
  const int bh = static_cast<int>(blockIdx.x / nq);
  const int h = bh % H, b = bh / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD, qp = q0 + r;
    const int64_t off = ((int64_t)b * Sq + qp) * qstride + (int64_t)h * hd + c;
    Qs[r * LD + c] = qp < Sq && c < hd ? q[off] : 0.f;
  }

  int t_lo, t_hi;
  tile_range(q0, Sq, Skv, causal, window, t_lo, t_hi);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K, V and P reads are done (and Qs is staged)
    // one offset for k and v from the kernel's own pointers: per-head base
    // pointers made this loop 156 SASS instructions for four of its
    // iterations at HD 64, not 138, and the kernel 2-3 % slower
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD, kp = k0 + r;
      const bool valid = kp < Skv && c < hd;
      const int64_t off = ((int64_t)b * Skv + kp) * kvstride + (int64_t)kvh * hd + c;
      Ks[r * LD + c] = valid ? k[off] : 0.f;
      Vs[r * HD + c] = valid ? v[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    qk<HD, LD>(s, Qs, Ks, ty, tx);
    softmax_tile<CPT>(s, m, l, acc, Ps, q0, k0, Skv, causal, window, scale, ty, tx);
    __syncthreads();
    pv<CPT, HD>(acc, Ps, Vs, ty, tx);
  }
  store_rows<CPT>(acc, l, o + (int64_t)b * Sq * qstride + (int64_t)h * hd, qstride, q0, Sq, 0,
                  hd, ty, tx);
}

constexpr int chunked_smem_floats() {
  // Qs [BQ][CW + 1], Ks [BK][CW + 1], Vs [BK][CW], Ps [BQ][BK + 1]
  return BQ * (CW + 1) + BK * (CW + 1) + BK * CW + BQ * (BK + 1);
}

// Past hd 256: one block per (query tile, 128-column slab of o, head,
// batch), the four folded into one grid dimension; for each kv tile q k^T
// is added up over 128-column chunks of q and k staged in turn (the slab's
// V rows beside the first), then softmax and P V as above on the slab.
__global__ void __launch_bounds__(THREADS)
flash_chunked_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv, int H,
                     int Kh, int hd, int nq, int nslab, int causal, int window, float scale) {
  constexpr int LD = CW + 1, CPT = CW / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * CW;

  const int qi = nq - 1 - static_cast<int>(blockIdx.x % nq);
  int rest = static_cast<int>(blockIdx.x / nq);
  const int slab = rest % nslab;
  rest /= nslab;
  const int h = rest % H, b = rest / H;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ, c0 = slab * CW;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t qstride = (int64_t)H * hd, kvstride = (int64_t)Kh * hd;
  const float* qh = q + (int64_t)b * Sq * qstride + (int64_t)h * hd;
  const float* kh = k + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;
  const float* vh = v + (int64_t)b * Skv * kvstride + (int64_t)kvh * hd;

  int t_lo, t_hi;
  tile_range(q0, Sq, Skv, causal, window, t_lo, t_hi);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int c = 0; c < hd; c += CW) {
      __syncthreads();  // the previous chunk's reads (and the previous tile's P V) are done
      for (int i = tid; i < BQ * CW; i += THREADS) {
        const int r = i / CW, cc = i % CW, qp = q0 + r;
        Qs[r * LD + cc] = qp < Sq && c + cc < hd ? qh[qp * qstride + c + cc] : 0.f;
      }
      for (int i = tid; i < BK * CW; i += THREADS) {
        const int r = i / CW, cc = i % CW, kp = k0 + r;
        Ks[r * LD + cc] = kp < Skv && c + cc < hd ? kh[kp * kvstride + c + cc] : 0.f;
        if (c == 0) Vs[r * CW + cc] = kp < Skv && c0 + cc < hd ? vh[kp * kvstride + c0 + cc] : 0.f;
      }
      __syncthreads();
      qk<CW, LD>(s, Qs, Ks, ty, tx);
    }
    softmax_tile<CPT>(s, m, l, acc, Ps, q0, k0, Skv, causal, window, scale, ty, tx);
    __syncthreads();
    pv<CPT, CW>(acc, Ps, Vs, ty, tx);
  }
  store_rows<CPT>(acc, l, o + (int64_t)b * Sq * qstride + (int64_t)h * hd, qstride, q0, Sq, c0,
                  hd, ty, tx);
}

template <class Kernel>
int set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD, bool EXACT>
int launch_hd(const float* q, const float* k, const float* v, float* o, int B, int Sq, int Skv,
              int H, int Kh, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<HD>();
  const int err = set_smem(flash_kernel<HD, EXACT>, smem);
  if (err != 0) return err;
  const int nq = (Sq + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)nq * H * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<HD, EXACT><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, o, Sq, Skv, H, Kh, hd, nq, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_chunked(const float* q, const float* k, const float* v, float* o, int B, int Sq,
                   int Skv, int H, int Kh, int hd, int causal, int window, float scale,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * chunked_smem_floats();
  const int err = set_smem(flash_chunked_kernel, smem);
  if (err != 0) return err;
  const int nq = (Sq + BQ - 1) / BQ, nslab = (hd + CW - 1) / CW;
  const int64_t blocks = (int64_t)nq * nslab * H * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_chunked_kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, o, Sq, Skv, H, Kh, hd, nq, nslab, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v and o float32, (B, S, heads, hd) and contiguous; hd's columns
// from the next of the instantiated widths, or the chunked kernel past 256
extern "C" int flash_attention_launch(const float* q, const float* k, const float* v, float* o,
                                      int B, int Sq, int Skv, int H, int Kh, int hd,
                                      int causal, int window, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || Kh < 1 || H % Kh != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_WIDTH(W)                                                                     \
  if (hd == W)                                                                             \
    return launch_hd<W, true>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);  \
  if (hd < W)                                                                              \
    return launch_hd<W, false>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);
  FLASH_WIDTH(16)
  FLASH_WIDTH(32)
  FLASH_WIDTH(64)
  FLASH_WIDTH(96)
  FLASH_WIDTH(128)
  FLASH_WIDTH(192)
  FLASH_WIDTH(256)
#undef FLASH_WIDTH
  return launch_chunked(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);
}
