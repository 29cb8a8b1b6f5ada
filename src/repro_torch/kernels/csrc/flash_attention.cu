// GQA flash attention with online softmax for Hopper (sm_90a):
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] / sqrt(hd)) v[b, j, h / rep]
// over the keys j that the causal (j <= i) and sliding-window (j > i - window)
// masks leave, with rep = H / K query heads per KV head.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas (TPU). The
// TPU kernel pads q, k and v to 128-row tiles, transposes them to (B, H, S, hd)
// and walks a (B, H, q tile, kv tile) grid whose innermost, sequential kv
// dimension carries the running max, sum and (bq, hd) accumulator in VMEM
// scratch. CUDA blocks run in parallel and in no order, so here the kv loop
// moves inside the block:
//
//   one block per (query tile of 64 rows, query head, batch), 256 threads as
//   16 x 16: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the tile;
//   the q tile and, per step, one 64-key K and V tile are read in place from
//   the (B, S, heads, hd) layout through its strides (no transpose, no padded
//   copy) and staged in shared memory as fp32;
//   S = q k^T: each thread computes a 4 x 4 block (its rows, keys tx + 16 c)
//   with fp32 FMAs; each row's max and sum are reduced over the 16 threads
//   that share the row with warp shuffles and kept, redundantly, by all 16;
//   P goes through shared memory and each thread adds P V into its slice of
//   the (64, hd) accumulator (its 4 rows, columns tx + 16 j) in registers.
//
// Statistics, P and the accumulator are fp32 (the TPU kernel casts its tiles
// to fp32 before both products, so P stays fp32 for PV); the output is
// acc / max(l, 1e-20), cast to the input type. Masked scores are NEG_INF =
// -1e9, as in the reference, not -inf: exp(-inf - (-inf)) would be NaN.
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
// hd 64, bf16, causal) the work is 68.75 GFLOP against 83.9 MB of q, k, v and
// o; the bf16 tensor-core bound is 0.0695 ms, and the fp32 FMA design here can
// reach at most 1.03 ms (67 TFLOP/s outside the tensor cores). Its inner loops
// read shared memory once per two FMAs, so they run below even that.
// mma.sync / wgmma and TMA are the way to the tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16: 4 rows x 4 keys of S, 4 rows x hd/16 of o each
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  // Qs [BQ][HD + 1], Ks [BK][HD + 1], Vs [BK][HD], Ps [BQ][BK + 1]
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Sq, int Skv, int H, int Kh, int causal, int window,
             float scale) {
  constexpr int LD = HD + 1;   // padded row stride of the q and K tiles
  constexpr int PLD = BK + 1;  // padded row stride of P
  constexpr int CPT = HD / 16; // accumulator columns per thread
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;

  // the causal tiles furthest down the sequence do the most work: start them first
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD, qp = q0 + r;
    Qs[r * LD + c] = qp < Sq ? to_f32(q[((int64_t)b * Sq + qp) * H * HD + (int64_t)h * HD + c])
                             : 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;  // the tile's last real row
  int t_lo = 0, t_hi = (Skv + BK - 1) / BK;
  const bool keyless_row = window > 0 && q_last - window + 1 >= Skv;
  if (!keyless_row) {
    if (causal) t_hi = min(t_hi, q_last / BK + 1);
    if (window > 0) t_lo = max(0, q0 - window + 1) / BK;
  }

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
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD, kp = k0 + r;
      const int64_t off = ((int64_t)b * Skv + kp) * Kh * HD + (int64_t)kvh * HD + c;
      Ks[r * LD + c] = kp < Skv ? to_f32(k[off]) : 0.f;
      Vs[r * HD + c] = kp < Skv ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
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
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* row = o + ((int64_t)b * Sq + qp) * H * HD + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < CPT; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
              int H, int Kh, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Kh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                 int H, int Kh, int hd, int causal, int window, float scale,
                 cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, stream);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, stream);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, stream);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, Sq, Skv, H, Kh, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// shared memory one block takes at head dim hd (0 for an unsupported hd)
extern "C" int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return static_cast<int>(sizeof(float)) * smem_floats<16>();
    case 32: return static_cast<int>(sizeof(float)) * smem_floats<32>();
    case 64: return static_cast<int>(sizeof(float)) * smem_floats<64>();
    case 128: return static_cast<int>(sizeof(float)) * smem_floats<128>();
    default: return 0;
  }
}

// is_bf16: 0 for float32 tensors, 1 for bfloat16; q, k, v and o all of that type
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Skv, int H, int Kh, int hd,
                                      int is_bf16, int causal, int window, float scale,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window,
                                       scale, s);
  return launch_typed<float>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, s);
}
