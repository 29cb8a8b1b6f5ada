// Fused ensemble scoring for Hopper (sm_90a):
//   out[q] = (1/k) sum_t sum_j coef[t,j] * exp(-gamma_t * max(|x_q|^2 + |s_tj|^2 - 2 x_q.s_tj, 0))
//
// Replaces two TPU kernels of the reference package:
//   repro/kernels/ensemble_score.py::ensemble_score_pallas        (fp32 supports)
//   repro/kernels/ensemble_score_q8.py::ensemble_score_q8_pallas  (int8 supports,
//       s_tj = q[t,j] * scale[t] + zero[t], per member and column)
// Both run one kernel, a template over the support loader (supports.cuh):
// an int8 tile is dequantised while it is staged in shared memory, so the
// packed ensemble stays int8 in device memory (a quarter of the bytes).
//
// The TPU kernel walks (query tile, member, support tile) as a sequential
// grid and adds each partial into a VMEM scratch accumulator. CUDA blocks
// run in parallel and in no order, so here the member loop and the support
// loop run INSIDE the block: one block owns 32 queries for the whole
// ensemble, keeps their running sums in registers, and writes each score
// once. No atomics, so the result is deterministic run to run.
//
// Per (member, 64-support tile): the block stages the supports (full feature
// dim, transposed, one padding column), their norms and coefficients in
// shared memory; each of the 128 threads computes a 4 x 4 block of x.s in
// fp32 FMA (no tensor cores: TF32 would wreck the norm-expansion
// cancellation), applies the exp epilogue and folds coef * K into its 4
// per-query sums. At the end the 16 threads that share a query row add their
// sums in a fixed order. Padded supports carry zero coefficients (a padded
// int8 row dequantises to its zero point: finite, and annihilated); rows
// past n_max are staged as zeros; padded query rows are computed and never
// stored.
//
// Bound on the H100: fp32 operations (about 2d + 6 per query-support pair);
// the packed ensemble is read once per 32-query block and stays in L2 for
// ensembles up to tens of MB.
#include <cuda_runtime.h>
#include <stdint.h>

#include "supports.cuh"

namespace {

constexpr int EQ = 32;        // queries per block
constexpr int EN = 64;        // supports per staged tile
constexpr int THREADS = 128;  // 8 x 16 threads, 4 x 4 outputs each

template <class Supports>
__global__ void __launch_bounds__(THREADS)
ensemble_score_kernel(const float* __restrict__ x, const Supports sup,
                      const float* __restrict__ coef, const float* __restrict__ gammas,
                      float* __restrict__ out, int b, int k, int n_max, int d) {
  extern __shared__ float sm[];
  float* Xs = sm;                      // [d][EQ + 1]
  float* Ss = Xs + d * (EQ + 1);       // [d][EN + 1]
  float* sqs = Ss + d * (EN + 1);      // [EN] support norms
  float* cs = sqs + EN;                // [EN] support coefficients
  float* sqx = cs + EN;                // [EQ] query norms
  float* red = sqx + EQ;               // [EQ][17] final cross-thread sums

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // supports tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // queries 4*ty .. 4*ty+3
  const int q0 = blockIdx.x * EQ;

  for (int e = tid; e < EQ * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const int q = q0 + r;
    Xs[c * (EQ + 1) + r] = q < b ? x[(int64_t)q * d + c] : 0.f;
  }
  __syncthreads();
  if (tid < EQ) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = Xs[c * (EQ + 1) + tid];
      s += v * v;
    }
    sqx[tid] = s;
  }

  float accq[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < k; ++t) {
    const float g = gammas[t];
    const Supports S = sup.member(t, n_max, d);
    const float* C = coef + (int64_t)t * n_max;
    for (int j0 = 0; j0 < n_max; j0 += EN) {
      __syncthreads();  // the previous tile is fully consumed
      for (int e = tid; e < EN * d; e += THREADS) {
        const int r = e / d, c = e % d;
        const int j = j0 + r;
        Ss[c * (EN + 1) + r] = j < n_max ? S.at(j, c, d) : 0.f;
      }
      if (tid < EN) cs[tid] = (j0 + tid < n_max) ? C[j0 + tid] : 0.f;
      __syncthreads();
      if (tid < EN) {
        float s = 0.f;
        for (int c = 0; c < d; ++c) {
          const float v = Ss[c * (EN + 1) + tid];
          s += v * v;
        }
        sqs[tid] = s;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Xs[c * (EQ + 1) + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Ss[c * (EN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // support norms are ready
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = tx + 16 * j;
          const float d2 = fmaxf(sqx[ty * 4 + i] + sqs[jj] - 2.f * acc[i][j], 0.f);
          accq[i] += cs[jj] * expf(-g * d2);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) red[(ty * 4 + i) * 17 + tx] = accq[i];
  __syncthreads();
  if (tid < EQ) {
    float s = 0.f;
    for (int j = 0; j < 16; ++j) s += red[tid * 17 + j];
    if (q0 + tid < b) out[q0 + tid] = s / static_cast<float>(k);
  }
}

int smem_bytes(int d) {
  return static_cast<int>(sizeof(float)) *
         (d * (EQ + 1) + d * (EN + 1) + EN + EN + EQ + EQ * 17);
}

template <class Supports>
int launch_scores(const float* x, const Supports sup, const float* coef,
                  const float* gammas, float* out, int b, int k, int n_max, int d,
                  void* stream) {
  const int smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ensemble_score_kernel<Supports>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((b + EQ - 1) / EQ);
  ensemble_score_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, sup, coef, gammas, out, b, k, n_max, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ensemble_score_smem_bytes(int d) { return smem_bytes(d); }

extern "C" int ensemble_score_launch(const float* x, const float* sup,
                                     const float* coef, const float* gammas,
                                     float* out, int b, int k, int n_max, int d,
                                     void* stream) {
  return launch_scores(x, Fp32Supports{sup}, coef, gammas, out, b, k, n_max, d, stream);
}

extern "C" int ensemble_score_q8_launch(const float* x, const int8_t* q,
                                        const float* scale, const float* zero,
                                        const float* coef, const float* gammas,
                                        float* out, int b, int k, int n_max, int d,
                                        void* stream) {
  return launch_scores(x, Int8Supports{q, scale, zero}, coef, gammas, out, b, k, n_max,
                       d, stream);
}
