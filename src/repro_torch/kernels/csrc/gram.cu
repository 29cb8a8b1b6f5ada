// RBF Gram tiles for Hopper (sm_90a): exp(-gamma * max(|a|^2 + |b|^2 - 2 a.b, 0)).
//
// Replaces two TPU kernels of the reference package:
//   repro/kernels/batched_gram.py::batched_rbf_gram_pallas  (per-device gamma, (g,))
//   repro/kernels/rbf_gram.py::rbf_gram_pallas              (one scalar gamma)
// Both run the same device code; the launchers differ only in where gamma
// comes from, and each has its own wrapper and launch counter in Python.
//
// One block computes one 64 x 64 output tile of one device's Gram. The
// feature dim streams through shared memory in 32-wide chunks, stored
// transposed with one padding column so the stores and the inner-loop reads
// hit distinct banks. Each of the 256 threads keeps a 4 x 4 block of the
// cross term a.b in registers (plain fp32 FMA, no tensor cores: TF32 would
// wreck the cancellation in the norm expansion); the first 128 threads also
// accumulate the 64 + 64 row norms from the same staged chunks. The epilogue
// (combine, clamp at 0, exp) runs on the registers before the single store.
//
// Padding contract, kept from the reference: a zero-padded row gives
// exp(-gamma |x|^2) != 0. Nothing is masked here; callers mask.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output cols per block
constexpr int DK = 32;       // feature chunk staged per step
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rbf_gram_tiles(const float* __restrict__ x1, const float* __restrict__ x2,
               const float* __restrict__ gammas, float gamma,
               float* __restrict__ out, int m, int n, int d) {
  __shared__ float As[DK][BM + 1];
  __shared__ float Bs[DK][BN + 1];
  __shared__ float sqa[BM];
  __shared__ float sqb[BN];

  const int t = blockIdx.z;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* a = x1 + (int64_t)t * m * d;
  const float* b = x2 + (int64_t)t * n * d;
  float* o = out + (int64_t)t * m * n;
  const float g = gammas != nullptr ? gammas[t] : gamma;

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;   // rows 4*ty .. 4*ty+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // tid < 64: |a_row|^2, 64 <= tid < 128: |b_row|^2

  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int e = tid; e < BM * DK; e += THREADS) {
      const int r = e / DK, c = e % DK;
      const int gc = k0 + c;
      const int ra = row0 + r, rb = col0 + r;
      As[c][r] = (ra < m && gc < d) ? a[(int64_t)ra * d + gc] : 0.f;
      Bs[c][r] = (rb < n && gc < d) ? b[(int64_t)rb * d + gc] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll 8
      for (int c = 0; c < DK; ++c) nrm += As[c][tid] * As[c][tid];
    } else if (tid < BM + BN) {
#pragma unroll 8
      for (int c = 0; c < DK; ++c) nrm += Bs[c][tid - BM] * Bs[c][tid - BM];
    }
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) {
    sqa[tid] = nrm;
  } else if (tid < BM + BN) {
    sqb[tid - BM] = nrm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      const float d2 = fmaxf(sqa[ty * 4 + i] + sqb[tx + 16 * j] - 2.f * acc[i][j], 0.f);
      o[(int64_t)r * n + c] = expf(-g * d2);
    }
  }
}

}  // namespace

extern "C" int batched_rbf_gram_launch(const float* x1, const float* x2,
                                       const float* gammas, float* out, int g,
                                       int m, int n, int d, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, g);
  rbf_gram_tiles<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, gammas, 0.f, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rbf_gram_launch(const float* x1, const float* x2, float gamma,
                               float* out, int m, int n, int d, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, 1);
  rbf_gram_tiles<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, nullptr, gamma, out, m, n, d);
  return static_cast<int>(cudaGetLastError());
}
