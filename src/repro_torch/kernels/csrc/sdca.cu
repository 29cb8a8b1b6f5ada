// Cyclic SDCA on the hinge-loss dual, one block per device (sm_90a).
//
// Replaces repro/core/svm.py::_sdca, an XLA fori_loop inside jit that the
// reference engine vmaps over a bucket of devices (repro/sim/engine.py:202).
// It is not a Pallas kernel there; on the GPU it needs one, because eager
// PyTorch would issue several launches per coordinate step (20 epochs x
// bucket steps per solve, 40960 for the pooled-data ideal).
//
// The coordinate loop is serial by nature: step i reads the alpha that step
// i-1 wrote. So one block owns one device's whole solve: alpha and y live in
// shared memory, and every step computes f_i = sum_j K[i,j] y[j] alpha[j] as a
// fixed-order block reduction (strided per-thread partial sums, a warp
// shuffle tree, then warp sums in warp order), so the result is
// deterministic. K rows stream from global memory; a bucket group's Grams
// and the 2048^2 ideal Gram (16 MB) sit in the 50 MB L2.
//
// Bound on the H100: neither bytes nor operations. Each step is a
// dependent chain of a short reduction and two barriers, so the kernel is
// latency bound; the design keeps one step's work on one SM and never
// leaves the block between steps.
//
// Arithmetic follows the reference step by step: f = (Ky_i . alpha) /
// (lam * n_real) with lam * n_real in fp32; step = grad * lam * n_real /
// max(K[i,i], 1e-8); alpha_i = clip(alpha_i + step, 0, 1). Coordinates
// i >= n_real stay 0, which the reference reaches by masking: its steps for
// them write 0 into an alpha that is already 0, so they are skipped here, and
// so are the j >= n_real terms of each dot, whose alpha is 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sdca_kernel(const float* __restrict__ K, const float* __restrict__ y,
                            const int* __restrict__ n_real, float* __restrict__ alpha_out,
                            int b, float lam, int epochs) {
  extern __shared__ float sm[];
  float* alpha = sm;      // [b]
  float* ys = sm + b;     // [b]
  float* warp_sums = ys + b;  // [32]

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, n_warps = blockDim.x / 32;
  const float* Kt = K + (int64_t)t * b * b;
  const int nr = n_real[t];
  const int n = nr < b ? nr : b;
  const float nf = static_cast<float>(nr);
  const float lam_n = lam * nf;

  for (int j = tid; j < b; j += blockDim.x) {
    alpha[j] = 0.f;
    ys[j] = y[(int64_t)t * b + j];
  }
  __syncthreads();

  for (int e = 0; e < epochs; ++e) {
    for (int i = 0; i < n; ++i) {
      const float* row = Kt + (int64_t)i * b;
      float part = 0.f;
      for (int j = tid; j < n; j += blockDim.x) part += (row[j] * ys[j]) * alpha[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
      if (lane == 0) warp_sums[warp] = part;
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < n_warps; ++w) s += warp_sums[w];
        const float f = s / lam_n;
        const float grad = 1.f - ys[i] * f;
        const float step = grad * lam * nf / fmaxf(row[i], 1e-8f);
        alpha[i] = fminf(fmaxf(alpha[i] + step, 0.f), 1.f);
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < b; j += blockDim.x) alpha_out[(int64_t)t * b + j] = alpha[j];
}

}  // namespace

extern "C" int sdca_smem_bytes(int b) {
  return static_cast<int>(sizeof(float)) * (2 * b + 32);
}

extern "C" int sdca_launch(const float* K, const float* y, const int* n_real,
                           float* alpha, int g, int b, float lam, int epochs,
                           void* stream) {
  const int smem = sdca_smem_bytes(b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdca_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = b < 256 ? b : 256;
  threads = ((threads + 31) / 32) * 32;
  sdca_kernel<<<g, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      K, y, n_real, alpha, b, lam, epochs);
  return static_cast<int>(cudaGetLastError());
}
