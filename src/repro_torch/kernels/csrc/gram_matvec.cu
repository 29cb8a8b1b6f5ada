// Streaming RBF-Gram matvec for Hopper (sm_90a):
//   out[i] = sum_j v[j] * exp(-gamma * max(|x1_i|^2 + |x2_j|^2 - 2 x1_i.x2_j, 0))
//
// Replaces repro/kernels/gram_matvec.py::gram_matvec_pallas (TPU), the matvec
// inside the distillation CG solver. The TPU kernel walks (row tile, support
// tile) as a sequential grid and carries a (bm, 1) sum in VMEM across the
// support tiles. CUDA blocks run in parallel and in no order, so here:
//
//   pass 1  grid (row tiles of 32, support splits): each block owns 32 rows
//           and one contiguous split of the supports, loops over that split
//           64 supports at a time, keeps the 32 running sums in registers and
//           writes one partial sum per row into partial[split][row];
//   pass 2  out[i] = sum over splits of partial[split][i], in split order.
//
// Splitting the supports gives the card enough blocks at m = 4096 (128 row
// tiles alone would leave 132 SMs with one block each). Every sum is taken
// in a fixed order and there are no atomics, so the result is deterministic.
// The (m, n) Gram never exists in device memory. The sums over supports are
// kept in fp64 (one fp64 FMA per pair, against ~2d + 6 fp32 operations):
// an fp32 sum of 4096 terms drifts by ~1e-5 with the order of its terms
// alone, so fp64 sums here and in the plain version make the two agree to
// the registry's 1e-5 at the CG's l = 4096.
//
// Per (row tile, 64-support tile): the supports (full feature dim,
// transposed, one padding column), their norms and v are staged in shared
// memory; each of the 128 threads computes a 4 x 4 block of x1.x2 in plain
// fp32 FMA (no tensor cores: TF32 would wreck the cancellation of the norm
// expansion), applies the exp epilogue and folds v * K into its 4 row sums.
// Supports past the split's end are staged as zeros with v = 0, so they add
// nothing; rows past m are computed and never stored.
//
// Bound on the H100: fp32 operations, about 2d + 8 per (row, support) pair;
// the inputs are 1 MB at the CG's l = 4096, d = 32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MQ = 32;        // rows per block
constexpr int MN = 64;        // supports per staged tile
constexpr int THREADS = 128;  // 8 x 16 threads, 4 x 4 (row, support) pairs each

__global__ void __launch_bounds__(THREADS)
gram_matvec_partial(const float* __restrict__ x1, const float* __restrict__ x2,
                    const float* __restrict__ v, float gamma,
                    double* __restrict__ partial, int m, int n, int d, int chunk) {
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;                      // [d][MQ + 1]
  float* Ss = Xs + d * (MQ + 1);       // [d][MN + 1]
  float* sqs = Ss + d * (MN + 1);      // [MN] support norms
  float* vs = sqs + MN;                // [MN] v of the staged supports
  float* sqx = vs + MN;                // [MQ] row norms
  // [MQ][17] final cross-thread sums; 98 d + 160 floats precede it, an
  // even count, so it is 8-byte aligned
  double* red = reinterpret_cast<double*>(sqx + MQ);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // supports tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // rows 4*ty .. 4*ty+3
  const int r0 = blockIdx.x * MQ;
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(n, j_begin + chunk);

  for (int e = tid; e < MQ * d; e += THREADS) {
    const int r = e / d, c = e % d;
    const int q = r0 + r;
    Xs[c * (MQ + 1) + r] = q < m ? x1[(int64_t)q * d + c] : 0.f;
  }
  __syncthreads();
  if (tid < MQ) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float a = Xs[c * (MQ + 1) + tid];
      s += a * a;
    }
    sqx[tid] = s;
  }

  double accq[4] = {0.0, 0.0, 0.0, 0.0};
  for (int j0 = j_begin; j0 < j_end; j0 += MN) {
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < MN * d; e += THREADS) {
      const int r = e / d, c = e % d;
      const int j = j0 + r;
      Ss[c * (MN + 1) + r] = j < j_end ? x2[(int64_t)j * d + c] : 0.f;
    }
    if (tid < MN) vs[tid] = (j0 + tid < j_end) ? v[j0 + tid] : 0.f;
    __syncthreads();
    if (tid < MN) {
      float s = 0.f;
      for (int c = 0; c < d; ++c) {
        const float b = Ss[c * (MN + 1) + tid];
        s += b * b;
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
      for (int i = 0; i < 4; ++i) av[i] = Xs[c * (MQ + 1) + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ss[c * (MN + 1) + tx + 16 * j];
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
        accq[i] = fma(static_cast<double>(vs[jj]),
                      static_cast<double>(expf(-gamma * d2)), accq[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) red[(ty * 4 + i) * 17 + tx] = accq[i];
  __syncthreads();
  if (tid < MQ) {
    double s = 0.0;
    for (int j = 0; j < 16; ++j) s += red[tid * 17 + j];
    if (r0 + tid < m) partial[(int64_t)blockIdx.y * m + r0 + tid] = s;
  }
}

__global__ void sum_splits(const double* __restrict__ partial, float* __restrict__ out,
                           int m, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  double s = 0.0;
  for (int t = 0; t < splits; ++t) s += partial[(int64_t)t * m + i];
  out[i] = static_cast<float>(s);
}

}  // namespace

extern "C" int gram_matvec_smem_bytes(int d) {
  return static_cast<int>(sizeof(float)) * (d * (MQ + 1) + d * (MN + 1) + MN + MN + MQ) +
         static_cast<int>(sizeof(double)) * MQ * 17;
}

// ``chunk`` (a multiple of 64) supports per split, ``splits`` = ceil(n / chunk);
// ``partial`` holds splits * m doubles.
extern "C" int gram_matvec_launch(const float* x1, const float* x2, const float* v,
                                  float gamma, double* partial, float* out, int m,
                                  int n, int d, int chunk, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = gram_matvec_smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_matvec_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((m + MQ - 1) / MQ, splits);
  gram_matvec_partial<<<grid, THREADS, smem, st>>>(x1, x2, v, gamma, partial, m, n, d,
                                                   chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits<<<(m + 255) / 256, 256, 0, st>>>(partial, out, m, splits);
  return static_cast<int>(cudaGetLastError());
}
