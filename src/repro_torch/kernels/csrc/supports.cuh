// Support loaders of ensemble_score.cu (fp32 and int8): element (j, c) of a
// row-major support matrix with d columns, as fp32, read while a tile is
// staged in shared memory. The tiles are written once, as templates over the
// loader, so the fp32 and the int8 scorers run the same device code up to
// this one load. (The Grams, gram.cu and gram_q8.cu, copy their operands
// into shared memory by cp.async and have no use for a loader.)
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// fp32 supports, as stored.
struct Fp32Supports {
  const float* s;

  // the t-th (n, d) matrix of a stack of them
  __device__ Fp32Supports member(int t, int n, int d) const {
    return {s + (int64_t)t * n * d};
  }
  __device__ float at(int64_t j, int c, int d) const { return __ldg(s + j * d + c); }
};

// Per-column affine int8 supports, dequantised as q * scale[c] + zero[c]: a
// rounded multiply, then a rounded add, as the plain version computes it (no
// FMA contraction). A zero-padded int8 row dequantises to the zero point, not
// 0; callers either never write its outputs or give it a zero coefficient.
struct Int8Supports {
  const int8_t* q;
  const float* scale;   // (d,) per matrix
  const float* zero;    // (d,) per matrix

  __device__ Int8Supports member(int t, int n, int d) const {
    return {q + (int64_t)t * n * d, scale + (int64_t)t * d, zero + (int64_t)t * d};
  }
  __device__ float at(int64_t j, int c, int d) const {
    return __fadd_rn(__fmul_rn(static_cast<float>(__ldg(q + j * d + c)), __ldg(scale + c)),
                     __ldg(zero + c));
  }
};
