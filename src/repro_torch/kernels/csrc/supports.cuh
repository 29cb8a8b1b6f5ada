// Support loaders of ensemble_score.cu (fp32 and int8): element (j, c) of a
// row-major support matrix with d columns, as fp32, read while a tile is
// staged in shared memory. The tiles are written once, as templates over the
// loader, so the fp32 and the int8 scorers run the same device code up to
// this one load, and the chunked kernel picks its staging by INT8. (The
// Grams, gram.cu and gram_q8.cu, copy their operands into shared memory by
// cp.async and have no use for a loader.)
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// fp32 supports, as stored.
struct Fp32Supports {
  static constexpr bool INT8 = false;
  const float* s;

  // every base 16-byte aligned: the chunked kernel's 16-byte copies
  bool aligned() const { return aligned16(s); }
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
  static constexpr bool INT8 = true;
  const int8_t* q;
  const float* scale;   // (d,) per matrix
  const float* zero;    // (d,) per matrix

  bool aligned() const { return aligned16(q) && aligned16(scale) && aligned16(zero); }

  __device__ Int8Supports member(int t, int n, int d) const {
    return {q + (int64_t)t * n * d, scale + (int64_t)t * d, zero + (int64_t)t * d};
  }
  __device__ float at(int64_t j, int c, int d) const {
    return __fadd_rn(__fmul_rn(static_cast<float>(__ldg(q + j * d + c)), __ldg(scale + c)),
                     __ldg(zero + c));
  }
};
