// GQA flash attention on fp16 tensor cores for Hopper (sm_90a): the kernels of
// flash_attention_tc.cu built for __half (mma.sync.m16n8k16 with f16 inputs
// and fp32 accumulators, P split into two fp16 parts, the output fp16), as a
// library of its own so that the two element types compile in parallel.
// The design, the numerics and the bound are flash_attention_tc.cu's.
#define FLASH_TC_F16
#include "flash_attention_tc.cu"

// q, k, v and o float16, (B, S, heads, hd) and contiguous
extern "C" int flash_attention_tc_f16_launch(const void* q, const void* k, const void* v,
                                             void* o, int B, int Sq, int Skv, int H, int Kh,
                                             int hd, int causal, int window, float scale,
                                             void* stream) {
  return dispatch<__half>(q, k, v, o, B, Sq, Skv, H, Kh, hd, causal, window, scale, stream);
}
