// The chunked flash kernels' partition of the head dim over a thread-block
// cluster, shared by flash_attention.cu (float32) and flash_attention_tc.cu
// (bfloat16, float16): the plan, the cluster's barrier and its distributed
// shared memory, and the launch with a cluster dimension.
//
// Past hd 256 a row's O no longer fits one CTA's registers, but every owner
// of a row's O columns needs the same S = q k^T, m and l. So a query tile is
// one cluster of nc CTAs: CTA r stages only its slice of q, k and v (columns
// [r ss, r ss + ss) of hd), sums its slice's part of q k^T for each kv tile
// and publishes it in its shared memory; after a cluster barrier every CTA
// reads all nc parts (ld.shared::cluster) and adds them in rank order, so all
// hold the same S bit for bit, run the same online softmax, and each
// accumulates the O columns of its own slice. q k^T is summed once per
// (query tile, kv tile) over the whole hd, and no byte of q, k or v is staged
// by two CTAs.
//
// The plan: nc = min(8, ceil(hd / CW)) CTAs (8 is the portable cluster size),
// each slice ss = ceil(hd / nc) rounded up to 16 columns (a multiple of every
// copy width and of the mma k step), so the ranks' work is balanced; every
// rank has at least one real column. A slice is staged in nsub = ceil(ss / CW)
// sub-chunks of CW columns. Up to hd 8 CW (2,048 at CW 256) nsub is 1: q's
// slice is staged once a block and S is summed once. Past it a slice has
// nsub sub-chunks: each kv tile takes nsub steps (q's and k's sub-chunk j
// staged at step j), and the grid has nsub groups of clusters, group g's
// CTA r owning the O columns of its slice's sub-chunk g; then S is summed
// once a group, nsub times in all.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_chunked {

constexpr int MAX_CLUSTER = 8;

struct Plan {
  int nc;    // CTAs a cluster
  int ss;    // columns of q k^T (and of o) each CTA owns: its slice, a multiple of 16
  int nsub;  // cw-wide sub-chunks of a slice: steps a kv tile, and groups of O
};

inline Plan plan(int hd, int cw) {
  Plan p;
  p.nc = (hd + cw - 1) / cw;
  if (p.nc > MAX_CLUSTER) p.nc = MAX_CLUSTER;
  const int per = (hd + p.nc - 1) / p.nc;
  p.ss = (per + 15) / 16 * 16;
  p.nsub = (p.ss + cw - 1) / cw;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in its two halves, which every thread of the cluster
// executes in turn. publish(): this thread's shared-memory writes before it
// are visible to the cluster once the phase completes: a cluster-scope
// release fence and a relaxed arrive (barrier.cluster.arrive's own release
// compiles to a GPU-scope MEMBAR, which also waits for the cp.async copies
// in flight). done(): a relaxed arrive, for a thread whose reads of the
// other CTAs' shared memory have all returned (their values are consumed
// before it). wait(): the phase has completed, with acquire.
__device__ __forceinline__ void cluster_publish() {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_done() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The shared-memory address `addr` of this CTA as CTA `rank` of the cluster holds it
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes at a cluster shared-memory address (map_rank's)
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// A launch of `blocks` CTAs (a multiple of nc) in clusters of nc along x
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(unsigned blocks, int threads, int nc, int smem, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(nc);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

}  // namespace flash_chunked
