// Thread-block cluster machinery of the long-row FFT designs: kernel K7's
// rows of 32768 and 65536 points (fft_natural_cluster.cu), kernel K3's
// rows past one block's shared memory (fft_rows_ct_cluster.cu) and kernel
// K1's (and K3's) rows at n1 = 384, 640, 896 (fft_detect_cluster.cuh). A row is
// one cluster of c blocks on c SMs of one GPC; each block holds its part
// of the row in its own shared memory and reads its partners' parts
// through distributed shared memory (DSMEM).
//
// Host side: launch() sets the dynamic shared-memory attribute, asks
// cudaOccupancyMaxActiveClusters whether a cluster of this shape fits the
// card at all (an error code, not a launch, when it is 0) and launches
// with cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension.
// occupancy() returns that count for the wrappers' reports.
//
// Device side: rank() and sync() of cg::this_cluster(), and sync()'s two
// halves, arrive() (release) and wait() (acquire), for work between them;
// dsmem() maps an address of this block's shared memory to the same offset
// in a partner's (mapa.shared::cluster, a 32-bit shared::cluster address,
// so a lane can hold one for each of its loads), ld1/ld4 read 4 or 16
// bytes there and st1 writes 4 (ld/st.shared::cluster); Partners passes
// ld1, st1 and arrive() to shared code that takes them. Every kernel that
// reads a partner ends with a cluster barrier, so no block exits while a
// partner still reads its shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace rm_cluster {

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned rank() { return cg::this_cluster().block_rank(); }

__device__ __forceinline__ void sync() { cg::this_cluster().sync(); }

// sync() in two halves: every thread of the cluster calls arrive() and
// then wait(), which returns once all have arrived; writes before a
// thread's arrive() (to its own or a partner's shared memory) are visible
// to every thread after its wait().
__device__ __forceinline__ void arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }

__device__ __forceinline__ void wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }

// The shared::cluster address of `local` (an address in this block's
// shared memory) in block `r` of the cluster.
__device__ __forceinline__ uint32_t dsmem(const void* local, unsigned r) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(r));
  return out;
}

__device__ __forceinline__ float ld1(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st1(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// The cluster for shared code that takes one as an argument: ld(p, b), the
// float at this block's shared address p in block b; st(p, b, v), a float
// there; arrive(), arrive().
struct Partners {
  __device__ float ld(const float* p, int b) const { return ld1(dsmem(p, static_cast<unsigned>(b))); }
  __device__ void st(const float* p, int b, float v) const { st1(dsmem(p, static_cast<unsigned>(b)), v); }
  __device__ void arrive() const { rm_cluster::arrive(); }
};

// The launch configuration of `blocks` blocks in clusters of `c` along x.
struct Config {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Config(int blocks, int threads, size_t smem, int c, cudaStream_t stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(c);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// cudaOccupancyMaxActiveClusters for `kernel` at this shape, after setting
// its shared-memory attribute: *clusters = 0 means the card cannot run
// such a cluster at all.
template <typename... KArgs>
cudaError_t occupancy(void (*kernel)(KArgs...), int threads, size_t smem, int c, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  Config k(c, threads, smem, c, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &k.cfg);
}

// Launches `kernel` on `blocks` blocks (a multiple of c) in clusters of c.
// Returns a cudaError_t: cudaErrorInvalidConfiguration where no cluster of
// this shape fits the card.
template <typename... KArgs, typename... Args>
int launch(void (*kernel)(KArgs...), int blocks, int threads, size_t smem, int c, cudaStream_t stream,
           Args... args) {
  int clusters = 0;
  cudaError_t e = occupancy(kernel, threads, smem, c, &clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Config k(blocks, threads, smem, c, stream);
  e = cudaLaunchKernelEx(&k.cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rm_cluster
