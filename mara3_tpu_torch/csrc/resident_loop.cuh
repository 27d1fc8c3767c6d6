// The persistent step loop that kernels B6 (amrsand_step.cu) and B5
// (sedov_step.cu) share: one cooperative launch a call, every CTA of the
// grid resident on the card at once, each owning a contiguous part of the
// state for all n steps of the call, and one grid barrier a step.
//
// - The launch (launch): cudaLaunchCooperativeKernel with the CTA count the
//   caller's plan asks for, after the occupancy calculator has said that
//   many fit on the card at once; a grid that does not fit is refused with
//   cudaErrorCooperativeLaunchTooLarge before anything runs, and the
//   wrapper raises.
// - The grid barrier (grid_sync): cooperative_groups' grid.sync(), which
//   orders every thread's device-memory writes before it against every
//   read after it. (A generation counter in device memory, tried in its
//   place with tools/torch_b6_b5_variants.py on the H100, took 0.19 ms more
//   of B6's 256-step call at depth 7, block 64 and 0.13 ms more of B5's
//   128-step SRHD call at 524,288 cells, float32.)
// - The edge buffers: what a CTA hands its neighbours (B6 a block's two
//   hi-side rows an axis, B5 a segment's end primitives) goes to one of two
//   buffers chosen by the step's parity (edge_buffer). Step k reads the
//   buffer step k - 1 wrote and writes the other, so one barrier a step
//   orders both: a CTA can write buffer k % 2 again only in step k + 2,
//   after the barrier of step k + 1, which every CTA reaches after its
//   reads of step k. Edges are read with ld.global.cg (load_edge: the L2,
//   never a stale L1 line) and written with st.global.cg (store_edge).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace resident {

// Every CTA of the grid waits here until all have arrived.
__device__ __forceinline__ void grid_sync() {
  cooperative_groups::this_grid().sync();
}

// Buffer k % 2 of two edge buffers of `size` values each.
template <typename T>
__device__ __forceinline__ T* edge_buffer(T* edges, long long size, int k) {
  return edges + (k & 1) * size;
}

template <typename T>
__device__ __forceinline__ T load_edge(const T* p) {
  return __ldcg(p);
}

template <typename T>
__device__ __forceinline__ void store_edge(T* p, T v) {
  __stcg(p, v);
}

// The card's limits that a plan reads: out = (SMs, shared memory a CTA can
// opt into, shared memory an SM, shared memory the system reserves a CTA).
inline cudaError_t device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = cudaDeviceGetAttribute(out + i, attrs[i], dev);
  }
  return err;
}

// A kernel's registers and local (spill) bytes a thread, static shared
// memory a CTA, and the CTAs an SM the occupancy calculator allows at
// `threads` threads and `smem` bytes of dynamic shared memory (out[0..3]).
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kernel,
                                                       threads, smem);
}

// One cooperative launch of `ctas` CTAs of `threads` threads with `smem`
// bytes of dynamic shared memory; refused (cudaErrorCooperativeLaunchTooLarge)
// unless the occupancy calculator fits all of them on the card at once.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int ctas, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  int limits[4], info[4];
  cudaError_t err = device_limits(limits);
  if (err == cudaSuccess) err = kernel_info(kernel, threads, smem, info);
  if (err != cudaSuccess) return err;
  if ((long long)info[3] * limits[0] < ctas) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  void* argv[] = {static_cast<void*>(&args)...};
  err = cudaLaunchCooperativeKernel((void*)kernel,
                                    dim3(ctas), dim3(threads), argv, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace resident
