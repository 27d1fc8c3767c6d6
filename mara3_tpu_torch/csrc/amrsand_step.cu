// Kernel B6: n first-order upwind steps of the amrsand quadtree advection at
// v = (0.5, 0.5) on the state u [B, bs, bs] (one component, blocks in the
// tree's Hilbert order, y fastest).
//
// Replaces mara3_tpu/kernels/amrsand_step.py:118 (advance_n_pallas). It
// computes what kernels/amrsand_step.py's advance_n_plain computes,
// operation for operation: per step, each cell reads its x- and y-lower
// neighbors, and a cell on a block's lower edge reads its guard through the
// 2:1 AMR exchange of its face (same level: the neighbor's edge cell; a
// coarser neighbor: the cell of its edge at coarse_half * bs/2 + p/2; two
// finer neighbors: a = 0.5 (inner + edge) at q = 2p mod bs and q + 1, then
// 0.5 a[q] + 0.5 a[q + 1]); then u - c (2 u - u_xm1 - u_ym1), left to
// right, with the block's c = (0.5 dt) / dx.
//
// Bound: a call of n steps need only read the state once and write it once:
// 21.4 MB at depth 7, block 64 (652 blocks, 2,670,592 cells) in float32,
// 0.0064 ms at 3.35 TB/s. The operations are 5 a cell and step (2 u, two
// subtracts, the product with c, the update), 0.40 us a step at 33.5e12 a
// second. So a design that keeps the state in device memory between steps
// moves 21.4 MB a step, 0.0064 ms at 3.35 TB/s: the byte floor of a
// launch-a-step design, as B1 and B5 are built.
// What the design does:
//   - one thread a cell, a CTA of 256 consecutive cells (four rows of a
//     64-wide block); interior cells read their two neighbors, edge cells
//     their guard from the packed face table [B, 2, 6] (case, same, coarse,
//     coarse_half, fine0, fine1 of the x-lo and y-lo faces);
//   - one launch a step; a C loop issues all n on the caller's stream,
//     ping-ponging the state between the output and a scratch buffer;
//   - at depth 7, block 64 the state (10.7 MB in float32) and its copy fit
//     in the 50 MB L2, so the steps read it mostly from there.
// Nothing is padded: any B and any even bs.
//
// Built with --fmad=false: every product and sum rounds as in the plain
// version, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the lo-side guard at position p along the face of one block; face points
// at its six table entries. On the x face the neighbor's row i (along x) is
// read at column p; on the y face its column i at row p.
template <typename T, bool XFACE>
__device__ __forceinline__ T lo_guard(const T* __restrict__ u,
                                      const int* __restrict__ face, int bs,
                                      int p) {
  const auto at = [&](int n, int i, int q) -> T {
    const int base = n * bs * bs;
    return XFACE ? u[base + i * bs + q] : u[base + q * bs + i];
  };
  const int half = bs / 2;
  if (face[0] == 0) return at(face[1], bs - 1, p);
  if (face[0] == 1) return at(face[2], bs - 1, face[3] * half + p / 2);
  const int nb = face[p < half ? 4 : 5];
  const int q = (2 * p) % bs;
  const T aq = T(0.5) * (at(nb, bs - 2, q) + at(nb, bs - 1, q));
  const T aq1 = T(0.5) * (at(nb, bs - 2, q + 1) + at(nb, bs - 1, q + 1));
  return T(0.5) * aq + T(0.5) * aq1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ src, T* __restrict__ dst,
            const int* __restrict__ faces, const T* __restrict__ c, int B,
            int bs) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int per_block = bs * bs;
  if (k >= B * per_block) return;
  const int b = k / per_block;
  const int i = (k / bs) % bs;
  const int j = k % bs;
  const T u = src[k];
  const T xm1 = i == 0 ? lo_guard<T, true>(src, faces + 12 * b, bs, j)
                       : src[k - bs];
  const T ym1 = j == 0 ? lo_guard<T, false>(src, faces + 12 * b + 6, bs, i)
                       : src[k - 1];
  dst[k] = u - c[b] * (T(2) * u - xm1 - ym1);
}

template <typename T>
int advance_n(const T* u, T* out, T* scr, const int* faces, const T* c,
              int B, int bs, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B * bs * bs + kThreads - 1) / kThreads);
  cudaError_t err = cudaSuccess;
  const T* src = u;
  for (int k = 1; k <= n && err == cudaSuccess; ++k) {
    // step k writes out when n - k is even, so the last step lands in out
    T* dst = ((n - k) % 2 == 0) ? out : scr;
    step_kernel<T><<<grid, kThreads, 0, s>>>(src, dst, faces, c, B, bs);
    err = cudaGetLastError();
    src = dst;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* b6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n steps of u [B, bs, bs] into out; scr is a second buffer of u's size,
// faces the [B, 2, 6] int32 lo-face table, c the [B] courant factors in u's
// type. bs even, B * bs * bs < 2^31. Returns a cudaError_t.
int b6_advance_n_f32(const float* u, float* out, float* scr, const int* faces,
                     const float* c, int B, int bs, int n, void* stream) {
  return advance_n<float>(u, out, scr, faces, c, B, bs, n, stream);
}

int b6_advance_n_f64(const double* u, double* out, double* scr,
                     const int* faces, const double* c, int B, int bs, int n,
                     void* stream) {
  return advance_n<double>(u, out, scr, faces, c, B, bs, n, stream);
}

}  // extern "C"
