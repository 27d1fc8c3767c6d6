// Kernel B7: n first-order upwind steps of the sand3d octree advection at a
// velocity v > 0 on the state u [B, bs, bs, bs] (x, y, z; z fastest; blocks
// in the tree's Morton order).
//
// Replaces mara3_tpu/kernels/sand3d_step.py:177 (advance_n_pallas). It
// computes what kernels/sand3d_step.py's advance_n_plain computes, operation
// for operation: per step, each cell reads its x-, y- and z-lower
// neighbors, and a cell on a block's lower face reads its guard through the
// 2:1 AMR exchange of that face, over the face's tangential axes (t1, t2)
// (same level: the neighbor's hi-face cell; a coarser neighbor: its cell
// (tq1 bs/2 + t1/2, tq2 bs/2 + t2/2); four finer neighbors: child
// k = b2 2 + b1's four face cells, 0.25 x (2i, 2j) + 0.25 x (2i, 2j+1) +
// 0.25 x (2i+1, 2j) + 0.25 x (2i+1, 2j+1), left to right); then
// du = c0 (u - xm1) + c1 (u - ym1) + c2 (u - zm1) and u - du, with
// c[a][b] = v[a] dt / dx[b]. For v > 0 the scheme's conservative flux
// correction is a no-op, so this is the whole step.
//
// Bound: a call of n steps need only read the state once and write it once:
// 11.3 MB at depth 4, block 16 (344 blocks, 1,409,024 cells) in float32,
// 0.0034 ms at 3.35 TB/s. The operations are 9 a cell and step (three
// subtracts, three products, two sums, the update), 0.38 us a step at
// 33.5e12 a second. A design that keeps the state in device memory between
// steps moves 11.3 MB a step: 0.0034 ms a step is the byte floor of a
// launch-a-step design.
// What the design does:
//   - one thread a cell, a CTA of 256 consecutive cells (one x-plane of a
//     16^3 block); interior cells read their three neighbors, face cells
//     their guard from the packed face table [B, 3, 9] (case, same, coarse,
//     tq1, tq2, fine0..3 of the x-lo, y-lo and z-lo faces);
//   - one launch a step; a C loop issues all n on the caller's stream,
//     ping-ponging the state between the output and a scratch buffer;
//   - the state (5.6 MB in float32) and its copy stay in the 50 MB L2.
// Nothing is padded: any B and any even bs.
//
// Built with --fmad=false: every product and sum rounds as in the plain
// version, so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the lo-side guard at tangential position (t1, t2) of face AXIS of one
// block; face points at its nine table entries. The neighbor's hi face is
// its plane at index bs - 1 along AXIS.
template <typename T, int AXIS>
__device__ __forceinline__ T lo_guard(const T* __restrict__ u,
                                      const int* __restrict__ face, int bs,
                                      int t1, int t2) {
  const auto at = [&](int n, int p1, int p2) -> T {
    const int e = bs - 1;
    const int x = AXIS == 0 ? e : p1;
    const int y = AXIS == 0 ? p1 : (AXIS == 1 ? e : p2);
    const int z = AXIS == 2 ? e : p2;
    return u[((n * bs + x) * bs + y) * bs + z];
  };
  const int h = bs / 2;
  if (face[0] == 0) return at(face[1], t1, t2);
  if (face[0] == 1)
    return at(face[2], face[3] * h + t1 / 2, face[4] * h + t2 / 2);
  const int b1 = t1 / h, b2 = t2 / h;
  const int nb = face[5 + b2 * 2 + b1];
  const int i2 = 2 * (t1 - b1 * h), j2 = 2 * (t2 - b2 * h);
  return T(0.25) * at(nb, i2, j2) + T(0.25) * at(nb, i2, j2 + 1)
         + T(0.25) * at(nb, i2 + 1, j2) + T(0.25) * at(nb, i2 + 1, j2 + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ src, T* __restrict__ dst,
            const int* __restrict__ faces, const T* __restrict__ c, int B,
            int bs) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int per_block = bs * bs * bs;
  if (k >= B * per_block) return;
  const int b = k / per_block;
  const int x = (k / (bs * bs)) % bs;
  const int y = (k / bs) % bs;
  const int z = k % bs;
  const int* face = faces + 27 * b;
  const T u = src[k];
  const T xm1 = x == 0 ? lo_guard<T, 0>(src, face, bs, y, z)
                       : src[k - bs * bs];
  const T ym1 = y == 0 ? lo_guard<T, 1>(src, face + 9, bs, x, z)
                       : src[k - bs];
  const T zm1 = z == 0 ? lo_guard<T, 2>(src, face + 18, bs, x, y)
                       : src[k - 1];
  const T du = c[b] * (u - xm1) + c[B + b] * (u - ym1)
               + c[2 * B + b] * (u - zm1);
  dst[k] = u - du;
}

template <typename T>
int advance_n(const T* u, T* out, T* scr, const int* faces, const T* c,
              int B, int bs, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B * bs * bs * bs + kThreads - 1) / kThreads);
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

const char* b7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n steps of u [B, bs, bs, bs] into out; scr is a second buffer of u's
// size, faces the [B, 3, 9] int32 lo-face table, c the [3, B] courant
// factors in u's type. bs even, B * bs^3 < 2^31. Returns a cudaError_t.
int b7_advance_n_f32(const float* u, float* out, float* scr, const int* faces,
                     const float* c, int B, int bs, int n, void* stream) {
  return advance_n<float>(u, out, scr, faces, c, B, bs, n, stream);
}

int b7_advance_n_f64(const double* u, double* out, double* scr,
                     const int* faces, const double* c, int B, int bs, int n,
                     void* stream) {
  return advance_n<double>(u, out, scr, faces, c, B, bs, n, stream);
}

}  // extern "C"
