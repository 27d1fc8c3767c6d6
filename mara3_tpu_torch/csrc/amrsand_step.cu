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
// second. A design that moves the state through device memory every step
// moves 21.4 MB a step, 0.0064 ms: so the call is bound by bytes only if
// the state stays on the chip between steps, as the TPU kernel kept the
// whole mesh in VMEM for all n steps.
//
// Two designs, chosen by the wrapper from the sizes alone before the launch
// (kernels/amrsand_step.py resident_plan):
//
// resident_kernel, where the mesh fits in the co-resident CTAs' shared
// memory (depth 7, block 64: 652 blocks of 16 KB in float32 over 132 CTAs,
// 5 blocks and 82 KB a CTA; 165 KB in float64). One cooperative launch a
// call (resident_loop.cuh): CTA g owns the blocks starts[g] .. starts[g+1]
// (a contiguous run in Hilbert order, from the wrapper's plan) and holds
// them, their courant factors and face tables in shared memory for all n
// steps. Before step 1 it writes each block's hi-side edge row and
// next-inner row, in x and in y, to edge buffer 0 ([B, 4, bs]: x edge,
// x inner, y edge, y inner), and one grid barrier follows. A step:
//   1. the guards of the CTA's blocks ([nb, 2, bs] in shared memory) from
//      the edge buffer of the step's parity, through the face table, by the
//      arithmetic of the per-step kernel's guard (one thread a guard);
//   2. the update in place, a row march: a unit of lanes holds one row of
//      a block (C consecutive columns a lane) and marches down a part of
//      the block's rows, a cell's x-1 neighbor being the old row above in
//      registers and its y-1 neighbor the old value to its left (a
//      register, or the next lane down by a shuffle, or the y guard). Each
//      part reads the old row above it before a CTA barrier and no unit
//      reads another's rows after it. Before the march, between two CTA
//      barriers, the new edge and inner rows are formed from the old state
//      (the same operations, so the same bits) and stored to the other
//      edge buffer, so that the stores reach the L2 while the march runs
//      (stored as the march formed them, the barriers after them waited
//      on them: 0.13 ms more of a 256-step call at depth 7, block 64);
//   3. one grid barrier.
// The state is read from device memory once and written once a call; a
// step moves only the edge rows (4 bs values a block, 0.67 MB at depth 7,
// block 64 in float32) through the L2. A cell's row, column and block come
// from shifts and masks (bs a power of two, at most 128); no division.
//
// step_kernel, the launch-a-step design, for meshes that do not fit (depth
// 7, block 128: 42.7 MB in float32): one thread a cell, a CTA of 32 x 8
// threads over 8 rows of one block (the grid's y index is the block, its x
// index the row tile), so a cell's row and column come from the thread
// index with no division; a C loop issues all n launches on the caller's
// stream, ping-ponging the state between the output and a scratch buffer.
//
// Built with --fmad=false: every product and sum rounds as in the plain
// version, so the two agree bit for bit.

#include <cuda_runtime.h>

#include "resident_loop.cuh"

namespace {

constexpr int kThreads = 256;          // step_kernel: 32 x 8
constexpr int kTileRows = 8;
constexpr int kResidentThreads = 1024;  // resident_kernel
constexpr int kFace = 6;               // a face's entries in the table

// The lo-side guard at position p along one face from its table entries
// face[0..5] (case, same, coarse, coarse_half, fine0, fine1); at(n, r, q)
// reads block n's hi-side row r (0 the edge, 1 the next-inner) at q.
template <typename T, typename At>
__device__ __forceinline__ T guard(const At& at, const int* face, int bs,
                                   int p) {
  const int half = bs >> 1;
  if (face[0] == 0) return at(face[1], 0, p);
  if (face[0] == 1) return at(face[2], 0, face[3] * half + (p >> 1));
  const int nb = face[p < half ? 4 : 5];
  const int q = 2 * p < bs ? 2 * p : 2 * p - bs;   // 2p mod bs
  const T aq = T(0.5) * (at(nb, 1, q) + at(nb, 0, q));
  const T aq1 = T(0.5) * (at(nb, 1, q + 1) + at(nb, 0, q + 1));
  return T(0.5) * aq + T(0.5) * aq1;
}

// ---------------------------------------------------------------------------
// the launch-a-step design
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ src, T* __restrict__ dst,
            const int* __restrict__ faces, const T* __restrict__ c, int B,
            int bs) {
  const int i = blockIdx.x * kTileRows + threadIdx.y;
  if (i >= bs) return;
  const long long per_block = (long long)bs * bs;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* ub = src + b * per_block;
    const int* fx = faces + 2 * kFace * b;
    const T cb = c[b];
    // the neighbor's hi-side row r along x (at column q) or along y (at
    // row q)
    const auto at_x = [&](int n, int r, int q) -> T {
      return src[n * per_block + (bs - 1 - r) * bs + q];
    };
    const auto at_y = [&](int n, int r, int q) -> T {
      return src[n * per_block + (long long)q * bs + bs - 1 - r];
    };
    for (int j = threadIdx.x; j < bs; j += 32) {
      const int k = i * bs + j;
      const T u = ub[k];
      const T xm1 = i == 0 ? guard<T>(at_x, fx, bs, j) : ub[k - bs];
      const T ym1 = j == 0 ? guard<T>(at_y, fx + kFace, bs, i) : ub[k - 1];
      dst[b * per_block + k] = u - cb * (T(2) * u - xm1 - ym1);
    }
  }
}

template <typename T>
cudaError_t per_step(const T* u, T* out, T* scr, const int* faces,
                     const T* c, int B, int bs, int n, cudaStream_t s) {
  const dim3 block(32, kTileRows);
  const dim3 grid((bs + kTileRows - 1) / kTileRows, B < 65535 ? B : 65535);
  cudaError_t err = cudaSuccess;
  const T* src = u;
  for (int k = 1; k <= n && err == cudaSuccess; ++k) {
    // step k writes out when n - k is even, so the last step lands in out
    T* dst = ((n - k) % 2 == 0) ? out : scr;
    step_kernel<T><<<grid, block, 0, s>>>(src, dst, faces, c, B, bs);
    err = cudaGetLastError();
    src = dst;
  }
  return err;
}

// ---------------------------------------------------------------------------
// the resident design
// ---------------------------------------------------------------------------

// Dynamic shared memory of a CTA of at most nb blocks: the blocks, their
// guards [nb, 2, bs] and courant factors, then their face tables.
template <typename T>
size_t resident_smem(int nb, int bs) {
  return (size_t)nb * ((size_t)bs * bs + 2 * bs + 1) * sizeof(T)
         + (size_t)nb * 2 * kFace * sizeof(int);
}

// A row of bs cells is a unit of L = bs / C lanes (C = 1 up to bs = 32,
// then 2, 4 for bs = 64, 128), C consecutive columns a lane; a warp holds
// 32 / L units.
template <int C>
__device__ __forceinline__ int lg_lanes(int lg) {
  return lg - (C == 1 ? 0 : (C == 2 ? 1 : 2));
}

template <typename T, int C>
__global__ void __launch_bounds__(kResidentThreads, 1)
resident_kernel(const T* __restrict__ u, T* __restrict__ out,
                const int* __restrict__ faces, const T* __restrict__ c,
                const int* __restrict__ starts, T* edges, int B, int lg,
                int nb_max, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = 1 << lg;
  const int mask = bs - 1;
  T* us = reinterpret_cast<T*>(smem);                  // [nb, bs, bs]
  T* gs = us + (size_t)nb_max * bs * bs;                // [nb, 2, bs]
  T* cs = gs + (size_t)nb_max * 2 * bs;                 // [nb]
  int* fs = reinterpret_cast<int*>(cs + nb_max);        // [nb, 2, 6]
  const int b0 = starts[blockIdx.x];
  const int nb = starts[blockIdx.x + 1] - b0;
  const int cells = nb << (2 * lg);
  const int t = threadIdx.x;
  const long long edge_size = (long long)B * 4 * bs;
  const T* ub = u + ((long long)b0 << (2 * lg));
  // the units, and the parts of a block each marches: P = 2^lgP parts of
  // R = bs / P rows, as many as make nb * P <= the units (at least 1)
  const int lgL = lg_lanes<C>(lg);
  const int unit = t >> lgL, lane = t & ((1 << lgL) - 1), col0 = lane * C;
  const int units = kResidentThreads >> lgL;
  int lgP = 0;
  while (lgP < lg && (nb << (lgP + 1)) <= units) ++lgP;
  const int jobs = nb << lgP, lgR = lg - lgP;

  for (int k = t; k < cells; k += kResidentThreads) us[k] = ub[k];
  for (int k = t; k < nb; k += kResidentThreads) cs[k] = c[b0 + k];
  for (int k = t; k < nb * 2 * kFace; k += kResidentThreads) {
    fs[k] = faces[2 * kFace * b0 + k];
  }
  __syncthreads();
  // the initial state's edge rows to buffer 0: row r of block lb, at p
  for (int e = t; e < nb * 4 * bs; e += kResidentThreads) {
    const int lb = e >> (lg + 2), r = (e >> lg) & 3, p = e & mask;
    const T* blk = us + ((size_t)lb << (2 * lg));
    const T v = r < 2 ? blk[((bs - 1 - r) << lg) + p]
                      : blk[(p << lg) + bs - 1 - (r - 2)];
    resident::store_edge(edges + (long long)b0 * 4 * bs + e, v);
  }
  resident::grid_sync();

  for (int step = 0; step < n; ++step) {
    const T* ein = resident::edge_buffer(edges, edge_size, step);
    T* eout = resident::edge_buffer(edges, edge_size, step + 1);
    const bool last = step + 1 == n;
    // 1. the guards (block lb's axis a at p), and each part's row above
    // it, the old values, before any unit writes
    for (int g = t; g < nb * 2 * bs; g += kResidentThreads) {
      const int lb = g >> (lg + 1), a = (g >> lg) & 1, p = g & mask;
      const auto at = [&](int nbr, int r, int q) -> T {
        return resident::load_edge(ein + ((long long)nbr * 4 + 2 * a + r)
                                             * bs + q);
      };
      gs[g] = guard<T>(at, fs + (2 * lb + a) * kFace, bs, p);
    }
    T prev[C];
    const int r1 = (unit & ((1 << lgP) - 1)) << lgR;   // the first job's
    if (unit < jobs && r1 > 0) {
      const T* row = us + ((size_t)(unit >> lgP) << (2 * lg))
                     + ((r1 - 1) << lg) + col0;
      for (int q = 0; q < C; ++q) prev[q] = row[q];
    }
    __syncthreads();
    // 2. the new edge rows first, from the old state, to the other edge
    // buffer, so that their stores reach the L2 while the march runs (the
    // march forms the same values again, in the same operations)
    if (!last) {
      for (int e = t; e < nb * 4 * bs; e += kResidentThreads) {
        const int lb = e >> (lg + 2), row = (e >> lg) & 3, p = e & mask;
        const int i = row < 2 ? bs - 1 - row : p;
        const int j = row < 2 ? p : bs - 1 - (row - 2);
        const T* blk = us + ((size_t)lb << (2 * lg));
        const T* gx = gs + ((2 * lb) << lg);
        const T u0 = blk[(i << lg) + j];
        const T xm1 = i == 0 ? gx[j] : blk[((i - 1) << lg) + j];
        const T ym1 = j == 0 ? gx[bs + i] : blk[(i << lg) + j - 1];
        resident::store_edge(eout + (long long)b0 * 4 * bs + e,
                             u0 - cs[lb] * (T(2) * u0 - xm1 - ym1));
      }
      __syncthreads();   // before any unit writes the old rows
    }
    // 3. each unit marches its part's rows: a cell's x-1 neighbor is the
    // row above (registers), its y-1 neighbor its left column (registers,
    // or the next lane down, or the y guard)
    for (int base = 0; base < jobs; base += units) {
      const int job = base + unit;
      const bool act = job < jobs;
      const int lb = act ? job >> lgP : 0;
      const int r0 = act ? (job & ((1 << lgP) - 1)) << lgR : 0;
      T* blk = us + ((size_t)lb << (2 * lg));
      const T* gx = gs + ((2 * lb) << lg);
      const T* gy = gx + bs;
      const T cb = cs[lb];
      if (r0 == 0) {
        for (int q = 0; q < C; ++q) prev[q] = gx[col0 + q];
      }
      T cur[C];
      for (int q = 0; q < C; ++q) cur[q] = blk[(r0 << lg) + col0 + q];
      for (int r = r0; r < r0 + (1 << lgR); ++r) {
        T nxt[C];
        const bool more = r + 1 < r0 + (1 << lgR);
        for (int q = 0; q < C; ++q) {
          nxt[q] = more ? blk[((r + 1) << lg) + col0 + q] : T(0);
        }
        const T left = __shfl_up_sync(0xffffffffu, cur[C - 1], 1, 1 << lgL);
        for (int q = 0; q < C; ++q) {
          const T ym1 = q > 0 ? cur[q - 1] : (lane > 0 ? left : gy[r]);
          const T v = cur[q] - cb * (T(2) * cur[q] - prev[q] - ym1);
          if (act) blk[(r << lg) + col0 + q] = v;
        }
        for (int q = 0; q < C; ++q) {
          prev[q] = cur[q];
          cur[q] = nxt[q];
        }
      }
    }
    // 4. one grid barrier (none after the last step)
    if (!last) resident::grid_sync();
  }
  __syncthreads();
  T* ob = out + ((long long)b0 << (2 * lg));
  for (int k = t; k < cells; k += kResidentThreads) ob[k] = us[k];
}

template <typename T, int C>
cudaError_t launch_resident(const T* u, T* out, const int* faces, const T* c,
                            const int* starts, T* edges, int ctas, int B,
                            int lg, int nb_max, int n, cudaStream_t s) {
  return resident::launch(resident_kernel<T, C>, ctas, kResidentThreads,
                          resident_smem<T>(nb_max, 1 << lg), s, u, out,
                          faces, c, starts, edges, B, lg, nb_max, n);
}

template <typename T>
cudaError_t run_resident(const T* u, T* out, const int* faces, const T* c,
                         const int* starts, T* edges, int ctas, int B, int bs,
                         int nb_max, int n, cudaStream_t s) {
  int lg = 1;
  while ((1 << lg) < bs) ++lg;
  if ((1 << lg) != bs || bs > 128) return cudaErrorInvalidValue;
  if (bs <= 32) {
    return launch_resident<T, 1>(u, out, faces, c, starts, edges, ctas, B,
                                 lg, nb_max, n, s);
  }
  if (bs == 64) {
    return launch_resident<T, 2>(u, out, faces, c, starts, edges, ctas, B,
                                 lg, nb_max, n, s);
  }
  return launch_resident<T, 4>(u, out, faces, c, starts, edges, ctas, B, lg,
                               nb_max, n, s);
}

}  // namespace

extern "C" {

const char* b6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (SMs, shared memory a CTA can opt into, shared memory an SM, shared
// memory reserved a CTA) of the current card
int b6_device_limits(int* out) {
  return static_cast<int>(resident::device_limits(out));
}

// The resident kernel's registers, local bytes, static shared memory and
// CTAs an SM at nb_max blocks of bs (out[0..3]), and its dynamic shared
// memory (out[4]); the per-step kernel's at nb_max = 0
int b6_kernel_info(int f64, int nb_max, int bs, int* out) {
  cudaError_t err;
  if (nb_max == 0) {
    out[4] = 0;
    err = f64 ? resident::kernel_info(step_kernel<double>, kThreads, 0, out)
              : resident::kernel_info(step_kernel<float>, kThreads, 0, out);
  } else {
    const size_t smem = f64 ? resident_smem<double>(nb_max, bs)
                            : resident_smem<float>(nb_max, bs);
    out[4] = (int)smem;
    if (bs <= 32) {
      err = f64 ? resident::kernel_info(resident_kernel<double, 1>,
                                        kResidentThreads, smem, out)
                : resident::kernel_info(resident_kernel<float, 1>,
                                        kResidentThreads, smem, out);
    } else if (bs == 64) {
      err = f64 ? resident::kernel_info(resident_kernel<double, 2>,
                                        kResidentThreads, smem, out)
                : resident::kernel_info(resident_kernel<float, 2>,
                                        kResidentThreads, smem, out);
    } else {
      err = f64 ? resident::kernel_info(resident_kernel<double, 4>,
                                        kResidentThreads, smem, out)
                : resident::kernel_info(resident_kernel<float, 4>,
                                        kResidentThreads, smem, out);
    }
  }
  return static_cast<int>(err);
}

// n steps of u [B, bs, bs] into out, launch a step; scr is a second buffer
// of u's size, faces the [B, 2, 6] int32 lo-face table, c the [B] courant
// factors in u's type. bs even, B * bs * bs < 2^31. Returns a cudaError_t.
int b6_advance_n_f32(const float* u, float* out, float* scr, const int* faces,
                     const float* c, int B, int bs, int n, void* stream) {
  return per_step<float>(u, out, scr, faces, c, B, bs, n,
                         static_cast<cudaStream_t>(stream));
}

int b6_advance_n_f64(const double* u, double* out, double* scr,
                     const int* faces, const double* c, int B, int bs, int n,
                     void* stream) {
  return per_step<double>(u, out, scr, faces, c, B, bs, n,
                          static_cast<cudaStream_t>(stream));
}

// n steps in one cooperative launch of `ctas` CTAs, CTA g owning blocks
// starts[g] .. starts[g + 1] (at most nb_max); edges two buffers of
// [B, 4, bs] in u's type. bs a power of two, at most 128.
int b6_resident_f32(const float* u, float* out, const int* faces,
                    const float* c, const int* starts, float* edges, int ctas,
                    int B, int bs, int nb_max, int n, void* stream) {
  return run_resident<float>(u, out, faces, c, starts, edges, ctas, B, bs,
                             nb_max, n, static_cast<cudaStream_t>(stream));
}

int b6_resident_f64(const double* u, double* out, const int* faces,
                    const double* c, const int* starts, double* edges,
                    int ctas, int B, int bs, int nb_max, int n,
                    void* stream) {
  return run_resident<double>(u, out, faces, c, starts, edges, ctas, B, bs,
                              nb_max, n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
