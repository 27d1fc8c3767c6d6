// The column march: one forward-Euler stage of the periodic-in-y iso2d
// step (PLM with sign-bit half-slopes, HLLE or HLLC, the conservative
// update) over rows [r_lo, r_hi) of a state [3, rows, ny] (y contiguous)
// whose rows come through a row map. The stage kernel of kernel B1
// (iso2d_step.cu: the periodic plane) and kernel B9 (iso2d_ladder.cu: a
// stripe's window, first read from the stripe and its strips).
//
// Why: the earlier designs (B1's 16 x 32 shared-memory tiles, B9's
// windows) computed every half-slope twice, once for each face of a cell,
// loaded each tile's x and y halo anew, and B1 formed two integer modulos
// and a 64-bit index for every value it loaded. Without the slopes B1's
// step took 0.0811 ms of its 0.1104 at 2048^2 float32
// (tools/torch_iso2d_variants.py on the earlier source, NVIDIA H100 80GB
// HBM3, 700.00 W). The march computes each primitive, each half-slope and
// each face flux once, and loads the x halo once a chunk:
//   - a CTA owns W columns and a chunk of R output rows, which it marches
//     down in blocks of BR rows, one thread a cell of a block (a warp is 32
//     columns of one row), and one more warp that takes the halo's share
//     (its loads and y half-slopes, and each row's face j0 - 1/2), so that
//     no warp does more than its cell's work between two barriers;
//   - a block's new rows (two ahead of it) are loaded one block ahead (a
//     register prefetch), recovered to primitives once a cell (the two
//     IEEE divisions) and kept with the conserved values in shared-memory
//     rings, with two wrapped halo columns a side for the rows the chunk
//     updates;
//   - then the block's x half-slopes (rows one below it) and y half-slopes
//     once a cell, into rings; then its x faces (the upper face of each
//     row) and y faces (j + 1/2) once a face; then the update of each
//     cell, which reads its lower x face from the ring (the block above
//     formed it) and writes the cell once. These phases run as a two-step
//     pipeline over the blocks, two barriers a block (march_kernel);
//   - a row's address (wrapped, or from the stripe and its strips) is
//     formed once a chunk into a table in shared memory; a column's (and
//     the halo columns') once a thread; a ring slot is a sum and a mask:
//     no modulo per element (the integer pipe, half the float32 one's
//     width, was the kernel's limit as much as its arithmetic);
//   - a chunk primes its ring with the two rows above it, their x slopes
//     and the chunk's lower x face (which the chunk above forms too), and
//     ends with the two rows below: about (R + 4) / R of the loads and
//     primitives, less of the rest.
// Each cell's arithmetic is face_flux's and cell_update's
// (iso2d_cell.cuh), through its two steps half_slopes and
// face_from_slopes, so with --fmad=false the march gives the same bits as
// the window kernels B8 and B10a-c.

#pragma once

#include <cuda_runtime.h>

#include "iso2d_cell.cuh"

namespace iso2d {

// a row: component q of column c at ptr[q * qstride + c]
template <typename T>
struct Row {
  T* ptr;
  long long qstride;
};

// how a stage's rows map to memory
enum RowMode {
  kNone = -1,
  kPlane = 0,      // a periodic state [3, nx, ny]: rows wrap in [0, nx)
  kStrips = 1,     // stripe s's window: rows [0, h) of lo[s], then the
                   // stripe's TX rows of a plane [3, nx, ny], then hi[s]
  kWindow = 2,     // a window buffer [gi, 3, WX, ny]
  kStripeOut = 3,  // window row w of stripe s: plane row s TX + w - h
};

template <typename T>
struct Rows {
  T* plane = nullptr;
  T* lo = nullptr;
  T* hi = nullptr;
  T* win = nullptr;
  int mode = kNone, nx = 0, ny = 0, TX = 0, h = 0, WX = 0;

  __device__ __forceinline__ Row<T> at(int s, int r) const {
    const long long plane_q = (long long)nx * ny;
    switch (mode) {
      case kPlane:
        r = r < 0 ? r + nx : (r >= nx ? r - nx : r);
        return {plane + (long long)r * ny, plane_q};
      case kStrips:
        if (r < h) return {lo + ((long long)s * 3 * h + r) * ny,
                           (long long)h * ny};
        if (r < h + TX) return {plane + ((long long)s * TX + r - h) * ny,
                                plane_q};
        return {hi + ((long long)s * 3 * h + r - h - TX) * ny,
                (long long)h * ny};
      case kWindow:
        return {win + ((long long)s * 3 * WX + r) * ny, (long long)WX * ny};
      default:
        return {plane + ((long long)s * TX + r - h) * ny, plane_q};
    }
  }
};

template <typename T>
Rows<T> plane_rows(const T* u, int nx, int ny) {
  Rows<T> m;
  m.plane = const_cast<T*>(u);
  m.mode = kPlane;
  m.nx = nx;
  m.ny = ny;
  return m;
}

template <typename T>
__device__ __forceinline__ void load_row(const Row<T> row, int c, T v[3]) {
  const T* at = row.ptr + c;
  for (int q = 0; q < 3; ++q) v[q] = __ldg(at + q * row.qstride);
}

// (sigma, vx, vy) of a cell's conserved values
template <typename T>
__device__ __forceinline__ void recover(const T v[3], T P[3]) {
  P[0] = v[0];
  P[1] = v[1] / v[0];
  P[2] = v[2] / v[0];
}

// threads a march CTA's block of cells (one a cell: 256 in float32, 128 in
// float64), and the CTA's: one more warp for the halo
template <typename T>
__host__ __device__ constexpr int march_threads() {
  return sizeof(T) == 4 ? 256 : 128;
}

template <typename T>
__host__ __device__ constexpr int march_cta_threads() {
  return march_threads<T>() + 32;
}

// CTAs an SM that the launch bounds ask registers for
constexpr int kMarchCtasPerSm = 4;

// a CTA's width W (columns) and the most output rows R of a chunk
// (tools/torch_iso2d_variants.py rebuilds with others)
constexpr int kMarchW = 64;
constexpr int kMarchR = 64;

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// The march's shared memory for W columns and blocks of BR rows: rings of
// MP >= 2 BR + 2 rows of primitives (slot k + 2 column j0 + k) and
// conserved values (slot k), and of MG >= BR + 1 rows of x half-slopes and
// x faces (face a between rows a - 1 and a), a block's y half-slopes and y
// faces (face b between columns j0 + b - 1 and j0 + b), and the chunk's
// rows: its input rows i0 - 2 .. i1 + 1, its output and base rows i0 ..
// i1 - 1. The rings' sizes are powers of two, so that a slot is a sum and
// a mask
template <typename T>
struct MarchSmem {
  static constexpr int W = kMarchW, BR = march_threads<T>() / W,
                       MP = pow2_at_least(2 * BR + 2),
                       MG = pow2_at_least(BR + 1);
  T P[MP][3][W + 4];
  T U[MP][3][W];
  T Gx[MG][3][W];
  T Fx[MG][3][W];
  T Gy[BR][3][W + 4];
  T Fy[BR][3][W + 1];
  Row<T> in[kMarchR + 4], out[kMarchR], base[kMarchR];
};

// k + d modulo m, a power of two
__device__ __forceinline__ int ring_add(int k, int d, int m) {
  return (k + d) & (m - 1);
}

// One stage over output rows [r_lo, r_hi) of every stripe s = blockIdx.z:
// dst = E(src), or with `average` 0.5 * (base + E(src)) (base may be dst:
// each thread reads base at its own cell, then writes it). Input rows
// [r_lo - 2, r_hi + 2) are read. Chunk blockIdx.y has output rows [i0, i1)
// = [i0, i0 + R) of them (R <= kMarchR), columns [j0, j0 + W) with W =
// kMarchW and j0 = blockIdx.x W.
//
// Thread (rho, j)'s cell in a block is row rho of column j. A block goes
// through four phases: L (its new rows into the rings), S (x and y
// half-slopes), F (x and y faces) and U (the update). They run as a
// pipeline of two steps a block, one barrier after each: F of block k with
// L of block k + 1, then U of block k with S of block k + 1; so each step
// holds two independent pieces of work, and a block costs two barriers.
// The rings of primitives and conserved values hold 2 BR + 2 rows or more,
// so that L of block k + 1 never meets the rows that F and U of block k
// read. The phases compute unconditionally: rows past the chunk's end (in
// its last block) compute from stale ring rows into their own ring slots,
// which no row of the chunk reads; only the loads (whose rows are clamped
// into the chunk's input rows) and the stores to device memory are
// guarded.
template <typename T, bool HLLC>
__global__ void __launch_bounds__(march_cta_threads<T>(), kMarchCtasPerSm)
march_kernel(Rows<T> src, Rows<T> base, Rows<T> dst, bool average, int r_lo,
             int r_hi, int R, int ny, Params<T> p) {
  using Smem = MarchSmem<T>;
  constexpr int NT = march_threads<T>(), CT = march_cta_threads<T>();
  constexpr int W = Smem::W, BR = Smem::BR, MP = Smem::MP, MG = Smem::MG;
  // halo jobs a lane of the halo warp: loads (4 a row), y slopes (2), y
  // faces (1)
  constexpr int HJ = (4 * BR + 31) / 32;
  static_assert(W % 32 == 0 && NT % W == 0 && BR >= 2,
                "whole warps a row, two rows or more a block");
  static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory, 48 KB");
  __shared__ Smem sm;
  const int s = blockIdx.z;
  const int i0 = r_lo + blockIdx.y * R, i1 = min(i0 + R, r_hi);
  const int n = i1 - i0;
  const int j0 = blockIdx.x * W, nw = min(W, ny - j0);
  const bool worker = threadIdx.x < NT;
  const int rho = threadIdx.x / W, j = threadIdx.x % W;
  const bool col = worker && j < nw;
  const int c = col ? j0 + j : j0;
  // the halo warp's lane hl: its load jobs h = hl + 32 m < 4 BR are row
  // h / 4 of a block's new rows, column j0 - 2, j0 - 1, j0 + nw or j0 + nw
  // + 1 (wrapped) into slot 0, 1, nw + 2 or nw + 3 (by h % 4 = hl % 4)
  const int hl = threadIdx.x - NT;
  int hc = 0, hs = 0;
  if (hl >= 0) {
    const int off = hl % 4 < 2 ? hl % 4 - 2 : nw + hl % 4 - 2;
    hc = j0 + off;
    hc = hc < 0 ? hc + ny : (hc >= ny ? hc - ny : hc);
    hs = off + 2;
  }
  // the chunk's rows, their addresses formed once
  for (int k = threadIdx.x; k < n + 4; k += CT)
    sm.in[k] = src.at(s, i0 - 2 + k);
  for (int k = threadIdx.x; k < n; k += CT) {
    sm.out[k] = dst.at(s, i0 + k);
    if (average) sm.base[k] = base.at(s, i0 + k);
  }
  // input row x's entry, x clamped into the chunk's input rows
  const auto in = [&](int x) -> const Row<T>& {
    return sm.in[min(x, i1 + 1) - i0 + 2];
  };

  // a loaded cell's primitives into ring slot ps, column slot k
  const auto store = [&](int ps, int k, const T v[3]) {
    T P[3];
    recover(v, P);
    for (int q = 0; q < 3; ++q) sm.P[ps][q][k] = P[q];
  };
  // x half-slopes of the row at slot pc (rows at pm, pp beside it) into
  // slot gs
  const auto x_slopes = [&](int pm, int pc, int pp, int gs) {
    T lo[3], ce[3], hi[3], g[3];
    for (int q = 0; q < 3; ++q) {
      lo[q] = sm.P[pm][q][j + 2];
      ce[q] = sm.P[pc][q][j + 2];
      hi[q] = sm.P[pp][q][j + 2];
    }
    half_slopes(lo, ce, hi, p.half_theta, g);
    for (int q = 0; q < 3; ++q) sm.Gx[gs][q][j] = g[q];
  };
  // the y half-slopes of slot ps's (block row b's) column slot k; stored
  // where `keep`
  const auto y_slopes = [&](int ps, int b, int k, bool keep) {
    T lo[3], ce[3], hi[3], g[3];
    for (int q = 0; q < 3; ++q) {
      lo[q] = sm.P[ps][q][k - 1];
      ce[q] = sm.P[ps][q][k];
      hi[q] = sm.P[ps][q][k + 1];
    }
    half_slopes(lo, ce, hi, p.half_theta, g);
    if (keep)
      for (int q = 0; q < 3; ++q) sm.Gy[b][q][k] = g[q];
  };
  // the x face between the rows at (pa, ga) and (pb, gb), into Fx[gb]
  const auto x_face = [&](int pa, int ga, int pb, int gb) {
    T va[3], sa[3], vb[3], sb[3], f[3];
    for (int q = 0; q < 3; ++q) {
      va[q] = sm.P[pa][q][j + 2];
      sa[q] = sm.Gx[ga][q][j];
      vb[q] = sm.P[pb][q][j + 2];
      sb[q] = sm.Gx[gb][q][j];
    }
    face_from_slopes<T, HLLC, false>(va, sa, vb, sb, p.cs2, p.cs, f);
    for (int q = 0; q < 3; ++q) sm.Fx[gb][q][j] = f[q];
  };
  // slot ps's (block row b's) y face between column slots k and k + 1
  const auto y_face = [&](int ps, int b, int k) {
    T va[3], sa[3], vb[3], sb[3], f[3];
    for (int q = 0; q < 3; ++q) {
      va[q] = sm.P[ps][q][k];
      sa[q] = sm.Gy[b][q][k];
      vb[q] = sm.P[ps][q][k + 1];
      sb[q] = sm.Gy[b][q][k + 1];
    }
    face_from_slopes<T, HLLC, true>(va, sa, vb, sb, p.cs2, p.cs, f);
    for (int q = 0; q < 3; ++q) sm.Fy[b][q][k - 1] = f[q];
  };
  __syncthreads();

  // prime: rows i0 - 2 .. i0 + 1 into slots 0 .. 3 (the halo for the
  // chunk's rows among them), then the x slopes of rows i0 - 1 and i0
  // (slots 1, 2), then the face i0; load the first block's new rows
  T nxt[3] = {}, hnxt[HJ][3] = {};
  if (col) {
    for (int x = i0 - 2 + rho; x < i0 + 2; x += BR) {
      T v[3];
      load_row(in(x), c, v);
      store(x - i0 + 2, j + 2, v);
      for (int q = 0; q < 3; ++q) sm.U[x - i0 + 2][q][j] = v[q];
    }
    load_row(in(i0 + 2 + rho), c, nxt);
  }
  if (hl >= 0) {
    if (hl < 8 && hl / 4 < n) {
      T v[3];
      load_row(in(i0 + hl / 4), hc, v);
      store(2 + hl / 4, hs, v);
    }
    for (int m = 0; m < HJ; ++m)
      if (hl + 32 * m < 4 * BR)
        load_row(in(i0 + 2 + (hl + 32 * m) / 4), hc, hnxt[m]);
  }
  __syncthreads();
  if (col && rho < 2) x_slopes(rho, rho + 1, rho + 2, rho + 1);
  __syncthreads();
  if (col && rho == 0) x_face(1, 1, 2, 2);
  __syncthreads();

  // The phases of the block whose first row r sits at ring slots bp (P, U)
  // and bg (Gx, Fx); row r + d at ring_add(bp, d, MP), ring_add(bg, d, MG).
  // L: the block's new rows r + 2 .. r + BR + 1 into the rings, the next
  // block's loaded ahead
  const auto phase_l = [&](int r, int bp) {
    if (worker) {
      T v[3];
      for (int q = 0; q < 3; ++q) v[q] = nxt[q];
      load_row(in(r + rho + 2 + BR), c, nxt);
      if (col) {
        const int k = ring_add(bp, rho + 2, MP);
        store(k, j + 2, v);
        for (int q = 0; q < 3; ++q) sm.U[k][q][j] = v[q];
      }
    } else {
      for (int m = 0; m < HJ; ++m) {
        const int h = hl + 32 * m;
        if (h < 4 * BR && r + 2 + h / 4 < i1) {
          T v[3];
          for (int q = 0; q < 3; ++q) v[q] = hnxt[m][q];
          load_row(in(r + 2 + h / 4 + BR), hc, hnxt[m]);
          store(ring_add(bp, 2 + h / 4, MP), hs, v);
        }
      }
    }
  };
  // S: x slopes of rows r + 1 .. r + BR; y slopes of the block's rows (the
  // halo warp's: slots 1 and nw + 2)
  const auto phase_s = [&](int bp, int bg) {
    if (worker) {
      const int p0 = ring_add(bp, rho, MP);
      x_slopes(p0, ring_add(p0, 1, MP), ring_add(p0, 2, MP),
               ring_add(bg, rho + 1, MG));
      y_slopes(p0, rho, j + 2, col);
    } else {
      for (int h = hl; h < 2 * BR; h += 32)
        y_slopes(ring_add(bp, h / 2, MP), h / 2, h % 2 == 0 ? 1 : nw + 2,
                 true);
    }
  };
  // F: x faces r + 1 .. r + BR (each row's upper face); y faces
  const auto phase_f = [&](int r, int bp, int bg) {
    if (worker) {
      const int p0 = ring_add(bp, rho, MP), g0 = ring_add(bg, rho, MG);
      x_face(p0, g0, ring_add(p0, 1, MP), ring_add(g0, 1, MG));
      y_face(p0, rho, j + 2);
    } else {
      for (int h = hl; h < BR; h += 32)
        if (r + h < i1) y_face(ring_add(bp, h, MP), h, 1);
    }
  };
  // U: the update of the block's cells
  const auto phase_u = [&](int r, int bp, int bg) {
    if (!worker) return;
    const int y = r + rho, p0 = ring_add(bp, rho, MP),
              g0 = ring_add(bg, rho, MG), g1 = ring_add(g0, 1, MG);
    T out[3];
    for (int q = 0; q < 3; ++q)
      out[q] = cell_update(sm.U[p0][q][j], sm.Fx[g0][q][j], sm.Fx[g1][q][j],
                           sm.Fy[rho][q][j], sm.Fy[rho][q][j + 1], p);
    if (col && y < i1) {
      if (average) {
        T ub[3];
        load_row(sm.base[y - i0], c, ub);
        for (int q = 0; q < 3; ++q) out[q] = T(0.5) * (ub[q] + out[q]);
      }
      const Row<T> d = sm.out[y - i0];
      T* at = d.ptr + c;
      for (int q = 0; q < 3; ++q) at[q * d.qstride] = out[q];
    }
  };

  // the ring slots of the first block's row i0
  int r = i0, bp = 2, bg = 2;
  phase_l(r, bp);
  __syncthreads();
  phase_s(bp, bg);
  __syncthreads();
  for (; r + BR < i1; r += BR) {
    const int np = ring_add(bp, BR, MP), ng = ring_add(bg, BR, MG);
    phase_l(r + BR, np);
    phase_f(r, bp, bg);
    __syncthreads();
    phase_u(r, bp, bg);
    phase_s(np, ng);
    __syncthreads();
    bp = np;
    bg = ng;
  }
  phase_f(r, bp, bg);
  __syncthreads();
  phase_u(r, bp, bg);
}

// One stage over output rows [r_lo, r_hi) of `stripes` stripes, in CTAs of
// kMarchW columns and chunks of at most kMarchR rows (as few chunks as that
// needs, evened out), on `stream`. Returns the launch's error.
template <typename T, bool HLLC>
cudaError_t march_stage(const Rows<T>& src, const Rows<T>& base,
                        const Rows<T>& dst, bool average, int r_lo, int r_hi,
                        int ny, int stripes, const Params<T>& p,
                        cudaStream_t stream) {
  if (r_hi <= r_lo) return cudaErrorInvalidValue;
  const int n = r_hi - r_lo, chunks = (n + kMarchR - 1) / kMarchR;
  const int R = (n + chunks - 1) / chunks;
  const dim3 grid((ny + kMarchW - 1) / kMarchW, (n + R - 1) / R, stripes);
  march_kernel<T, HLLC><<<grid, march_cta_threads<T>(), 0, stream>>>(
      src, base, dst, average, r_lo, r_hi, R, ny, p);
  return cudaGetLastError();
}

// The march kernel's resources on the current card: registers and local
// bytes a thread, static shared memory a CTA, CTAs an SM (the occupancy
// calculator's), into out[0..3]
template <typename T, bool HLLC>
cudaError_t march_info(int* out) {
  const void* fn = (const void*)march_kernel<T, HLLC>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, march_cta_threads<T>(), 0);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = per_sm;
  return cudaSuccess;
}

}  // namespace iso2d
