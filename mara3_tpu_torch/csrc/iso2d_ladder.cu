// Kernels B8, B9, B10a, B10b and B10c: the periodic iso2d step (PLM + HLLE
// or HLLC, forward Euler or SSP-RK2) of the JAX package's earlier
// uniform-grid kernels, on a state u [3, nx, ny] with y contiguous; B8 with
// the flagship's locally isothermal sound speed, the others at a constant
// cs^2.
//
// Replaces (mara3_tpu/kernels/...):
//   B8   iso2d_step_li.py:143 pallas_step_li: G rk1 HLLE steps of tiles TX x
//        TY from strips of h = 2 G, as B10c, with cs^2 = 1 / (M^2 sqrt(r^2 +
//        r_s^2)) at each face from its wrapped position;
//   B9   iso2d_step_v4.py:135 pallas_step_v4_strips: G steps of full-width
//        x-stripes of TX rows from the caller's x-halo strips lo, hi
//        [nx / TX, 3, h, ny] (h = 2 G rk_order), y periodic; the kernel of
//        kh's x-sharded run (parallel/iso2d_sharded.py);
//   B10a iso2d_step.py:211 pallas_step: one rk1 HLLE step from the
//        periodic guard-extended buffer [3, nx + 4, ny + 4];
//   B10b iso2d_step_v2.py:115 pallas_step_v2: one rk1 HLLE step of tiles
//        TX x TY from each tile's four halo strips (h = 2);
//   B10c iso2d_step_v3.py:46 pallas_step_v3: G rk1 HLLE steps of such tiles
//        from strips of h = 2 G.
// Each computes what its plain version in kernels/iso2d_step_v{4,1,2,3}.py
// or iso2d_step_li.py computes, operation for operation, through the
// per-face and per-cell functions of iso2d_cell.cuh that kernel B1 uses
// too; B9 through B1's column march (iso2d_march.cuh).
//
// Bound. A step needs about 194 operations a cell with HLLE (212 with HLLC),
// 0.024 ms at 2048^2 float32 at 33.5e12 operations a second (no FMAs under
// --fmad=false); one pass over the state (read and write) is 0.030 ms. B10a
// and B10b take one step a launch, so they are bound by that pass. B8, B9
// and B10c take G steps for one pass, so the operations bind them, with the
// halo's recomputation on top: the function updates each tile's (or
// stripe's) window, which shrinks by 2 cells a side a stage. B8 forms each
// face's sound speed in 24 more operations (the position 3 and the wrap 5
// an axis, cs^2 7, cs 1), of which the function needs cs^2 and cs (8): a
// face's coordinates are its row's or its column's.
//
// Design:
//   - B10a: one thread a cell, reading the nine cells of its cross from the
//     extended buffer in device memory and computing its four face fluxes
//     itself (each face twice, once by each of its cells: the same inputs
//     and operations, so the same bits);
//   - B9: a C loop of the column march's stages (iso2d_march.cuh), G for
//     rk1 and 2G for rk2, each launch over every stripe's window [3, TX +
//     2h, ny] whose valid rows shrink by 2 a side a stage: the first stage
//     reads the stripe's rows and its strips through a row map, the middle
//     stages two window buffers [gi, 3, TX + 2h, ny] (rk2's second stage
//     writes the Heun average in place over the step's start, as B1 does),
//     the last writes the stripe's rows of out. Each stripe is computed
//     from its own strips alone, as on the TPU, so the windows are per
//     stripe, not one global state: caller-built strips need not agree
//     with the neighbouring stripe. A stage moves about WX / TX of the
//     state, and computes each half-slope and face once, where a window
//     of the stripe's sub-tile would recompute the x and y halos;
//   - B10b, B10c: one CTA of 512 threads a CX x CY sub-tile of a strip
//     tile (CX, CY chosen by the wrapper so the window fits in shared
//     memory), never straddling two of them, so every halo value comes
//     from that tile's own strips, as on the TPU. The CTA loads its window,
//     (CX + 2h) x (CY + 2h) conserved cells, into dynamic shared memory
//     once, runs all G rk1 HLLE steps there (primitives, x and y face
//     fluxes, the update in place), the valid region shrinking by 2 a side
//     a stage, and writes only the sub-tile. Device memory sees one read of
//     the window and one write of the sub-tile per launch.
//   - B10b is B10c's kernel at G = 1 (as v2 is v3 at G = 1 on the TPU).
//   - B8 is B10c's kernel with the sound speed formed at each face from the
//     geometry in registers (the cs^2 field never exists in device memory,
//     as on the TPU). A face's position is rounded as the TPU kernel rounds
//     it, from its TPU tile's window origin ox = x0 + (ti TX - h + 1/2) dx,
//     that step's offset (2 s) dx (formed in double, then cast) and the
//     face's index ii in the step's shrunk window of the TPU tile: so the
//     CTA, which holds only a sub-tile, recovers ti and ii (Local).
//   - The y halo of B9's window wraps periodically inside the stripe's rows
//     (the TPU kernel's lane rolls); only x halos come from strips.

#include <cuda_runtime.h>

#include "iso2d_march.cuh"

extern __shared__ __align__(16) unsigned char ladder_smem[];

namespace {

using iso2d::Params;

constexpr int kThreads = 512;       // B8, B10b, B10c
constexpr int kCellRows = 8;        // B10a: a block of 8 x 32 cells
constexpr int kCellCols = 32;

// The window's arrays in dynamic shared memory, each [3][WX][WY]: the
// conserved state U (updated in place), the primitives P, the x face
// fluxes FX (face r between rows r - 1 and r) and the y face fluxes FY
// (face c between columns c - 1 and c).
template <typename T>
struct Window {
  T* U;
  T* P;
  T* FX;
  T* FY;
  int WX, WY;
  __device__ __forceinline__ int at(int q, int r, int c) const {
    return (q * WX + r) * WY + c;
  }
};

// The cells k = threadIdx.x, threadIdx.x + blockDim.x, ... of a region nc
// wide, in row-major order, as (r, c): one division when it starts, none a
// step.
struct Walk {
  int r, c, dr, dc, nc;
  __device__ __forceinline__ explicit Walk(int nc_) : nc(nc_) {
    r = threadIdx.x / nc;
    c = threadIdx.x % nc;
    dr = blockDim.x / nc;
    dc = blockDim.x % nc;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
};

template <typename T>
__device__ __forceinline__ Window<T> carve(int WX, int WY) {
  T* base = reinterpret_cast<T*>(ladder_smem);
  const int n = 3 * WX * WY;
  Window<T> w;
  w.U = base;
  w.P = base + n;
  w.FX = base + 2 * n;
  w.FY = base + 3 * n;
  w.WX = WX;
  w.WY = WY;
  return w;
}

// B8's locally isothermal sound speed: the geometry cast to T (dx in double
// too, for the steps' offsets), the CTA's TPU-tile window origin (ox, oy)
// and its sub-tile's offset (li0, lj0) in that tile.
template <typename T>
struct Local {
  T dx, x0, y0, Lx, Ly, mach2, rsoft2;
  double dx_d;
  T ox, oy;
  int li0, lj0;
};

// One forward-Euler HLLE stage of the valid region [r0, r1) x [c0, c1) of
// U: afterwards [r0 + 2, r1 - 2) x [c0 + 2, c1 - 2) holds E(U). With LI
// (B8) each face takes its own sound speed from `loc`, the stage being s =
// r0 / 2 = c0 / 2.
template <typename T, bool LI>
__device__ void window_stage(const Window<T>& w, int r0, int r1, int c0,
                             int c1, const Params<T>& p, const Local<T>& loc) {
  T ox = T(0), oy = T(0);
  if (LI) {
    const T off = T(double(r0) * loc.dx_d);   // (2 s) dx
    ox = loc.ox + off;
    oy = loc.oy + off;
  }
  const int nr = r1 - r0, nc = c1 - c0;
  for (Walk k(nc); k.r < nr; k.next()) {
    const int r = r0 + k.r, c = c0 + k.c;
    const T sg = w.U[w.at(0, r, c)];
    w.P[w.at(0, r, c)] = sg;
    w.P[w.at(1, r, c)] = w.U[w.at(1, r, c)] / sg;
    w.P[w.at(2, r, c)] = w.U[w.at(2, r, c)] / sg;
  }
  __syncthreads();
  const int ir = nr - 4, ic = nc - 4;     // the rows, columns that survive
  // x faces a in [r0 + 2, r1 - 1), on the surviving columns
  for (Walk k(ic); k.r < nr - 3; k.next()) {
    const int a = r0 + 2 + k.r, c = c0 + 2 + k.c;
    T m[3], x0[3], x1[3], pp[3], f[3];
    for (int q = 0; q < 3; ++q) {
      m[q] = w.P[w.at(q, a - 2, c)];
      x0[q] = w.P[w.at(q, a - 1, c)];
      x1[q] = w.P[w.at(q, a, c)];
      pp[q] = w.P[w.at(q, a + 1, c)];
    }
    if (LI) {
      // the face f = ii of the TPU window's step, at x = ox + (ii + 3/2) dx
      // and on its column jj, y = oy + (jj + 2) dx
      const T x = iso2d::wrapped_coord(ox, loc.li0 + a - 2 - r0, T(1.5),
                                       loc.dx, loc.x0, loc.Lx);
      const T y = iso2d::wrapped_coord(oy, loc.lj0 + c - 2 - c0, T(2),
                                       loc.dx, loc.y0, loc.Ly);
      const T cs2 = iso2d::cs2_at(x, y, loc.mach2, loc.rsoft2);
      iso2d::face_flux<T, false, false>(m, x0, x1, pp, p.half_theta, cs2,
                                      sqrt(cs2), f);
    } else {
      iso2d::face_flux<T, false, false>(m, x0, x1, pp, p, f);
    }
    for (int q = 0; q < 3; ++q) w.FX[w.at(q, a, c)] = f[q];
  }
  // y faces b in [c0 + 2, c1 - 1), on the surviving rows
  for (Walk k(nc - 3); k.r < ir; k.next()) {
    const int r = r0 + 2 + k.r, b = c0 + 2 + k.c;
    T m[3], y0[3], y1[3], pp[3], f[3];
    for (int q = 0; q < 3; ++q) {
      m[q] = w.P[w.at(q, r, b - 2)];
      y0[q] = w.P[w.at(q, r, b - 1)];
      y1[q] = w.P[w.at(q, r, b)];
      pp[q] = w.P[w.at(q, r, b + 1)];
    }
    if (LI) {
      const T x = iso2d::wrapped_coord(ox, loc.li0 + r - 2 - r0, T(2),
                                       loc.dx, loc.x0, loc.Lx);
      const T y = iso2d::wrapped_coord(oy, loc.lj0 + b - 2 - c0, T(1.5),
                                       loc.dx, loc.y0, loc.Ly);
      const T cs2 = iso2d::cs2_at(x, y, loc.mach2, loc.rsoft2);
      iso2d::face_flux<T, false, true>(m, y0, y1, pp, p.half_theta, cs2,
                                     sqrt(cs2), f);
    } else {
      iso2d::face_flux<T, false, true>(m, y0, y1, pp, p, f);
    }
    for (int q = 0; q < 3; ++q) w.FY[w.at(q, r, b)] = f[q];
  }
  __syncthreads();
  for (Walk k(ic); k.r < ir; k.next()) {
    const int r = r0 + 2 + k.r, c = c0 + 2 + k.c;
    for (int q = 0; q < 3; ++q) {
      const T e = iso2d::cell_update(w.U[w.at(q, r, c)], w.FX[w.at(q, r, c)],
                                     w.FX[w.at(q, r + 1, c)],
                                     w.FY[w.at(q, r, c)],
                                     w.FY[w.at(q, r, c + 1)], p);
      w.U[w.at(q, r, c)] = e;
    }
  }
  __syncthreads();
}

// G rk1 steps of the window [0, wx) x [0, wy) loaded in U. The result is
// U's region [h, wx - h) x [h, wy - h), h = 2 G.
template <typename T, bool LI>
__device__ void window_steps(const Window<T>& w, int wx, int wy, int G,
                             const Params<T>& p, const Local<T>& loc) {
  int r0 = 0, r1 = wx, c0 = 0, c1 = wy;
  for (int g = 0; g < G; ++g) {
    window_stage<T, LI>(w, r0, r1, c0, c1, p, loc);
    r0 += 2; r1 -= 2; c0 += 2; c1 -= 2;
  }
}

// B8, B10b, B10c: the CTA's sub-tile is rows [li0, li0 + cx) and columns
// [lj0, lj0 + cy) of tile (ti, tj); its window's halo comes from the tile's
// strips: north, south [gi, gj, 3, h, TY + 2h] (rows above and below, the
// corners included), west, east [gi, gj, 3, TX, h]. LI: B8, `geom` its
// geometry.
template <typename T, bool LI>
__global__ void __launch_bounds__(kThreads)
tiles_kernel(const T* __restrict__ u, const T* __restrict__ north,
             const T* __restrict__ south, const T* __restrict__ west,
             const T* __restrict__ east, T* __restrict__ out, int nx, int ny,
             int TX, int TY, int h, int G, int CX, int CY, int subx, int suby,
             Params<T> p, Local<T> geom) {
  const int gj = ny / TY;
  const int ti = blockIdx.y / subx, li0 = (blockIdx.y % subx) * CX;
  const int tj = blockIdx.x / suby, lj0 = (blockIdx.x % suby) * CY;
  const int cx = min(CX, TX - li0), cy = min(CY, TY - lj0);
  const int wx = cx + 2 * h, wy = cy + 2 * h;
  const Window<T> w = carve<T>(CX + 2 * h, CY + 2 * h);
  const long long plane = (long long)nx * ny;
  const long long tile = (long long)ti * gj + tj;
  const int ns = TY + 2 * h;      // a north or south strip's row
  for (Walk k(wy); k.r < wx; k.next()) {
    const int a = k.r, b = k.c;
    const int x = li0 + a - h, y = lj0 + b - h;
    for (int q = 0; q < 3; ++q) {
      const long long tq = tile * 3 + q;
      T v;
      if (x < 0) {
        v = north[(tq * h + x + h) * ns + y + h];
      } else if (x >= TX) {
        v = south[(tq * h + x - TX) * ns + y + h];
      } else if (y < 0) {
        v = west[(tq * TX + x) * h + y + h];
      } else if (y >= TY) {
        v = east[(tq * TX + x) * h + y - TY];
      } else {
        v = u[q * plane + (long long)(ti * TX + x) * ny + tj * TY + y];
      }
      w.U[w.at(q, a, b)] = v;
    }
  }
  __syncthreads();
  Local<T> loc = geom;
  if (LI) {
    // the TPU tile's window origin: its cell (0, 0), global (ti TX - h, tj
    // TY - h), at x0 + (ti TX - h + 1/2) dx
    loc.ox = loc.x0 + T(double(ti * TX - h) + 0.5) * loc.dx;
    loc.oy = loc.y0 + T(double(tj * TY - h) + 0.5) * loc.dx;
    loc.li0 = li0;
    loc.lj0 = lj0;
  }
  window_steps<T, LI>(w, wx, wy, G, p, loc);
  for (Walk k(cy); k.r < cx; k.next()) {
    const int a = k.r, b = k.c;
    const long long c =
        (long long)(ti * TX + li0 + a) * ny + tj * TY + lj0 + b;
    for (int q = 0; q < 3; ++q) out[q * plane + c] = w.U[w.at(q, h + a, h + b)];
  }
}

// (sigma, vx, vy) of the extended buffer's cell (r, c)
template <typename T>
__device__ __forceinline__ void prim_at(const T* __restrict__ ext,
                                        long long plane, int NY, int r, int c,
                                        T P[3]) {
  const long long k = (long long)r * NY + c;
  const T sg = ext[k];
  P[0] = sg;
  P[1] = ext[plane + k] / sg;
  P[2] = ext[2 * plane + k] / sg;
}

// B10a: one thread a cell (i, j), at (i + 2, j + 2) of ext [3, nx+4, ny+4]
template <typename T>
__global__ void __launch_bounds__(kCellRows * kCellCols)
cell_kernel(const T* __restrict__ ext, T* __restrict__ out, int nx, int ny,
            Params<T> p) {
  const int j = blockIdx.x * kCellCols + threadIdx.x % kCellCols;
  const int i = blockIdx.y * kCellRows + threadIdx.x / kCellCols;
  if (i >= nx || j >= ny) return;
  const int NY = ny + 4;
  const long long plane = (long long)(nx + 4) * NY;
  T X[5][3], Y[5][3];       // the cells i - 2 .. i + 2 and j - 2 .. j + 2
  for (int d = 0; d < 5; ++d) {
    prim_at(ext, plane, NY, i + d, j + 2, X[d]);
    prim_at(ext, plane, NY, i + 2, j + d, Y[d]);
  }
  T fxl[3], fxr[3], fyl[3], fyr[3];
  iso2d::face_flux<T, false, false>(X[0], X[1], X[2], X[3], p, fxl);
  iso2d::face_flux<T, false, false>(X[1], X[2], X[3], X[4], p, fxr);
  iso2d::face_flux<T, false, true>(Y[0], Y[1], Y[2], Y[3], p, fyl);
  iso2d::face_flux<T, false, true>(Y[1], Y[2], Y[3], Y[4], p, fyr);
  const long long c = (long long)(i + 2) * NY + j + 2;
  const long long o = (long long)i * ny + j;
  for (int q = 0; q < 3; ++q) {
    out[q * (long long)nx * ny + o] = iso2d::cell_update(
        ext[q * plane + c], fxl[q], fxr[q], fyl[q], fyr[q], p);
  }
}

// dynamic shared memory of a window kernel's CTA
template <typename T>
size_t window_bytes(int CX, int CY, int h) {
  return size_t(4) * 3 * (CX + 2 * h) * (CY + 2 * h) * sizeof(T);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// B9: G steps (rk 1, or 2 as the stages' Heun pairs) of every stripe's
// window [3, WX, ny], WX = TX + 2h, as a C loop of march stages. `plan`
// holds the stages, 5 ints each (kernels/iso2d_step_v4.stage_plan): the
// roles of src, base and dst (kB9* below, or -1 for no base) and the
// output rows [r_lo, r_hi) of the window. The window buffers X and Y are
// [gi, 3, WX, ny]; the first stage reads the stripe and its strips, the
// last writes the stripe's rows of out.
enum B9Role { kB9Strips = 0, kB9X = 1, kB9Y = 2, kB9Out = 3 };

template <typename T>
iso2d::Rows<T> b9_rows(int role, const T* u, const T* lo, const T* hi, T* out,
                       T* X, T* Y, int nx, int ny, int TX, int h) {
  iso2d::Rows<T> m;
  m.nx = nx;
  m.ny = ny;
  m.TX = TX;
  m.h = h;
  m.WX = TX + 2 * h;
  switch (role) {
    case kB9Strips:
      m.mode = iso2d::kStrips;
      m.plane = const_cast<T*>(u);
      m.lo = const_cast<T*>(lo);
      m.hi = const_cast<T*>(hi);
      break;
    case kB9X:
      m.mode = iso2d::kWindow;
      m.win = X;
      break;
    case kB9Y:
      m.mode = iso2d::kWindow;
      m.win = Y;
      break;
    case kB9Out:
      m.mode = iso2d::kStripeOut;
      m.plane = out;
      break;
  }
  return m;
}

template <typename T>
int b9(const T* u, const T* lo, const T* hi, T* out, T* X, T* Y, int nx,
       int ny, int TX, int h, int hllc, const int* plan,
       int stages, double cs2, double dtdx, double dtdy, double theta,
       void* stream) {
  const Params<T> p = iso2d::make_params<T>(cs2, dtdx, dtdy, theta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto rows = [&](int role) {
    return role < 0 ? iso2d::Rows<T>()
                    : b9_rows<T>(role, u, lo, hi, out, X, Y, nx, ny, TX, h);
  };
  const int gi = nx / TX;
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < stages && err == cudaSuccess; ++k) {
    const int* e = plan + 5 * k;
    const auto src = rows(e[0]), base = rows(e[1]), dst = rows(e[2]);
    err = hllc ? iso2d::march_stage<T, true>(src, base, dst, e[1] >= 0, e[3],
                                             e[4], ny, gi, p, st)
               : iso2d::march_stage<T, false>(src, base, dst, e[1] >= 0, e[3],
                                              e[4], ny, gi, p, st);
  }
  return static_cast<int>(err);
}

// B8 (LI) and B10b/B10c: G steps of the tiles from their strips
template <typename T, bool LI>
int tiles(const T* u, const T* north, const T* south, const T* west,
          const T* east, T* out, int nx, int ny, int TX, int TY, int G,
          int CX, int CY, const Params<T>& p, const Local<T>& geom,
          void* stream) {
  const int h = 2 * G;
  const int subx = (TX + CX - 1) / CX, suby = (TY + CY - 1) / CY;
  const dim3 grid((ny / TY) * suby, (nx / TX) * subx);
  const size_t bytes = window_bytes<T>(CX, CY, h);
  cudaError_t err = allow_smem(tiles_kernel<T, LI>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tiles_kernel<T, LI><<<grid, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      u, north, south, west, east, out, nx, ny, TX, TY, h, G, CX, CY, subx,
      suby, p, geom);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int b10_tiles(const T* u, const T* north, const T* south, const T* west,
              const T* east, T* out, int nx, int ny, int TX, int TY, int G,
              int CX, int CY, double cs2, double dtdx, double dtdy,
              double theta, void* stream) {
  return tiles<T, false>(u, north, south, west, east, out, nx, ny, TX, TY, G,
                         CX, CY, iso2d::make_params<T>(cs2, dtdx, dtdy, theta),
                         Local<T>(), stream);
}

// B8: the geometry (dx, x0, y0, Lx, Ly, mach2, rsoft2) cast to T, as the
// ladder's other scalars (make_params); the constant cs^2 is not used
template <typename T>
int b8_tiles(const T* u, const T* north, const T* south, const T* west,
             const T* east, T* out, int nx, int ny, int TX, int TY, int G,
             int CX, int CY, double dx, double x0, double y0, double Lx,
             double Ly, double mach2, double rsoft2, double dtdx, double dtdy,
             double theta, void* stream) {
  Local<T> geom;
  geom.dx = T(dx);
  geom.x0 = T(x0);
  geom.y0 = T(y0);
  geom.Lx = T(Lx);
  geom.Ly = T(Ly);
  geom.mach2 = T(mach2);
  geom.rsoft2 = T(rsoft2);
  geom.dx_d = dx;
  geom.ox = geom.oy = T(0);
  geom.li0 = geom.lj0 = 0;
  return tiles<T, true>(u, north, south, west, east, out, nx, ny, TX, TY, G,
                        CX, CY, iso2d::make_params<T>(0.0, dtdx, dtdy, theta),
                        geom, stream);
}

template <typename T>
int b10a(const T* ext, T* out, int nx, int ny, double cs2, double dtdx,
         double dtdy, double theta, void* stream) {
  const Params<T> p = iso2d::make_params<T>(cs2, dtdx, dtdy, theta);
  const dim3 grid((ny + kCellCols - 1) / kCellCols,
                  (nx + kCellRows - 1) / kCellRows);
  cell_kernel<T><<<grid, kCellRows * kCellCols, 0,
                   static_cast<cudaStream_t>(stream)>>>(ext, out, nx, ny, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ladder_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// B9: the stages of `plan` (stages x 5 ints) on u [3, nx, ny] (nx % TX ==
// 0) and its strips lo, hi [nx / TX, 3, h, ny] into out, through the window
// buffers X, Y [nx / TX, 3, TX + 2h, ny]; hllc 0 or 1. Returns a
// cudaError_t.
int b9_strips_f32(const float* u, const float* lo, const float* hi,
                  float* out, float* X, float* Y, int nx, int ny, int TX,
                  int h, int hllc, const int* plan, int stages, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b9<float>(u, lo, hi, out, X, Y, nx, ny, TX, h, hllc, plan, stages,
                   cs2, dtdx, dtdy, theta, stream);
}

int b9_strips_f64(const double* u, const double* lo, const double* hi,
                  double* out, double* X, double* Y, int nx, int ny, int TX,
                  int h, int hllc, const int* plan, int stages, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b9<double>(u, lo, hi, out, X, Y, nx, ny, TX, h, hllc, plan, stages,
                    cs2, dtdx, dtdy, theta, stream);
}

// The march kernel's registers, local bytes, static shared memory and CTAs
// an SM (out[0..3]); f64 and hllc 0 or 1
int b9_kernel_info(int f64, int hllc, int* out) {
  cudaError_t err;
  if (f64) {
    err = hllc ? iso2d::march_info<double, true>(out)
               : iso2d::march_info<double, false>(out);
  } else {
    err = hllc ? iso2d::march_info<float, true>(out)
               : iso2d::march_info<float, false>(out);
  }
  return static_cast<int>(err);
}

// B10a: one rk1 HLLE step from ext [3, nx + 4, ny + 4] into out [3, nx, ny]
int b10a_step_f32(const float* ext, float* out, int nx, int ny, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b10a<float>(ext, out, nx, ny, cs2, dtdx, dtdy, theta, stream);
}

int b10a_step_f64(const double* ext, double* out, int nx, int ny, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b10a<double>(ext, out, nx, ny, cs2, dtdx, dtdy, theta, stream);
}

// B10b (G = 1) and B10c: G rk1 HLLE steps of the tiles TX x TY of u from
// their strips of h = 2 G (build_halo_strips), CTA sub-tiles CX x CY
int b10_tiles_f32(const float* u, const float* north, const float* south,
                  const float* west, const float* east, float* out, int nx,
                  int ny, int TX, int TY, int G, int CX, int CY, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b10_tiles<float>(u, north, south, west, east, out, nx, ny, TX, TY,
                          G, CX, CY, cs2, dtdx, dtdy, theta, stream);
}

int b10_tiles_f64(const double* u, const double* north, const double* south,
                  const double* west, const double* east, double* out, int nx,
                  int ny, int TX, int TY, int G, int CX, int CY, double cs2,
                  double dtdx, double dtdy, double theta, void* stream) {
  return b10_tiles<double>(u, north, south, west, east, out, nx, ny, TX, TY,
                           G, CX, CY, cs2, dtdx, dtdy, theta, stream);
}

// B8: G locally isothermal rk1 HLLE steps of the tiles TX x TY of u from
// their strips of h = 2 G, CTA sub-tiles CX x CY; geometry (dx, x0, y0, Lx,
// Ly, mach2, rsoft2)
int b8_tiles_f32(const float* u, const float* north, const float* south,
                 const float* west, const float* east, float* out, int nx,
                 int ny, int TX, int TY, int G, int CX, int CY, double dx,
                 double x0, double y0, double Lx, double Ly, double mach2,
                 double rsoft2, double dtdx, double dtdy, double theta,
                 void* stream) {
  return b8_tiles<float>(u, north, south, west, east, out, nx, ny, TX, TY, G,
                         CX, CY, dx, x0, y0, Lx, Ly, mach2, rsoft2, dtdx,
                         dtdy, theta, stream);
}

int b8_tiles_f64(const double* u, const double* north, const double* south,
                 const double* west, const double* east, double* out, int nx,
                 int ny, int TX, int TY, int G, int CX, int CY, double dx,
                 double x0, double y0, double Lx, double Ly, double mach2,
                 double rsoft2, double dtdx, double dtdy, double theta,
                 void* stream) {
  return b8_tiles<double>(u, north, south, west, east, out, nx, ny, TX, TY,
                          G, CX, CY, dx, x0, y0, Lx, Ly, mach2, rsoft2, dtdx,
                          dtdy, theta, stream);
}

}  // extern "C"
