// Kernel B3: K complete steps of the flagship circumbinary-disk scheme per
// call, on the whole quadtree mesh, with no host read between steps.
//
// Replaces mara3_tpu/kernels/binary_multi.py::advance_k_pallas (its body
// _kernel_multi). Per step: the bodies from the orbital elements at the
// carried time (the fixed-count Kepler solve of models/two_body_device.py),
// primitive recovery and the CFL minimum over blocks of spacing / max
// wavespeed (or the fixed dt); per RK stage the guard exchange, kernel B2's
// update (binary_advance_core.cuh: PLM slopes, HLLE/HLLC + viscous face
// fluxes, the coarse-fine flux correction, sources, totals) and the fault
// count; for rk_order 2 a second stage at t + dt, then the 1/2-1/2 average
// of the state and of the time; and per stage the accretion work on each
// body and the orbital-element perturbations (element inversion of the
// accreted and forced body sets, periodic diffs), which move the carried
// elements, with the CM drift, once the stage starts after
// begin_live_binary. One float64 row of [16, 10] per stage carries the
// totals, dt, the fault flag, the stage-start time and the element rows
// (kernels/binary_multi.py, ROW_*), so the host only sums the rows.
//
// Bound (chip_smoke.py's count, d6b96 float32): the operations, about 18
// us a stage (0.5811 ms per 16 RK2 steps) at the card's float32 rate
// without FMA. The bytes are not the limit of the function (the state,
// initial_conserved and buffer_rate once a call), but they are of any
// design that keeps p and g in device memory between two passes: at d6b96
// float32 the arrays of a stage (u, s1, p and init 15 MB each, g 30 MB, br
// 5 MB) are twice the card's 50 MB L2, so each pass streams them from
// device memory. The sweeps below move about 33 values a cell a stage,
// 165 MB at d6b96 float32: a floor of about 49 us a stage.
//
// Design: ordinary launches, all issued by one C loop (advance_k) on the
// caller's stream. Each phase is its own kernel with its own
// __launch_bounds__, so the registers of the face flux, of the update's
// float64 accumulators and of the scalar code do not add up in one kernel,
// and each sweep runs at its own occupancy. Per stage:
//   b3_sweep1     recovery and the limited slopes, one CTA a 2D tile of a
//                 block (Tile<T>, clipped at the block's edges), a warp a
//                 row of it, the tile and its one-cell ring (no corner
//                 cells: no stencil is diagonal) in shared memory: each
//                 cell of the tile and its ring recovered once (the cells
//                 of the next tile, or the guard cells through the ring
//                 table: a copy, the matching half-cell, or the 2x2 mean of
//                 four recovered finer cells in neighbor_values' order), so
//                 a guard cell carries the bits it would have from the
//                 stored p; writes p and g, and at stage 1 the tile's CFL
//                 minimum.
//   b3_dt         at stage 1 with the CFL dt: the min of the tiles' minima
//                 into dyn, before sweep 2 reads it.
//   b3_sweep2     faces and update, a persistent march: as many CTAs as
//                 the card holds at once (one wave), each claiming pieces
//                 of the mesh (up to kMarchRows rows of a block's 32-column
//                 strip) one after another; a piece's p and g and their
//                 one-cell ring (the next cells of the block, or the guard
//                 cells through the ring table) into shared memory with
//                 cp.async, then every x- and y-face flux of the piece once
//                 into shared memory, the update of each cell, the new
//                 state and the piece's float64 partial totals. A block
//                 face where two finer neighbours meet it takes the sum of
//                 their two edge-face fluxes (restricted_flux's sum),
//                 recomputed here from their p and g: the same inputs as
//                 the finer block's own, so the same bits, and fx and fy
//                 never reach device memory.
//   b3_stage_end  one CTA: the totals, each thread summing its pieces'
//                 partials and block_sum the threads' in a fixed order;
//                 then in one thread the work done, the row, the element
//                 update and the next stage's bodies into dyn.
// plus b3_init once a call. So a step takes 4 launches at rk_order 1 (3
// with a fixed dt), 7 at rk_order 2. The host-side geometry (sweep 1's
// tiles, sweep 2's pieces, the ring's sources, the finer neighbours'
// faces) is built in kernels/binary_multi.py (tile_plan) and passed as
// tables. The sweeps stage each warp's row of outputs in shared memory, so
// its stores to the [.., 3] and [.., 6] arrays are contiguous. Where a
// block's spacing is a power of two (the flagship's meshes), sweep 1
// divides the slopes by it as a product with its exact inverse.
//
// Why sweep 2 marches: the earlier design, one CTA a 32 x 32 tile, took
// 5.20 ms of a 16-step call at d6b96 float32 (NVIDIA H100 80GB HBM3 at
// 700 W). Its 1,224 tiles at 3 CTAs an SM ran in four waves, the last of
// 36 CTAs. A march over even shares fixed in advance took 5.7-5.9 ms:
// the strips along finer neighbours cost more, and the slowest share set
// the time. So the CTAs claim their pieces as they go, and no CTA runs
// more than one piece past the others. Loads requested for the next piece
// while the piece before it computed (cp.async) were timed too and gained
// nothing beyond the runs' spread: the march is bound by its arithmetic.
// A box loaded through registers (plain loads, then stores to shared
// memory) took 5.07 ms; with cp.async, which holds no register, 4.2-4.3.
//
// Deterministic: every sum is of per-tile or per-piece float64 partials
// in a fixed order, whichever CTA computed a piece; the CFL reduce is a
// min, whose order does not matter. No atomics in any sum (they only hand
// out sweep 2's pieces), so two calls on the same input give the same
// bits. Built with --fmad=false like B2. binary_advance_core.cuh is
// included and not edited, so B2, B11b and B11c keep their bits.

#include "binary_advance_core.cuh"

namespace {

using namespace mara;

constexpr int kRows = 16, kLanes = 10;
// rows 0-7: the eight per-body totals in lanes 0-1; row 8: mass and
// angular momentum ejected in lanes 0 and 1
constexpr int kRowEjected = 8, kRowDt = 9, kRowInvalid = 10, kRowTprev = 11,
              kRowDacc = 12, kRowDgrv = 13, kRowOe = 14, kRowOeStage = 15;
// packed orbital elements (models/two_body_device.py)
constexpr int kPomega = 0, kTau = 1, kCmx = 2, kCmy = 3, kCmvx = 4,
              kCmvy = 5, kA = 6, kM = 7, kQ = 8, kE = 9;
constexpr int kKeplerIters = 10;
constexpr double kTwoPi = 6.283185307179586;
// the scalar state carried from one stage kernel to the next, in float64
// (exact for a float32 value): t, t + dt, the step's elements E and the
// stage-1 elements E1
constexpr int kCarryT = 0, kCarryT2 = 1, kCarryE = 2, kCarryE1 = 12;

// The CTAs an SM that each sweep's __launch_bounds__ asks registers for
// (tools/torch_b3_variants.py times other values)
constexpr int kSweep1Ctas = 4, kSweep2Ctas = 3;

// sweep 1's tile: rows along i by columns along j, the state's fastest
// index, one warp wide (kernels/binary_multi.TILE)
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int I = 32, J = 32;
};
template <>
struct Tile<double> {
  static constexpr int I = 16, J = 32;
};

// sweep 2's pieces: at most kMarchRows rows of a block's 32-column strip
// (kernels/binary_multi.MARCH_ROWS; 15: a full piece's 2 kMarchRows + 2
// rows of faces are four rounds of the kThreads / 32 warps; of 7, 15, 23
// and 31 rows the fastest at d6b96 float32)
constexpr int kMarchRows = 15;

template <typename T>
struct Args {
  T* u;                 // [B, bs, bs, 3] the state, advanced in place
  T* s1;                // [B, bs, bs, 3] the rk2 stage state
  T* p;                 // [B, bs, bs, 3] primitives
  T* g;                 // [B, bs, bs, 6] slopes
  const T* init;        // [B, bs, bs, 3]
  const T* br;          // [B, bs, bs]
  const double* axes;   // [B, 6, bs+1]
  const double* spacing;  // [B]
  const int* tiles;     // [n_tiles, 5] (block, i0, j0, ni, nj), sweep 1's
  const int* ring;      // [B, 4, bs, 4] a guard cell's source cells
  const int* fine;      // [B, 4, bs, 2] a finer neighbour's two faces
  const int* pieces;    // [n_pieces, 5] (block, i0, j0, ni, nj), sweep 2's
  int* work;            // [k_steps * rk] the pieces claimed, a launch each
  double* partials;     // [kTotals, n_pieces] sweep 2's
  double* totals;       // [kTotals] the stage's totals
  double* cfl_part;     // [n_tiles] sweep 1's CFL minima
  const double* start;  // t0, then the ten elements
  double* dyn;          // [kDynamic]: dt, theta, bodies of the stage
  double* carry;        // [22] the scalar state between stages
  double* rows;         // [k_steps * rk, kRows, kLanes]
  int B, bs, n_tiles, n_pieces, n_ctas, k_steps, rk, no_acc_force, fixed;
  double cfl, fixed_dt, live_after;
  Params prm;
};

// ---- two-body scalar code (models/two_body_device.py, one thread) ----------
// Run once a stage by one thread, so much of its time is the fetch of its
// instructions: the larger functions are called, not inlined, and the
// Kepler loop is not unrolled, which keeps the code small.

template <typename T>
__device__ T orbital_period(const T* e) {
  return T(kTwoPi) / sqrt(e[kM] / (e[kA] * e[kA] * e[kA]));
}

// bodies (mass, x, y, vx, vy) at time t (compute_two_body_state)
template <typename T>
__device__ __noinline__ void kepler_bodies(const T* e, T t, T body[2][5]) {
  const T a = e[kA], Mt = e[kM], q = e[kQ], ecc = e[kE];
  const T P = orbital_period(e);
  T n = ceil((e[kTau] - t) / P);
  n = n < T(0) ? T(0) : n;
  const T tloc = t + n * P - e[kTau];
  const T omega = a == T(0) ? T(0) : sqrt(Mt / (a * a * a));
  const T mu = q / (T(1) + q);
  const T Mv = omega * tloc;
  T Ecc = Mv;
  if (ecc > T(0)) {
    T x = Mv + ecc * sin(Mv) + T(0.5) * ecc * ecc * sin(T(2) * Mv);
#pragma unroll 1
    for (int it = 0; it < kKeplerIters; ++it) {
      const T y = x - ecc * sin(x) - Mv;
      x = x - y / (T(1) - ecc * cos(x));
    }
    Ecc = x;
  }
  const T cE = cos(Ecc), sE = sin(Ecc);
  const T root = sqrt(T(1) - ecc * ecc);
  const T x1 = -a * mu * (ecc - cE);
  const T y1 = +a * mu * sE * root;
  const T vx1 = -a * mu * omega / (T(1) - ecc * cE) * sE;
  const T vy1 = +a * mu * omega / (T(1) - ecc * cE) * cE * root;
  const T loc[2][5] = {{Mt * (T(1) - mu), x1, y1, vx1, vy1},
                       {Mt * mu, -x1 / q, -y1 / q, -vx1 / q, -vy1 / q}};
  const T c = cos(-e[kPomega]);
  const T s = sin(-e[kPomega]);
  for (int k = 0; k < 2; ++k) {
    const T x = loc[k][1], y = loc[k][2], vx = loc[k][3], vy = loc[k][4];
    body[k][0] = loc[k][0];
    body[k][1] = (+x * c + y * s) + e[kCmx];
    body[k][2] = (-x * s + y * c) + e[kCmy];
    body[k][3] = (+vx * c + vy * s) + e[kCmvx];
    body[k][4] = (-vx * s + vy * c) + e[kCmvy];
  }
}

// sqrt(x^2 + y^2) as jnp.hypot and two_body_device._hypot compute it
template <typename T>
__device__ T hypot_jax(T x, T y) {
  x = fabs(x);
  y = fabs(y);
  const T a = fmax(x, y), b = fmin(x, y);
  if (a == T(0)) return a;
  const T r = b / a;
  return a * sqrt(fma(r, r, T(1)));
}

// the inverse map (compute_orbital_elements); NaN for an unbound orbit
template <typename T>
__device__ __noinline__ void orbital_elements(const T b1[5], const T b2[5],
                                              T t, T out[10]) {
  const T M1 = b1[0], M2 = b2[0];
  const T Mt = M1 + M2;
  const T q = M2 / M1;
  const T x_cm = (b1[1] * M1 + b2[1] * M2) / Mt;
  const T y_cm = (b1[2] * M1 + b2[2] * M2) / Mt;
  const T vx_cm = (b1[3] * M1 + b2[3] * M2) / Mt;
  const T vy_cm = (b1[4] * M1 + b2[4] * M2) / Mt;
  const T x1 = b1[1] - x_cm, y1 = b1[2] - y_cm;
  const T x2 = b2[1] - x_cm, y2 = b2[2] - y_cm;
  const T r1 = hypot_jax(x1, y1);
  const T r2 = hypot_jax(x2, y2);
  const T vx1 = b1[3] - vx_cm, vy1 = b1[4] - vy_cm;
  const T vx2 = b2[3] - vx_cm, vy2 = b2[4] - vy_cm;
  const T vf1 = -vx1 * y1 / r1 + vy1 * x1 / r1;
  const T vf2 = -vx2 * y2 / r2 + vy2 * x2 / r2;
  const T v1 = hypot_jax(vx1, vy1);
  const T E1 = T(0.5) * M1 * (vx1 * vx1 + vy1 * vy1);
  const T E2 = T(0.5) * M2 * (vx2 * vx2 + vy2 * vy2);
  const T L = M1 * r1 * vf1 + M2 * r2 * vf2;
  T En = E1 + E2 - M1 * M2 / (r1 + r2);
  En = En < T(0) ? En : T(NAN);
  const T a = T(-0.5) * M1 * M2 / En;
  const T b = sqrt(T(-0.5) * L * L / En * Mt / (M1 * M2));
  T e2 = T(1) - b * b / (a * a);
  e2 = e2 < T(0) ? T(0) : (e2 > T(1) ? T(1) : e2);   // NaN stays NaN
  const T ecc = sqrt(e2);
  const T omega = sqrt(Mt / (a * a * a));
  const T a1 = a * q / (T(1) + q);
  const T b1_ = b * q / (T(1) + q);
  const bool circ = ecc == T(0);
  const T safe_e = circ ? T(1) : ecc;
  const T cn = circ ? x1 / r1 : (T(1) - r1 / a1) / safe_e;
  const T cf = a1 / r1 * (cn - ecc);
  const T root = sqrt(T(1) - ecc * ecc);
  const T sn = circ ? y1 / r1
                    : (vx1 * x1 + vy1 * y1) / (safe_e * v1 * r1)
                          * sqrt(T(1) - ecc * ecc * cn * cn);
  const T sf = (b1_ / r1) * sn;
  const T cE = (ecc + cf) / (T(1) + ecc * cf);
  const T sE = root * sf / (T(1) + ecc * cf);
  const T EE = atan2(sE, cE);
  const T MM = EE - ecc * sE;
  const T tau = t - MM / omega;
  const T ax = +(cn - ecc) * x1 + sn * root * y1;
  const T ay = +(cn - ecc) * y1 - sn * root * x1;
  const T vals[10] = {atan2(ay, ax), tau, x_cm, y_cm, vx_cm, vy_cm,
                      a, Mt, q, ecc};
  for (int j = 0; j < 10; ++j) out[j] = vals[j];
}

template <typename T>
__device__ T wrap(T delta, T period) {
  const T lo = delta + period;
  const T hi = delta - period;
  const T best = fabs(lo) < fabs(delta) ? lo : delta;
  return fabs(hi) < fabs(best) ? hi : best;
}

// d = b - a with pomega wrapped mod 2 pi and tau mod b's period (diff)
template <typename T>
__device__ __noinline__ void element_diff(const T* a, const T* b, T d[10]) {
  for (int j = 0; j < 10; ++j) d[j] = b[j] - a[j];
  d[kPomega] = wrap(d[kPomega], T(kTwoPi));
  d[kTau] = wrap(d[kTau], orbital_period(b));
}

// One stage's element update (two_body_device.perturbations, then
// E + (d_acc + d_grv + d_cm) * live, live once t > begin_live_binary):
// E_next, d_acc, d_grv.
template <typename T>
__device__ void evolve(const Args<T>& a, const T* E, const double* tot,
                       T body[2][5], T t, T dt, T E_next[10],
                       T d_acc[10], T d_grv[10]) {
  T acc[2][5], grv[2][5];
  for (int k = 0; k < 2; ++k) {
    const T m = body[k][0], vx = body[k][3], vy = body[k][4];
    const T dM = T(tot[0 + k]), dpx = T(tot[6 + k]), dpy = T(tot[8 + k]);
    const T fx = T(tot[10 + k]), fy = T(tot[12 + k]);
    acc[k][0] = m + dM;
    grv[k][0] = m;
    for (int c = 1; c < 3; ++c) acc[k][c] = grv[k][c] = body[k][c];
    acc[k][3] = a.no_acc_force ? vx : (m * vx + dpx) / (m + dM);
    acc[k][4] = a.no_acc_force ? vy : (m * vy + dpy) / (m + dM);
    grv[k][3] = vx + fx / m;
    grv[k][4] = vy + fy / m;
  }
  T e_acc[10], e_grv[10];
  orbital_elements(acc[0], acc[1], t, e_acc);
  orbital_elements(grv[0], grv[1], t, e_grv);
  element_diff(E, e_acc, d_acc);
  element_diff(E, e_grv, d_grv);
  const T live = t > T(a.live_after) ? T(1) : T(0);
  for (int j = 0; j < 10; ++j) {
    const T cm = j == kCmx ? E[kCmvx] * dt : (j == kCmy ? E[kCmvy] * dt : T(0));
    E_next[j] = E[j] + (d_acc[j] + d_grv[j] + cm) * live;
  }
}

// ---- guard cells from the ring table ---------------------------------------

// the source cells of the guard cell outside face f of block b at position
// pos: the first alone (same or coarser neighbour; the rest -1), or four
// finer cells (block_layout.build_guard_gather's cells, in its order)
__device__ __forceinline__ const int* ring_cells(const int* ring, int b,
                                                 int f, int pos, int bs) {
  return ring + (((long long)b * 4 + f) * bs + pos) * 4;
}

// the C values of that guard cell from v [B, bs, bs, C], summed as
// neighbor_values sums them
template <typename T, int C>
__device__ void ring_value(const T* v, const int* ring, int b, int f,
                           int pos, int bs, T out[C]) {
  const int* s = ring_cells(ring, b, f, pos, bs);
  if (s[1] < 0) {
    for (int c = 0; c < C; ++c) out[c] = v[(long long)s[0] * C + c];
    return;
  }
  for (int c = 0; c < C; ++c) {
    out[c] = T(0.25) * v[(long long)s[0] * C + c]
           + T(0.25) * v[(long long)s[1] * C + c]
           + T(0.25) * v[(long long)s[2] * C + c]
           + T(0.25) * v[(long long)s[3] * C + c];
  }
}

// the primitive guard cell recovered from the state: ring_value of the
// primitives that recover_at gives each source cell
template <typename T>
__device__ void ring_recovered(const Args<T>& a, const T* src, int b, int f,
                               int pos, int cp, T out[3]) {
  const int* s = ring_cells(a.ring, b, f, pos, a.bs);
  T P0[3];
  recover_at(src, a.axes, s[0], a.bs, cp, P0);
  if (s[1] < 0) {
    for (int c = 0; c < 3; ++c) out[c] = P0[c];
    return;
  }
  T P1[3], P2[3], P3[3];
  recover_at(src, a.axes, s[1], a.bs, cp, P1);
  recover_at(src, a.axes, s[2], a.bs, cp, P2);
  recover_at(src, a.axes, s[3], a.bs, cp, P3);
  for (int c = 0; c < 3; ++c)
    out[c] = T(0.25) * P0[c] + T(0.25) * P1[c] + T(0.25) * P2[c]
           + T(0.25) * P3[c];
}

// min of v over the CTA, returned to every thread
__device__ double block_min(double v) {
  __shared__ double mins[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmin(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) mins[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = mins[0];
  for (int w = 1; w < kThreads / 32; ++w) r = fmin(r, mins[w]);
  return r;
}

// ---- sweep 1's tiles: one CTA a tile ---------------------------------------
//
// A tile's box is the tile and its one-cell ring: box cell (bi, bj) is the
// block's cell (i0 + bi - 1, j0 + bj - 1). A warp takes rows of the box,
// its lanes the columns (Tile<T>::J is the warp's width), so no thread
// divides an index; the ring's four strips go one to a warp.

constexpr int kWarps = kThreads / 32;

struct TileAt {
  int b, i0, j0, ni, nj;
};

__device__ __forceinline__ TileAt tile_at(const int* tiles) {
  const int* t = tiles + blockIdx.x * 5;
  return TileAt{t[0], t[1], t[2], t[3], t[4]};
}

// strip `side` (0 the row above the tile, 1 below, 2 the column left of
// it, 3 right), position q: its box cell, or false past the tile's extent
__device__ __forceinline__ bool ring_cell(const TileAt& t, int side, int q,
                                          int& bi, int& bj) {
  if (side < 2) {
    bi = side == 0 ? 0 : t.ni + 1;
    bj = q + 1;
    return q < t.nj;
  }
  bi = q + 1;
  bj = side == 2 ? 0 : t.nj + 1;
  return q < t.ni;
}

// the block face a cell (i, j) just off the block lies beyond, or -1
__device__ __forceinline__ int face_beyond(int i, int j, int bs) {
  return i < 0 ? 0 : i == bs ? 1 : j < 0 ? 2 : j == bs ? 3 : -1;
}

// A warp's row of nj cells, C values each (the lanes' vals, lane < nj),
// stored to out [cells, C] from the row's first cell `first`: through the
// warp's staging row in shared memory, so each store of the warp is one
// contiguous run of 32 values, not 32 values C apart. All lanes call it.
template <typename T, int C>
__device__ __forceinline__ void store_row(T* out, long long first, int nj,
                                          const T vals[C], T* staging) {
  const int lane = threadIdx.x & 31;
  if (lane < nj)
    for (int c = 0; c < C; ++c) staging[lane * C + c] = vals[c];
  __syncwarp();
  for (int e = lane; e < nj * C; e += 32) out[first * C + e] = staging[e];
  __syncwarp();
}

// recover_at's arithmetic at the cell (b, i, j)
template <typename T>
__device__ __forceinline__ void recover_cell(const Args<T>& a, const T* src,
                                             int b, int i, int j, int cp,
                                             T P[3]) {
  const long long idx = ((long long)b * a.bs + i) * a.bs + j;
  const T s = src[idx * 3];
  if (cp) {
    P[0] = s;
    P[1] = src[idx * 3 + 1] / s;
    P[2] = src[idx * 3 + 2] / s;
    return;
  }
  const T x = T(axis_coord(a.axes, b, a.bs, 0, i));
  const T y = T(axis_coord(a.axes, b, a.bs, 1, j));
  const T sr = src[idx * 3 + 1] / s;
  const T lz = src[idx * 3 + 2] / s;
  const T r2 = x * x + y * y;
  P[0] = s;
  P[1] = (sr * x - lz * y) / r2;
  P[2] = (sr * y + lz * x) / r2;
}

// 1 / v when v is a power of two, else 0. Then x / v and x * (1 / v) are
// one real number, each rounded once, so the product has the quotient's
// bits at a fraction of the division's cost (tools/torch_b3_variants.py
// -slopes). On the flagship's meshes a block's spacing, 2 R / (bs
// 2^level) with R = 12 and bs = 96, is one.
template <typename T>
__device__ __forceinline__ T exact_inverse(T v) {
  int e;
  return frexp(v, &e) == T(0.5) ? T(1) / v : T(0);
}

// ---- sweep 1: recovery and slopes ------------------------------------------

// p and g of src on the tile; with `cfl`, the tile's min of spacing / max
// wavespeed (binary_scheme.maximum_timestep: the min over a block's cells
// of spacing / wavespeed is spacing / the block's max wavespeed, as
// division rounds monotonically)
template <typename T>
__global__ void __launch_bounds__(kThreads, kSweep1Ctas)
b3_sweep1_kernel(Args<T> a, const T* src, int cfl) {
  constexpr int BJ = Tile<T>::J + 2, PS = (Tile<T>::I + 2) * BJ;
  static_assert(Tile<T>::J == 32 && Tile<T>::I <= 32,
                "a tile row is a warp, a ring strip a warp");
  __shared__ T ps[3 * PS];   // the box's primitives [3][I+2][J+2]
  __shared__ T staging[kWarps][6 * 32];
  Params prm = a.prm;
  load_dynamic(prm, a.dyn);
  const TileAt t = tile_at(a.tiles);
  const int bs = a.bs, cp = prm.conserve_p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // each cell recovered once: the tile's into p and the box, the ring's
  // (the next tile's cells, or the guard cells) into the box
  for (int ci = warp; ci < t.ni; ci += kWarps) {
    T P[3];
    if (lane < t.nj) {
      recover_cell(a, src, t.b, t.i0 + ci, t.j0 + lane, cp, P);
      for (int c = 0; c < 3; ++c) ps[c * PS + (ci + 1) * BJ + lane + 1] = P[c];
    }
    store_row<T, 3>(a.p, ((long long)t.b * bs + t.i0 + ci) * bs + t.j0, t.nj,
                    P, staging[warp]);
  }
  int bi, bj;
  if (warp < 4 && ring_cell(t, warp, lane, bi, bj)) {
    const int i = t.i0 + bi - 1, j = t.j0 + bj - 1;
    const int f = face_beyond(i, j, bs);
    T P[3];
    if (f >= 0) ring_recovered(a, src, t.b, f, f < 2 ? j : i, cp, P);
    else recover_cell(a, src, t.b, i, j, cp, P);
    for (int c = 0; c < 3; ++c) ps[c * PS + bi * BJ + bj] = P[c];
  }
  __syncthreads();

  const T theta = T(a.prm.theta);
  const T sp = T(a.spacing[t.b]), inv = exact_inverse(sp);
  double cand = INFINITY;
  for (int ci = warp; ci < t.ni; ci += kWarps) {
    const int i = t.i0 + ci, j = t.j0 + lane;
    const int o = (ci + 1) * BJ + lane + 1;
    T G[6];
    if (lane < t.nj)
      for (int c = 0; c < 3; ++c) {
        const T* q = ps + c * PS;
        const T gx = plm(q[o - BJ], q[o], q[o + BJ], theta);
        const T gy = plm(q[o - 1], q[o], q[o + 1], theta);
        G[c] = inv != T(0) ? gx * inv : gx / sp;
        G[3 + c] = inv != T(0) ? gy * inv : gy / sp;
      }
    store_row<T, 6>(a.g, ((long long)t.b * bs + i) * bs + t.j0, t.nj, G,
                    staging[warp]);
    if (cfl && lane < t.nj) {
      const T x = T(axis_coord(a.axes, t.b, bs, 0, i));
      const T y = T(axis_coord(a.axes, t.b, bs, 1, j));
      const T cs = sqrt(cs2_at(x, y, prm));
      const T w = fmax(fabs(ps[PS + o]) + cs, fabs(ps[2 * PS + o]) + cs);
      cand = fmin(cand, double(T(a.spacing[t.b]) / w));
    }
  }
  if (cfl) {
    const double m = block_min(cand);
    if (threadIdx.x == 0) a.cfl_part[blockIdx.x] = m;
  }
}

// ---- dt: the CFL reduce of sweep 1's tile minima (stage 1) -----------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
b3_dt_kernel(Args<T> a) {
  double m = INFINITY;
  for (int i = threadIdx.x; i < a.n_tiles; i += kThreads)
    m = fmin(m, a.cfl_part[i]);
  m = block_min(m);
  if (threadIdx.x == 0) a.dyn[0] = double(T(a.cfl) * T(m));
}

// ---- sweep 2: faces and update, a persistent march --------------------------
//
// Sweep 2's unit of work is a piece: up to kMarchRows rows of a block's
// strip of 32 columns (j0 = 0, 32, ...; clipped to nj = bs - j0
// columns at the block's edge), in the pieces table (kernels/
// binary_multi.tile_plan). As many CTAs as the card holds at once march
// over the pieces, each claiming its next one as it starts the last.

// piece k of the pieces table (as sweep 1's tiles: a block's rows [i0, i0
// + ni) of its strip at j0, nj wide)
__device__ __forceinline__ TileAt piece_of(const int* pieces, int k) {
  const int* t = pieces + k * 5;
  return TileAt{t[0], t[1], t[2], t[3], t[4]};
}

// The march's shared memory: a piece's box (the piece and its one-cell
// ring, no corners: box cell (bi, bj) is the block's cell (i0 + bi - 1, j0
// + bj - 1)) of p [3][I+2][J+2] and g [6][I+2][J+2]; the piece's x-face
// fluxes [3][I+1][J] and y-face fluxes [3][I][J+1]; the pieces claimed; a
// piece's totals.
template <typename T>
struct MarchSmem {
  static constexpr int I = kMarchRows, J = 32;
  static constexpr int BJ = J + 2, PS = (I + 2) * BJ;
  T p[3 * PS];
  T g[6 * PS];
  T fx[3 * (I + 1) * J];
  T fy[3 * I * (J + 1)];
  int claim[2];            // by the claim's parity
  double piece[kTotals];
};

// one value from device memory into shared memory, asynchronously (no
// register holds it, so every load of a box is in flight at once)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(sizeof(T)) : "memory");
}

// Piece t's box of p and g into shared memory, then this thread's wait for
// its own copies: the piece's cells, a warp a row; the ring, a warp a
// strip: the next cells of the block, or the guard cell's one source cell
// through the ring table where a same or coarser neighbour lies (where
// finer ones do, their faces are recomputed from device memory and the
// guard cell is not read)
template <typename T>
__device__ void load_box(const Args<T>& a, MarchSmem<T>& sm,
                         const TileAt& t) {
  using Sm = MarchSmem<T>;
  constexpr int BJ = Sm::BJ, PS = Sm::PS;
  const int bs = a.bs, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ci = warp; ci < t.ni && lane < t.nj; ci += kWarps) {
    const long long cell = ((long long)t.b * bs + t.i0 + ci) * bs + t.j0
                         + lane;
    const int o = (ci + 1) * BJ + lane + 1;
    for (int c = 0; c < 3; ++c)
      copy_async(&sm.p[c * PS + o], a.p + cell * 3 + c);
    for (int c = 0; c < 6; ++c)
      copy_async(&sm.g[c * PS + o], a.g + cell * 6 + c);
  }
  int bi, bj;
  if (warp < 4 && ring_cell(t, warp, lane, bi, bj)) {
    const int i = t.i0 + bi - 1, j = t.j0 + bj - 1;
    const int f = face_beyond(i, j, bs);
    long long cell = ((long long)t.b * bs + i) * bs + j;
    if (f >= 0) {
      const int* s = ring_cells(a.ring, t.b, f, f < 2 ? j : i, bs);
      cell = s[1] < 0 ? s[0] : -1;
    }
    if (cell >= 0) {
      const int o = bi * BJ + bj;
      for (int c = 0; c < 3; ++c)
        copy_async(&sm.p[c * PS + o], a.p + cell * 3 + c);
      for (int c = 0; c < 6; ++c)
        copy_async(&sm.g[c * PS + o], a.g + cell * 6 + c);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the two sides (primitives and slopes) of face (i, j) along `axis` of
// block b from p and g in device memory, a side off the block from its
// guard cell (face_at's inputs)
template <typename T>
__device__ void face_sides(const Args<T>& a, int b, int axis, int i, int j,
                           T pl[3], T pr[3], T gL[6], T gR[6]) {
  const int bs = a.bs;
  const int k = axis == 0 ? i : j, pos = axis == 0 ? j : i;
  if (k == 0) {
    ring_value<T, 3>(a.p, a.ring, b, 2 * axis, pos, bs, pl);
    ring_value<T, 6>(a.g, a.ring, b, 2 * axis, pos, bs, gL);
  } else {
    const long long cell = axis == 0 ? ((long long)b * bs + (i - 1)) * bs + j
                                     : ((long long)b * bs + i) * bs + (j - 1);
    for (int c = 0; c < 3; ++c) pl[c] = a.p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gL[c] = a.g[cell * 6 + c];
  }
  if (k == bs) {
    ring_value<T, 3>(a.p, a.ring, b, 2 * axis + 1, pos, bs, pr);
    ring_value<T, 6>(a.g, a.ring, b, 2 * axis + 1, pos, bs, gR);
  } else {
    const long long cell = ((long long)b * bs + i) * bs + j;
    for (int c = 0; c < 3; ++c) pr[c] = a.p[cell * 3 + c];
    for (int c = 0; c < 6; ++c) gR[c] = a.g[cell * 6 + c];
  }
}

// The update of src into dst (dst = 0.5 dst + 0.5 update when `average`,
// the rk2 close) on the pieces the CTA claims, with each piece's partial
// totals.
//
// The CTA claims its next piece (work: an atomic count for this launch)
// as it loads the box of the piece before it: so the card's CTAs march the
// mesh in one wave, and a CTA whose pieces cost more (finer neighbours'
// faces read from device memory) claims fewer of them. A piece takes three
// barriers: its box into shared memory (load_box), then every face flux of
// the piece once into shared memory, a warp a row of faces (its ni + 1
// rows of x-faces, its ni rows of y-faces, then the y-faces of its column
// 32 when it is 32 wide: 2 ni + 2 rows, so at kMarchRows = 15 four rounds
// of the 8 warps), then the update of each cell, the new rows staged in
// the slopes' space, which the faces are done with. A block face where two
// finer neighbours meet it takes the sum of their two edge-face fluxes
// (restricted_flux's sum), recomputed here from their p and g: the same
// inputs as the finer block's own, so the same bits, and fx and fy never
// reach device memory. Level jumps lie only on block edges, never on a
// piece's edge inside a block; the finer neighbour's faces are read from
// device memory, so they may straddle the coarse block's pieces. A piece's
// totals go to partials[piece] whichever CTA computed it, so their sum's
// order is fixed.
template <typename T>
__global__ void __launch_bounds__(kThreads, kSweep2Ctas)
b3_sweep2_kernel(Args<T> a, const T* src, T* dst, int average, int launch) {
  using Sm = MarchSmem<T>;
  constexpr int TI = Sm::I, TJ = Sm::J, BJ = Sm::BJ, PS = Sm::PS;
  constexpr int XS = (TI + 1) * TJ, YS = TI * (TJ + 1);
  static_assert(TJ == 32 && TI <= 32,
                "a piece row is a warp, a ring strip a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);
  T* ps = sm.p;
  T* gs = sm.g;
  T* fxs = sm.fx;
  T* fys = sm.fy;

  Params prm = a.prm;
  load_dynamic(prm, a.dyn);
  const int bs = a.bs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* work = a.work + launch;
  if (threadIdx.x == 0) sm.claim[0] = atomicAdd(work, 1);
  __syncthreads();
  for (int k = 0, n = sm.claim[0]; n < a.n_pieces; ++k) {
    const TileAt t = piece_of(a.pieces, n);
    const int b = t.b;
    // the previous piece is done with the box (block_sum's barriers)
    load_box(a, sm, t);
    if (threadIdx.x == 0) sm.claim[(k + 1) & 1] = atomicAdd(work, 1);
    __syncthreads();
    const int next = sm.claim[(k + 1) & 1];

    // every face of the piece once, a warp a row of faces
    const int xrows = t.ni + 1, yrows = t.ni;
    const int rows = xrows + yrows + (t.nj == TJ ? 1 : 0);
    for (int row = warp; row < rows; row += kWarps) {
      int axis, fi, fj;
      if (row < xrows) {
        axis = 0, fi = row, fj = lane;
        if (fj >= t.nj) continue;
      } else if (row < xrows + yrows) {
        axis = 1, fi = row - xrows, fj = lane;
        if (fj > t.nj) continue;
      } else {
        axis = 1, fi = lane, fj = TJ;
        if (fi >= t.ni) continue;
      }
      const int i = t.i0 + fi, j = t.j0 + fj;   // the face's index in the block
      const int kk = axis == 0 ? i : j;
      const int edge = kk == 0 ? 2 * axis : kk == bs ? 2 * axis + 1 : -1;
      const int pos = axis == 0 ? j : i;
      const int* fine = edge < 0 ? nullptr
          : a.fine + (((long long)b * 4 + edge) * bs + pos) * 2;
      const int parts = fine != nullptr && fine[0] >= 0 ? 2 : 1;
      const int lo = axis == 0 ? 0 : 3, tr = axis == 0 ? 3 : 0;
      T F[3];
      for (int h = 0; h < parts; ++h) {
        T pl[3], pr[3], gL[6], gR[6];
        int fb = b, fi_ = i, fj_ = j;
        if (parts == 1) {
          // the cells beside the face in the box: lower (l), upper (r)
          const int ol = axis == 0 ? fi * BJ + fj + 1 : (fi + 1) * BJ + fj;
          const int orr = (fi + 1) * BJ + fj + 1;
          for (int c = 0; c < 3; ++c) {
            pl[c] = ps[c * PS + ol];
            pr[c] = ps[c * PS + orr];
          }
          for (int c = 0; c < 6; ++c) {
            gL[c] = gs[c * PS + ol];
            gR[c] = gs[c * PS + orr];
          }
        } else {
          // one of the finer neighbour's two faces on this one, flat in
          // its block's x-faces [bs+1, bs] or y-faces [bs, bs+1]
          const int id = fine[h];
          const int per = (bs + 1) * bs, w = axis == 0 ? bs : bs + 1;
          fb = id / per;
          fi_ = (id % per) / w;
          fj_ = (id % per) % w;
          face_sides(a, fb, axis, fi_, fj_, pl, pr, gL, gR);
        }
        const T x = T(axis_coord(a.axes, fb, bs, axis == 0 ? 2 : 4, fi_));
        const T y = T(axis_coord(a.axes, fb, bs, axis == 0 ? 3 : 5, fj_));
        T f[3];
        face_flux(axis, pl, pr, gL + lo, gR + lo, gL + tr, gR + tr, x, y,
                  T(a.spacing[fb]), prm, f);
        for (int c = 0; c < 3; ++c) F[c] = h == 0 ? f[c] : F[c] + f[c];
      }
      if (axis == 0)
        for (int c = 0; c < 3; ++c) fxs[c * XS + fi * TJ + fj] = F[c];
      else
        for (int c = 0; c < 3; ++c) fys[c * YS + fi * (TJ + 1) + fj] = F[c];
    }
    __syncthreads();

    // the update of each cell of the piece (update_at with these fluxes),
    // the new rows staged in the slopes' space, which the faces are done
    // with
    double sum[kTotals];
    for (int s = 0; s < kTotals; ++s) sum[s] = 0.0;
    const T dA = T(a.spacing[b] * a.spacing[b]);
    for (int ci = warp; ci < t.ni; ci += kWarps) {
      const int cj = lane, i = t.i0 + ci, j = t.j0 + cj;
      const long long idx = ((long long)b * bs + i) * bs + j;
      T V[3];
      if (cj < t.nj) {
        T U[3], P[3], in[3], div[3];
        for (int c = 0; c < 3; ++c) {
          const T xl = fxs[c * XS + ci * TJ + cj];
          const T xr = fxs[c * XS + (ci + 1) * TJ + cj];
          const T yl = fys[c * YS + ci * (TJ + 1) + cj];
          const T yr = fys[c * YS + ci * (TJ + 1) + cj + 1];
          div[c] = (xr - xl) + (yr - yl);
          U[c] = src[idx * 3 + c];
          P[c] = ps[c * PS + (ci + 1) * BJ + cj + 1];
          in[c] = a.init[idx * 3 + c];
        }
        const T x = T(axis_coord(a.axes, b, bs, 0, i));
        const T y = T(axis_coord(a.axes, b, bs, 1, j));
        double acc[kTotals];
        update_cell<T>(U, P, in, a.br[idx], div, x, y, dA, prm, V, acc);
        if (average)
          for (int c = 0; c < 3; ++c)
            V[c] = T(0.5) * dst[idx * 3 + c] + T(0.5) * V[c];
        for (int s = 0; s < kTotals; ++s) sum[s] += acc[s];
      }
      store_row<T, 3>(dst, idx - cj, t.nj, V, gs + warp * 3 * 32);
    }
    block_sum(sum, sm.piece);
    if (threadIdx.x < kTotals)
      a.partials[(long long)threadIdx.x * a.n_pieces + n] =
          sm.piece[threadIdx.x];
    n = next;
  }
}

// ---- the scalar kernels ----------------------------------------------------

template <typename T>
__device__ void publish_bodies(const Args<T>& a, T body[2][5]) {
  for (int k = 0; k < 2; ++k)
    for (int c = 0; c < 5; ++c) a.dyn[2 + 5 * k + c] = double(body[k][c]);
}

template <typename T>
__device__ void carry_store(const Args<T>& a, int at, const T* values,
                            int n) {
  for (int j = 0; j < n; ++j) a.carry[at + j] = double(values[j]);
}

template <typename T>
__device__ void carry_load(const Args<T>& a, int at, T* values, int n) {
  for (int j = 0; j < n; ++j) values[j] = T(a.carry[at + j]);
}

// one stage's row: the totals, dt, the fault flag and the stage-start time
template <typename T>
__device__ double* write_row(const Args<T>& a, int r, const double* tot,
                             T dt, T t) {
  double* row = a.rows + (long long)r * kRows * kLanes;
  for (int q = 0; q < 8; ++q)
    for (int k = 0; k < 2; ++k) row[q * kLanes + k] = tot[2 * q + k];
  row[kRowEjected * kLanes] = tot[kMassEjected];
  row[kRowEjected * kLanes + 1] = tot[kAngmomEjected];
  row[kRowDt * kLanes] = double(dt);
  row[kRowInvalid * kLanes] = tot[kFaults] > 0.0 ? 1.0 : 0.0;
  row[kRowTprev * kLanes] = double(t);
  return row;
}

template <typename T>
__device__ void write_elements(double* row, int r, const T* values) {
  for (int j = 0; j < 10; ++j) row[r * kLanes + j] = double(values[j]);
}

// the first stage's bodies and theta (and a fixed dt) into dyn; t0 and the
// elements into the carry; no piece of sweep 2 claimed yet
template <typename T>
__global__ void b3_init_kernel(Args<T> a) {
  for (int k = 0; k < a.k_steps * a.rk; ++k) a.work[k] = 0;
  T t = T(a.start[0]), E[10], body[2][5];
  for (int j = 0; j < 10; ++j) E[j] = T(a.start[1 + j]);
  kepler_bodies(E, t, body);
  publish_bodies(a, body);
  a.dyn[1] = a.prm.theta;
  if (a.fixed) a.dyn[0] = double(T(a.fixed_dt));
  carry_store(a, kCarryT, &t, 1);
  carry_store(a, kCarryE, E, 10);
}

// the stage's totals from sweep 2's partials, then (one thread) the work
// done, the row of stage `stage` (1 or 2) of step k, the elements and the
// next stage's bodies
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
b3_stage_end_kernel(Args<T> a, int k, int stage) {
  // every thread sums its CTAs' partials (k, k + kThreads, ...), then
  // block_sum: a fixed order; negated, as the plain version's totals are,
  // but for the fault count
  double acc[kTotals];
  for (int q = 0; q < kTotals; ++q) acc[q] = 0.0;
  for (int k = threadIdx.x; k < a.n_pieces; k += kThreads)
    for (int q = 0; q < kTotals; ++q)
      acc[q] += a.partials[(long long)q * a.n_pieces + k];
  __shared__ double sums[kTotals];
  block_sum(acc, sums);
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int q = 0; q < kTotals; ++q)
    a.totals[q] = q == kFaults ? sums[q] : -sums[q];
  const double* tot = a.totals;
  const T dt = T(a.dyn[0]);
  T t, E[10], E1[10], body[2][5], da[10], dg[10];
  carry_load(a, kCarryT, &t, 1);
  carry_load(a, kCarryE, E, 10);
  for (int q = 0; q < 2; ++q)
    for (int c = 0; c < 5; ++c) body[q][c] = T(a.dyn[2 + 5 * q + c]);
  work_done<T>(a.totals, body);
  if (stage == 1) {
    double* row = write_row(a, k * a.rk, tot, dt, t);
    evolve(a, E, tot, body, t, dt, E1, da, dg);
    write_elements(row, kRowDacc, da);
    write_elements(row, kRowDgrv, dg);
    write_elements(row, kRowOeStage, E);
    if (a.rk == 1) {
      write_elements(row, kRowOe, E1);
      t = t + dt;
      for (int j = 0; j < 10; ++j) E[j] = E1[j];
      kepler_bodies(E, t, body);
    } else {
      const T t2 = t + dt;
      kepler_bodies(E1, t2, body);
      carry_store(a, kCarryT2, &t2, 1);
      carry_store(a, kCarryE1, E1, 10);
    }
  } else {
    // stage 2: from stage 1's state at t + dt, then the average
    T t2, E2[10];
    carry_load(a, kCarryT2, &t2, 1);
    carry_load(a, kCarryE1, E1, 10);
    double* row = write_row(a, 2 * k + 1, tot, dt, t2);
    evolve(a, E1, tot, body, t2, dt, E2, da, dg);
    for (int j = 0; j < 10; ++j) E2[j] = T(0.5) * E[j] + T(0.5) * E2[j];
    write_elements(row, kRowDacc, da);
    write_elements(row, kRowDgrv, dg);
    write_elements(row, kRowOe, E2);
    write_elements(row, kRowOeStage, E1);
    for (int j = 0; j < 10; ++j) E[j] = E2[j];
    // the time takes the state's 1/2-1/2 average, bit for bit
    t = T(0.5) * t + T(0.5) * (t2 + dt);
    kepler_bodies(E, t, body);
  }
  publish_bodies(a, body);
  carry_store(a, kCarryT, &t, 1);
  carry_store(a, kCarryE, E, 10);
}

// ---- the launches ----------------------------------------------------------

template <typename T>
cudaError_t allow_sweep2_smem() {
  return cudaFuncSetAttribute(b3_sweep2_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(MarchSmem<T>));
}

template <typename T>
int advance_k(const Args<T>& a, int ti, int tj, cudaStream_t stream) {
  if (ti != Tile<T>::I || tj != Tile<T>::J || a.n_tiles < 1
      || a.n_pieces < 1 || a.n_ctas < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_sweep2_smem<T>();
  if (err != cudaSuccess) return err;
  const int tiles = a.n_tiles, ctas = a.n_ctas;
  const int smem = (int)sizeof(MarchSmem<T>);
  T* after1 = a.rk == 1 ? a.u : a.s1;
#define B3_CHECK()                                 \
  do {                                             \
    err = cudaGetLastError();                      \
    if (err != cudaSuccess) return err;            \
  } while (0)
  b3_init_kernel<T><<<1, 1, 0, stream>>>(a);
  B3_CHECK();
  for (int k = 0; k < a.k_steps; ++k) {
    // stage 1: from the step's state (and dt)
    b3_sweep1_kernel<T><<<tiles, kThreads, 0, stream>>>(a, a.u, !a.fixed);
    B3_CHECK();
    if (!a.fixed) {
      b3_dt_kernel<T><<<1, kThreads, 0, stream>>>(a);
      B3_CHECK();
    }
    b3_sweep2_kernel<T><<<ctas, kThreads, smem, stream>>>(a, a.u, after1, 0,
                                                         k * a.rk);
    B3_CHECK();
    b3_stage_end_kernel<T><<<1, kThreads, 0, stream>>>(a, k, 1);
    B3_CHECK();
    if (a.rk == 1) continue;
    // stage 2: from stage 1's state at t + dt, then the average
    b3_sweep1_kernel<T><<<tiles, kThreads, 0, stream>>>(a, a.s1, 0);
    B3_CHECK();
    b3_sweep2_kernel<T><<<ctas, kThreads, smem, stream>>>(a, a.s1, a.u, 1,
                                                         2 * k + 1);
    B3_CHECK();
    b3_stage_end_kernel<T><<<1, kThreads, 0, stream>>>(a, k, 2);
    B3_CHECK();
  }
#undef B3_CHECK
  return cudaSuccess;
}

// the kernels in the order of b3_kernel_info's `which`
template <typename T>
const void* kernel_at(int which) {
  switch (which) {
    case 0: return (const void*)b3_sweep1_kernel<T>;
    case 1: return (const void*)b3_sweep2_kernel<T>;
    case 2: return (const void*)b3_dt_kernel<T>;
    case 3: return (const void*)b3_stage_end_kernel<T>;
    case 4: return (const void*)b3_init_kernel<T>;
    default: return nullptr;
  }
}

// out: registers a thread, local memory a thread (bytes: the stack frame
// and spills), static and dynamic shared memory a CTA (bytes), threads a
// CTA, CTAs an SM
template <typename T>
int kernel_info(int which, int* out) {
  const void* fn = kernel_at<T>(which);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_sweep2_smem<T>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  const int threads = which == 4 ? 1 : kThreads;
  const int dynamic = which == 1 ? (int)sizeof(MarchSmem<T>) : 0;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      dynamic);
  if (err != cudaSuccess) return err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = dynamic;
  out[4] = threads;
  out[5] = per_sm;
  return cudaSuccess;
}

template <typename T>
int launch(T* u, T* s1, T* p, T* g, const T* init, const T* br,
           const double* axes, const double* spacing, const int* tiles,
           const int* ring, const int* fine, const int* pieces, int* work,
           double* partials, double* totals, double* cfl_part,
           const double* start, double* dyn, double* carry, double* rows,
           int B, int bs, int n_tiles, int n_pieces, int n_ctas, int ti,
           int tj, int k_steps, int rk, int options, int fixed,
           const double* hparams, int flags, const double* mparams,
           void* stream) {
  const Args<T> a{u, s1, p, g, init, br, axes, spacing, tiles, ring, fine,
                  pieces, work, partials, totals, cfl_part, start, dyn,
                  carry, rows, B, bs, n_tiles, n_pieces, n_ctas, k_steps, rk,
                  options & 1, fixed, mparams[0], mparams[1], mparams[2],
                  read_params(hparams, flags)};
  return advance_k<T>(a, ti, tj, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int b3_kernel_info(int f64, int which, int* out) {
  return f64 ? kernel_info<double>(which, out)
             : kernel_info<float>(which, out);
}

const char* b3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// options: bit 0 no_accretion_force; mparams: cfl, fixed dt,
// begin_live_binary; (ti, tj) must be the type's Tile; pieces: sweep 2's
// n_pieces pieces (kernels/binary_multi.tile_plan), which n_ctas CTAs
// claim; work: k_steps * rk counters
int b3_advance_k_f32(float* u, float* s1, float* p, float* g,
                     const float* init, const float* br, const double* axes,
                     const double* spacing, const int* tiles,
                     const int* ring, const int* fine, const int* pieces,
                     int* work, double* partials, double* totals,
                     double* cfl_part, const double* start, double* dyn,
                     double* carry, double* rows, int B, int bs,
                     int n_tiles, int n_pieces, int n_ctas, int ti, int tj,
                     int k_steps, int rk, int options, int fixed,
                     const double* hparams, int flags,
                     const double* mparams, void* stream) {
  return launch<float>(u, s1, p, g, init, br, axes, spacing, tiles, ring,
                       fine, pieces, work, partials, totals, cfl_part, start,
                       dyn, carry, rows, B, bs, n_tiles, n_pieces, n_ctas,
                       ti, tj, k_steps, rk, options, fixed, hparams, flags,
                       mparams, stream);
}

int b3_advance_k_f64(double* u, double* s1, double* p, double* g,
                     const double* init, const double* br,
                     const double* axes, const double* spacing,
                     const int* tiles, const int* ring, const int* fine,
                     const int* pieces, int* work, double* partials,
                     double* totals, double* cfl_part, const double* start,
                     double* dyn, double* carry, double* rows, int B, int bs,
                     int n_tiles, int n_pieces, int n_ctas, int ti, int tj,
                     int k_steps, int rk, int options, int fixed,
                     const double* hparams, int flags,
                     const double* mparams, void* stream) {
  return launch<double>(u, s1, p, g, init, br, axes, spacing, tiles, ring,
                        fine, pieces, work, partials, totals, cfl_part,
                        start, dyn, carry, rows, B, bs, n_tiles, n_pieces,
                        n_ctas, ti, tj, k_steps, rk, options, fixed, hparams,
                        flags, mparams, stream);
}

}  // extern "C"
