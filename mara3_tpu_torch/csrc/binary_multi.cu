// Kernel B3: K complete steps of the flagship circumbinary-disk scheme in
// one launch, on the whole quadtree mesh.
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
// Design: one cooperative persistent kernel (cudaLaunchCooperativeKernel)
// whose grid is every CTA that fits on the card at once; CTAs stride over
// cells and faces, and grid-wide barriers separate the phases of a stage
// (recovery + CFL -> slopes -> faces -> update -> totals -> the scalar
// section). The totals' fixed-order sums run one to a CTA; the scalar work
// (the row, the work done, the elements, dt and the next stage's bodies)
// runs in one
// thread of CTA 0, which publishes dt and the bodies to the other CTAs
// through a small device buffer. So the K steps cost one launch and no
// host work between steps.
//
// Bound: per stage the mesh is read and written a few times (the state,
// the primitives, the slopes and the face fluxes, about 50 values per
// cell); only the state, initial_conserved and buffer_rate must come from
// device memory and the state go back, once per launch, so over K steps
// the kernel is bound by its arithmetic (several hundred flops per cell
// per stage, including the sqrt, exp, pow and tanh of the face and source
// terms). This first version keeps B2's one-thread-per-cell code and its
// passes through device memory (mostly L2-resident at d6b96); fusing the
// passes into shared-memory tiles is later work.
//
// Deterministic like B2: the totals are per-tile float64 partials (a tile
// is B2's CTA of kThreads cells, so the sums equal B2's bit for bit), each
// summed in a fixed order by one CTA; the CFL reduce is a min, whose order
// does not matter. No atomics. Built with --fmad=false like B2.

#include <cooperative_groups.h>

#include "binary_advance_core.cuh"

namespace cg = cooperative_groups;

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

template <typename T>
struct MultiArgs {
  T* u;                 // [B, bs, bs, 3] the state, advanced in place
  T* s1;                // [B, bs, bs, 3] the rk2 stage state
  T* p;                 // [B, bs, bs, 3] primitives
  T* g;                 // [B, bs, bs, 6] slopes
  T* fx;                // [B, bs+1, bs, 3]
  T* fy;                // [B, bs, bs+1, 3]
  const T* init;        // [B, bs, bs, 3]
  const T* br;          // [B, bs, bs]
  const int* tab;       // [B, 4, 6]
  const double* axes;   // [B, 6, bs+1]
  const double* spacing;  // [B]
  double* partials;     // [tiles, kTotals]
  double* totals;       // [kTotals] the stage's totals
  double* cfl_part;     // [tiles]
  const double* start;  // t0, then the ten elements
  double* dyn;          // [kDynamic]: dt, theta, bodies of the stage
  double* rows;         // [k_steps * rk, kRows, kLanes]
  int B, bs, k_steps, rk, no_acc_force, fixed;
  double cfl, fixed_dt, live_after;
  Params prm;
};

// ---- two-body scalar code (models/two_body_device.py, one thread) ----------

template <typename T>
__device__ T orbital_period(const T* e) {
  return T(kTwoPi) / sqrt(e[kM] / (e[kA] * e[kA] * e[kA]));
}

// bodies (mass, x, y, vx, vy) at time t (compute_two_body_state)
template <typename T>
__device__ void kepler_bodies(const T* e, T t, T body[2][5]) {
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
__device__ void orbital_elements(const T b1[5], const T b2[5], T t,
                                 T out[10]) {
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
__device__ void element_diff(const T* a, const T* b, T d[10]) {
  for (int j = 0; j < 10; ++j) d[j] = b[j] - a[j];
  d[kPomega] = wrap(d[kPomega], T(kTwoPi));
  d[kTau] = wrap(d[kTau], orbital_period(b));
}

// One stage's element update (two_body_device.perturbations, then
// E + (d_acc + d_grv + d_cm) * live, live once t > begin_live_binary):
// E_next, d_acc, d_grv.
template <typename T>
__device__ void evolve(const MultiArgs<T>& a, const T* E, const double* tot,
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

// ---- grid phases -----------------------------------------------------------

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

template <typename T>
__device__ Params stage_params(const MultiArgs<T>& a) {
  Params prm = a.prm;
  load_dynamic(prm, a.dyn);
  return prm;
}

// primitives of src into p; with `cfl`, each tile's min of spacing / max
// wavespeed (binary_scheme.maximum_timestep: the min over a block's cells
// of spacing / wavespeed is spacing / the block's max wavespeed, as
// division rounds monotonically)
template <typename T>
__device__ void phase_recover(const MultiArgs<T>& a, const T* src, bool cfl) {
  const Params prm = stage_params(a);
  const long long n = (long long)a.B * a.bs * a.bs;
  const int tiles = (int)((n + kThreads - 1) / kThreads);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long idx = (long long)tile * kThreads + threadIdx.x;
    double cand = INFINITY;
    if (idx < n) {
      T P[3];
      recover_at(src, a.axes, idx, a.bs, prm.conserve_p, P);
      for (int c = 0; c < 3; ++c) a.p[idx * 3 + c] = P[c];
      if (cfl) {
        const int j = idx % a.bs;
        const int i = (idx / a.bs) % a.bs;
        const int b = idx / ((long long)a.bs * a.bs);
        const T x = T(axis_coord(a.axes, b, a.bs, 0, i));
        const T y = T(axis_coord(a.axes, b, a.bs, 1, j));
        const T cs = sqrt(cs2_at(x, y, prm));
        const T w = fmax(fabs(P[1]) + cs, fabs(P[2]) + cs);
        cand = double(T(a.spacing[b]) / w);
      }
    }
    if (cfl) {
      const double m = block_min(cand);
      if (threadIdx.x == 0) a.cfl_part[tile] = m;
    }
  }
}

template <typename T>
__device__ void phase_slopes(const MultiArgs<T>& a) {
  const long long n = (long long)a.B * a.bs * a.bs;
  const T theta = T(a.prm.theta);
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * kThreads)
    slopes_at(a.p, GatherGuard<T>{a.p, a.tab}, a.spacing, a.g, idx, a.bs,
              theta);
}

template <typename T>
__device__ void phase_faces(const MultiArgs<T>& a) {
  Params prm = a.prm;
  for (int k = 0; k < 2; ++k)      // the bodies only: dt may be in flight
    for (int c = 0; c < 5; ++c) prm.body[k][c] = a.dyn[2 + 5 * k + c];
  const long long nf = 2LL * a.B * (a.bs + 1) * a.bs;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < nf; idx += (long long)gridDim.x * kThreads)
    face_at(a.p, GatherGuard<T>{a.p, a.tab}, a.g, a.tab, a.axes, a.spacing,
            a.fx, a.fy, idx, a.B, a.bs, prm);
}

// the update of src into dst (dst = 0.5 dst + 0.5 update when `average`,
// the rk2 close), with each tile's partial totals
template <typename T>
__device__ void phase_update(const MultiArgs<T>& a, const T* src, T* dst,
                             bool average) {
  const Params prm = stage_params(a);
  const long long n = (long long)a.B * a.bs * a.bs;
  const int tiles = (int)((n + kThreads - 1) / kThreads);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long idx = (long long)tile * kThreads + threadIdx.x;
    double acc[kTotals];
    for (int t = 0; t < kTotals; ++t) acc[t] = 0.0;
    if (idx < n) {
      T V[3];
      update_at(src, a.p, a.init, a.br, a.fx, a.fy, a.tab, a.axes, a.spacing,
                idx, a.bs, prm, V, acc);
      for (int c = 0; c < 3; ++c)
        dst[idx * 3 + c] = average ? T(0.5) * dst[idx * 3 + c] + T(0.5) * V[c]
                                   : V[c];
    }
    block_sum(acc, a.partials + (long long)tile * kTotals);
  }
}

// the stage's totals from the tiles' partials: CTA t sums total t
template <typename T>
__device__ void phase_totals(const MultiArgs<T>& a, int tiles) {
  for (int t = blockIdx.x; t < kTotals; t += gridDim.x) {
    const double v = sum_total(a.partials, tiles, t);
    if (threadIdx.x == 0) a.totals[t] = v;
  }
}

// ---- the scalar section (thread 0 of CTA 0) --------------------------------

template <typename T>
__device__ void publish_bodies(const MultiArgs<T>& a, T body[2][5]) {
  for (int k = 0; k < 2; ++k)
    for (int c = 0; c < 5; ++c) a.dyn[2 + 5 * k + c] = double(body[k][c]);
}

// one stage's row: the totals, dt, the fault flag and the stage-start time
template <typename T>
__device__ double* write_row(const MultiArgs<T>& a, int r, const double* tot,
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
multi_kernel(MultiArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const bool leader = blockIdx.x == 0;
  const bool scalar = leader && threadIdx.x == 0;
  const double* tot = a.totals;
  const long long n = (long long)a.B * a.bs * a.bs;
  const int tiles = (int)((n + kThreads - 1) / kThreads);
  T* after1 = a.rk == 1 ? a.u : a.s1;

  // the scalar state, kept by thread 0 of CTA 0
  T t = T(0), dt = T(0), t2 = T(0);
  T E[10], E1[10], body[2][5];
  if (scalar) {
    t = T(a.start[0]);
    for (int j = 0; j < 10; ++j) E[j] = T(a.start[1 + j]);
    kepler_bodies(E, t, body);
    publish_bodies(a, body);
    a.dyn[1] = a.prm.theta;
  }
  grid.sync();

  for (int k = 0; k < a.k_steps; ++k) {
    // ---- stage 1: from the step's state (and dt) ----
    phase_recover(a, a.u, !a.fixed);
    grid.sync();
    if (leader) {
      double m = INFINITY;
      if (!a.fixed)
        for (int i = threadIdx.x; i < tiles; i += kThreads)
          m = fmin(m, a.cfl_part[i]);
      m = block_min(m);
      if (scalar) {
        dt = a.fixed ? T(a.fixed_dt) : T(a.cfl) * T(m);
        a.dyn[0] = double(dt);
      }
    }
    phase_slopes(a);
    grid.sync();
    phase_faces(a);
    grid.sync();
    phase_update(a, a.u, after1, false);
    grid.sync();
    phase_totals(a, tiles);
    grid.sync();
    if (scalar) {
      work_done<T>(a.totals, body);
      double* row = write_row(a, k * a.rk, tot, dt, t);
      T da[10], dg[10];
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
        t2 = t + dt;
        kepler_bodies(E1, t2, body);
      }
      publish_bodies(a, body);
    }
    grid.sync();
    if (a.rk == 1) continue;

    // ---- stage 2: from stage 1's state at t + dt, then the average ----
    phase_recover(a, a.s1, false);
    grid.sync();
    phase_slopes(a);
    grid.sync();
    phase_faces(a);
    grid.sync();
    phase_update(a, a.s1, a.u, true);
    grid.sync();
    phase_totals(a, tiles);
    grid.sync();
    if (scalar) {
      work_done<T>(a.totals, body);
      double* row = write_row(a, 2 * k + 1, tot, dt, t2);
      T E2[10], da[10], dg[10];
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
      publish_bodies(a, body);
    }
    grid.sync();
  }
}

// CTAs of the cooperative grid: all that fit on the card at once
template <typename T>
cudaError_t grid_for(int* ctas) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, multi_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas = per_sm * sms;
  return cudaSuccess;
}

int num_tiles(int B, int bs) {
  return (int)(((long long)B * bs * bs + kThreads - 1) / kThreads);
}

template <typename T>
int advance_k(T* u, T* s1, T* p, T* g, T* fx, T* fy, const T* init,
              const T* br, const int* tab, const double* axes,
              const double* spacing, double* partials, double* totals,
              double* cfl_part, const double* start, double* dyn,
              double* rows, int B, int bs, int k_steps, int rk, int options,
              int fixed, const double* hparams, int flags,
              const double* mparams, cudaStream_t stream) {
  int ctas = 0;
  cudaError_t err = grid_for<T>(&ctas);
  if (err != cudaSuccess) return err;
  const int tiles = num_tiles(B, bs);
  if (ctas > tiles) ctas = tiles;
  MultiArgs<T> a{u, s1, p, g, fx, fy, init, br, tab, axes, spacing,
                 partials, totals, cfl_part, start, dyn, rows, B, bs,
                 k_steps, rk, options & 1, fixed, mparams[0],
                 mparams[1], mparams[2], read_params(hparams, flags)};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)multi_kernel<T>, dim3(ctas),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b3_num_tiles(int B, int bs) { return num_tiles(B, bs); }

// the cooperative grid's CTA count, or minus the error code
int b3_grid_size(int f64) {
  int ctas = 0;
  const cudaError_t err = f64 ? grid_for<double>(&ctas)
                              : grid_for<float>(&ctas);
  return err == cudaSuccess ? ctas : -(int)err;
}

const char* b3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// options: bit 0 no_accretion_force; mparams: cfl, fixed dt,
// begin_live_binary
int b3_advance_k_f32(float* u, float* s1, float* p, float* g, float* fx,
                     float* fy, const float* init, const float* br,
                     const int* tab, const double* axes,
                     const double* spacing, double* partials,
                     double* totals, double* cfl_part, const double* start,
                     double* dyn,
                     double* rows, int B, int bs, int k_steps, int rk,
                     int options, int fixed, const double* hparams,
                     int flags, const double* mparams, void* stream) {
  return advance_k<float>(u, s1, p, g, fx, fy, init, br, tab, axes, spacing,
                          partials, totals, cfl_part, start, dyn, rows, B,
                          bs,
                          k_steps, rk, options, fixed, hparams, flags,
                          mparams, static_cast<cudaStream_t>(stream));
}

int b3_advance_k_f64(double* u, double* s1, double* p, double* g,
                     double* fx, double* fy, const double* init,
                     const double* br, const int* tab, const double* axes,
                     const double* spacing, double* partials,
                     double* totals, double* cfl_part, const double* start,
                     double* dyn,
                     double* rows, int B, int bs, int k_steps, int rk,
                     int options, int fixed, const double* hparams,
                     int flags, const double* mparams, void* stream) {
  return advance_k<double>(u, s1, p, g, fx, fy, init, br, tab, axes,
                           spacing, partials, totals, cfl_part, start, dyn,
                           rows, B, bs, k_steps, rk, options, fixed, hparams, flags,
                           mparams, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
