// Kernel B12: n forward-Euler steps of blast3d's first-order HLLE scheme for
// the gamma-law Euler equations on the 2:1-balanced octree, on the conserved
// state U [B, bs, bs, bs, 5] (x, y, z, then the five components; blocks in
// the tree's Morton order).
//
// It replaces no TPU kernel: the JAX package runs this step as jnp
// operations (mara3_tpu/mesh/euler3d.py has no Pallas kernel). It was added
// because the port ran the step as about 800 small torch kernels, enqueued
// one by one by the host (10-14 ms a step at depth 4, block 16, against
// 5.7 ms of device time), so the host paced the run.
//
// It computes what kernels/euler3d_step.py's advance_n_plain computes,
// operation for operation. Per step:
//   - each cell's primitives (rho, v, p) from U (physics/euler.py's
//     recover_primitive);
//   - per axis, the HLLE flux at every face (riemann_hlle, with the axis's
//     unit normal multiplied out as the plain version does: 1 v1 + 0 v2 + 0
//     v3, p 0 on the tangential momenta). A face on a block's boundary
//     takes its outer state through the face's case (mesh/amr3d.py):
//       SAME: the neighbour's face cell;
//       COARSE: the coarse neighbour's cell (tq1 bs/2 + t1/2, tq2 bs/2 +
//         t2/2), piecewise-constant prolongation;
//       FINE: no guard. The face's flux is the one amr3d.correct_fluxes
//         writes there: the 2 x 2 mean of the HLLE fluxes between this cell
//         and each fine face cell (the fine block on the side it lies on),
//         ((a00 + a01) + (a10 + a11)) / 4 in _assemble_quarters' quarter
//         order. The plain version's mean-restricted guard feeds only the
//         flux that correction overwrites, so it is not formed;
//   - dU = ((dFx + 0) + dFy) + dFz, and U - (dt inv_dx) dU.
//
// Bounds at depth 4, block 16 (344 blocks, 1,409,024 cells), float32: the
// work model (torch_bench/work/blast3d.json) counts 332 operations a
// zone-update, 4.68e8 a step, 6.98 us at 67e12 a second; with --fmad=false
// no product and sum fuse, so the card's rate for them is half that peak
// (14 us), and a cell's six divisions and square root and a face's five
// divisions are about ten instructions each. A launch-a-step design reads
// the state and writes it once a step: 56.4 MB, 16.8 us at 3.35 TB/s (the
// state and its ping-pong copy, 2 x 28.2 MB, do not both fit in the 50 MB
// L2). Measured on an H100 (700 W): 101.8 us a step in float32, 207.5 in
// float64; the divisions, the NaN tests of the maximum and minimum and the
// barriers leave it latency-bound, so occupancy decided the tile.
// What the design does:
//   - a CTA of 256 threads owns a tile of up to 2 x 16 x 16 cells (x, y, z)
//     of one block, two cells a thread. Each cell of the tile and of its six
//     face halos (1,296 slots) is recovered once into shared memory, with
//     its energy density and sound speed, which every face reads (so the
//     HLLE forms neither): each cell's U is read from device memory once a
//     step, its halo copies from L2;
//   - per axis the CTA computes each face's flux once into shared memory,
//     then each thread adds its cells' flux differences into dU, held in
//     registers across the three axes. A face on a FINE face of the block
//     is four lanes, one fine HLLE each, summed by warp shuffles in the
//     plain version's order, so that the level jumps' extra work (four
//     recoveries from L2 and four HLLEs a face) is spread over the CTA;
//   - 51.6 KB of shared memory a CTA in float32 (103.3 KB in float64): four
//     CTAs an SM in float32 at 64 registers (two in float64), 344 x 8 CTAs
//     at d4b16. A tile of 4 x-planes halves the recomputed x faces at the
//     tile's ends but fits two CTAs an SM: 153 against 117 us a step,
//     measured before the FINE faces were spread over lanes;
//   - one launch a step; a C loop issues all n on the caller's stream,
//     ping-ponging the state between the output and a scratch buffer.
// Any B and any even bs: a tile is cut at the block's edge.
//
// Built with --fmad=false: every product and sum rounds as in the plain
// version (PyTorch's elementwise kernels round each operation once; the
// divisions and square roots are IEEE-rounded in both), and the maximum,
// minimum and clamps propagate NaN as PyTorch's do, so the two agree bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 2, kTY = 16, kTZ = 16;      // a tile's cells
constexpr int kThreads = 256;
// CTAs an SM, for the registers: float32 4 (64 registers), float64 2; three
// in float32 (76 registers) took 110.5 us a step against 101.8
template <typename T>
constexpr int kMinCtas = sizeof(T) == 4 ? 4 : 2;
constexpr int kCells = kTX * kTY * kTZ;
constexpr int kPerThread = kCells / kThreads;
constexpr int kPY = kTY + 2, kPZ = kTZ + 2;     // with a halo cell a side
constexpr int kPSlots = (kTX + 2) * kPY * kPZ;
constexpr int kFSlots = (kTX + 1) * kTY * kTZ;  // the most faces of an axis
constexpr int kSame = 0, kCoarse = 1;           // mesh/amr3d.py; 2 is FINE
static_assert(kCells % kThreads == 0 && kThreads % 32 == 0,
              "whole cells a thread, whole warps a CTA");

// a cell's primitives, with the two functions of them that every face
// reads, formed once a cell: the energy density (to_conserved_density's
// last component) and the sound speed (wavespeeds' cs)
template <typename T>
struct Cell {
  T d, v1, v2, v3, p, e, cs;
};
constexpr int kFields = 7;

template <typename T>
__device__ __forceinline__ T torch_max(T a, T b) {   // torch.maximum
  return a != a ? a : (b != b ? b : ::max(a, b));
}

template <typename T>
__device__ __forceinline__ T torch_min(T a, T b) {   // torch.minimum
  return a != a ? a : (b != b ? b : ::min(a, b));
}

// physics/euler.py recover_primitive of U at u[0..4], then the energy
// density and the sound speed
template <typename T>
__device__ __forceinline__ Cell<T> cell_of(const T* __restrict__ u, T g,
                                           T gm1) {
  const T d = u[0], m1 = u[1], m2 = u[2], m3 = u[3], E = u[4];
  const T psq = (m1 * m1 + m2 * m2) + m3 * m3;
  const T v1 = m1 / d, v2 = m2 / d, v3 = m3 / d;
  const T p = (E - (T(0.5) * psq) / d) * gm1;
  return {d, v1, v2, v3, p,
          (T(0.5) * d) * ((v1 * v1 + v2 * v2) + v3 * v3) + p / gm1,
          sqrt((g * p) / d)};
}

// physics/euler.py riemann_hlle along axis A (nhat the axis's unit vector)
template <typename T, int A>
__device__ __forceinline__ void hlle(const Cell<T>& l, const Cell<T>& r,
                                     T f[5]) {
  const T n1 = A == 0 ? T(1) : T(0);
  const T n2 = A == 1 ? T(1) : T(0);
  const T n3 = A == 2 ? T(1) : T(0);
  const T vl = (n1 * l.v1 + n2 * l.v2) + n3 * l.v3;
  const T vr = (n1 * r.v1 + n2 * r.v2) + n3 * r.v3;
  const T alm = vl - l.cs, alp = vl + l.cs;
  const T arm = vr - r.cs, arp = vr + r.cs;
  T ap = torch_max(alp, arp);
  ap = ap != ap ? ap : ::max(ap, T(0));            // clamp(min=0)
  T am = torch_min(alm, arm);
  am = am != am ? am : ::min(am, T(0));            // clamp(max=0)
  const T den = ap - am;
  // to_conserved_density and flux of each side
  const T ul[5] = {l.d, l.d * l.v1, l.d * l.v2, l.d * l.v3, l.e};
  const T ur[5] = {r.d, r.d * r.v1, r.d * r.v2, r.d * r.v3, r.e};
  const T fl[5] = {vl * ul[0], vl * ul[1] + l.p * n1, vl * ul[2] + l.p * n2,
                   vl * ul[3] + l.p * n3, vl * ul[4] + l.p * vl};
  const T fr[5] = {vr * ur[0], vr * ur[1] + r.p * n1, vr * ur[2] + r.p * n2,
                   vr * ur[3] + r.p * n3, vr * ur[4] + r.p * vr};
#pragma unroll
  for (int c = 0; c < 5; ++c)
    f[c] = ((fl[c] * ap - fr[c] * am) - ((ul[c] - ur[c]) * ap) * am) / den;
}

struct Tile {
  int b, x0, y0, z0;   // the block and the tile's first cell in it
  int ex, ey, ez;      // the tile's extent, cut at the block's edge
};

// a cell's place among the shared-memory slots (tile coordinates, -1 to
// the extent for the halo)
__device__ __forceinline__ int pslot(int i, int j, int k) {
  return ((i + 1) * kPY + (j + 1)) * kPZ + (k + 1);
}

__device__ __forceinline__ int cell_index(int b, int x, int y, int z,
                                          int bs) {
  return (((b * bs + x) * bs + y) * bs + z) * 5;
}

// the cell that fills a halo slot outside face (A, side) of a block, from
// the face's table row: its block nb and coordinates (x, y, z), which come
// in as the slot's own (one step outside the block along A); false for a
// FINE face, whose flux needs no guard
template <int A>
__device__ __forceinline__ bool guard_cell(const int* __restrict__ face,
                                           int side, int bs, int& nb, int& x,
                                           int& y, int& z) {
  const int* row = face + (A * 2 + side) * 9;
  int& along = A == 0 ? x : (A == 1 ? y : z);
  int& t1 = A == 0 ? y : x;
  int& t2 = A == 2 ? y : z;
  along = side == 0 ? bs - 1 : 0;
  if (row[0] == kSame) {
    nb = row[1];
    return true;
  }
  if (row[0] == kCoarse) {
    nb = row[2];
    t1 = row[3] * (bs / 2) + t1 / 2;
    t2 = row[4] * (bs / 2) + t2 / 2;
    return true;
  }
  return false;
}

// phase 1: each cell of the tile and of its six face halos, as a Cell
template <typename T>
__device__ void load_tile(const T* __restrict__ src,
                          const int* __restrict__ face, const Tile& t,
                          int bs, T g, T gm1, T* __restrict__ P) {
  for (int s = threadIdx.x; s < kPSlots; s += kThreads) {
    const int i = s / (kPY * kPZ) - 1;
    const int j = (s / kPZ) % kPY - 1;
    const int k = s % kPZ - 1;
    const bool hx = i < 0 || i >= t.ex, hy = j < 0 || j >= t.ey,
               hz = k < 0 || k >= t.ez;
    if (i > t.ex || j > t.ey || k > t.ez || int(hx) + hy + hz > 1) continue;
    int nb = t.b, x = t.x0 + i, y = t.y0 + j, z = t.z0 + k;
    bool have = true;
    if (x < 0 || x >= bs)
      have = guard_cell<0>(face, x < 0 ? 0 : 1, bs, nb, x, y, z);
    else if (y < 0 || y >= bs)
      have = guard_cell<1>(face, y < 0 ? 0 : 1, bs, nb, x, y, z);
    else if (z < 0 || z >= bs)
      have = guard_cell<2>(face, z < 0 ? 0 : 1, bs, nb, x, y, z);
    if (!have) continue;
    const Cell<T> c = cell_of(src + cell_index(nb, x, y, z, bs), g, gm1);
    P[0 * kPSlots + s] = c.d;
    P[1 * kPSlots + s] = c.v1;
    P[2 * kPSlots + s] = c.v2;
    P[3 * kPSlots + s] = c.v3;
    P[4 * kPSlots + s] = c.p;
    P[5 * kPSlots + s] = c.e;
    P[6 * kPSlots + s] = c.cs;
  }
}

template <typename T>
__device__ __forceinline__ Cell<T> shared_cell(const T* __restrict__ P,
                                               int s) {
  return {P[s], P[kPSlots + s], P[2 * kPSlots + s], P[3 * kPSlots + s],
          P[4 * kPSlots + s], P[5 * kPSlots + s], P[6 * kPSlots + s]};
}

// the face grid of axis A: faces (fi, fj, fk), one more along A than cells
template <int A>
struct Faces {
  static constexpr int X = kTX + (A == 0), Y = kTY + (A == 1),
                       Z = kTZ + (A == 2);
  static constexpr int kStride = A == 0 ? Y * Z : (A == 1 ? Z : 1);
  __device__ static int slot(int i, int j, int k) {
    return (i * Y + j) * Z + k;
  }
};

// the faces of axis A that lie on a FINE face of the block (side 0: its lo
// face, the fine blocks on the lo side): each face's flux is the 2 x 2 mean
// of the HLLE fluxes between its cell and the four fine face cells of child
// k = b2 2 + b1. One HLLE a lane, four lanes a face: lane 4 m + 2 di + dj
// takes fine cell (2 I + di, 2 J + dj), and two butterfly shuffles sum the
// four as ((a00 + a01) + (a10 + a11)), then times 1/4.
template <typename T, int A>
__device__ void fine_fluxes(const T* __restrict__ src,
                            const int* __restrict__ face, const Tile& t,
                            int bs, T g, T gm1, const T* __restrict__ P,
                            T* __restrict__ F) {
  using G = Faces<A>;
  const int e[3] = {t.ex, t.ey, t.ez};
  const int o[3] = {t.x0, t.y0, t.z0};
  constexpr int T1 = A == 0 ? 1 : 0, T2 = A == 2 ? 1 : 2;  // tangential axes
  const int h = bs / 2;
  for (int side = 0; side < 2; ++side) {
    const int* row = face + (A * 2 + side) * 9;
    const bool on_face = side == 0 ? o[A] == 0 : o[A] + e[A] == bs;
    if (!on_face || row[0] == kSame || row[0] == kCoarse) continue;
    const int tasks = 4 * e[T1] * e[T2];
    for (int base = threadIdx.x & ~31; base < tasks; base += kThreads) {
      const int w = base + (threadIdx.x & 31);
      const int c1 = (w >> 2) / e[T2], c2 = (w >> 2) % e[T2];
      const int di = (w >> 1) & 1, dj = w & 1;
      int cell[3];                       // the tile's cell at this face
      cell[A] = side == 0 ? 0 : e[A] - 1;
      cell[T1] = c1;
      cell[T2] = c2;
      T a[5] = {T(0), T(0), T(0), T(0), T(0)};
      if (w < tasks) {
        const Cell<T> own = shared_cell(P, pslot(cell[0], cell[1], cell[2]));
        const int t1 = o[T1] + c1, t2 = o[T2] + c2;
        const int b1 = t1 / h, b2 = t2 / h;
        int fine[3];                     // the fine cell in child nb
        fine[A] = side == 0 ? bs - 1 : 0;
        fine[T1] = 2 * (t1 - b1 * h) + di;
        fine[T2] = 2 * (t2 - b2 * h) + dj;
        const Cell<T> fc = cell_of(src + cell_index(row[5 + b2 * 2 + b1],
                                                    fine[0], fine[1],
                                                    fine[2], bs),
                                   g, gm1);
        if (side == 0)
          hlle<T, A>(fc, own, a);
        else
          hlle<T, A>(own, fc, a);
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const T pair = a[c] + __shfl_xor_sync(0xffffffffu, a[c], 1);
        a[c] = (pair + __shfl_xor_sync(0xffffffffu, pair, 2)) * T(0.25);
      }
      if (w < tasks && (w & 3) == 0) {
        int fc3[3] = {cell[0], cell[1], cell[2]};
        fc3[A] = side == 0 ? 0 : e[A];
#pragma unroll
        for (int c = 0; c < 5; ++c)
          F[c * kFSlots + G::slot(fc3[0], fc3[1], fc3[2])] = a[c];
      }
    }
  }
}

// phase 2 for axis A: every face's flux into F [5][kFSlots]
template <typename T, int A>
__device__ void axis_fluxes(const T* __restrict__ src,
                            const int* __restrict__ face, const Tile& t,
                            int bs, T g, T gm1, const T* __restrict__ P,
                            T* __restrict__ F) {
  using G = Faces<A>;
  const int e[3] = {t.ex, t.ey, t.ez};
  const int o[3] = {t.x0, t.y0, t.z0};
  for (int q = threadIdx.x; q < G::X * G::Y * G::Z; q += kThreads) {
    const int fc[3] = {q / (G::Y * G::Z), (q / G::Z) % G::Y, q % G::Z};
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      inside = inside && fc[a] < e[a] + (a == A);
    if (!inside) continue;
    const int fa = fc[A];
    int side = -1;
    if (fa == 0 && o[A] == 0) side = 0;
    if (fa == e[A] && o[A] + e[A] == bs) side = 1;
    if (side >= 0) {
      const int kind = face[(A * 2 + side) * 9];
      if (kind != kSame && kind != kCoarse) continue;   // fine_fluxes
    }
    const int ri = fc[0], rj = fc[1], rk = fc[2];          // the right cell
    const int li = ri - (A == 0), lj = rj - (A == 1), lk = rk - (A == 2);
    T f[5];
    hlle<T, A>(shared_cell(P, pslot(li, lj, lk)),
               shared_cell(P, pslot(ri, rj, rk)), f);
#pragma unroll
    for (int c = 0; c < 5; ++c) F[c * kFSlots + q] = f[c];
  }
  fine_fluxes<T, A>(src, face, t, bs, g, gm1, P, F);
}

// phase 3 for axis A: each thread's cells' flux differences into dU
template <typename T, int A>
__device__ __forceinline__ void accumulate(const T* __restrict__ F,
                                           const Tile& t,
                                           T dU[kPerThread][5]) {
  using G = Faces<A>;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int cell = threadIdx.x + r * kThreads;
    const int i = cell / (kTY * kTZ), j = (cell / kTZ) % kTY, k = cell % kTZ;
    if (i >= t.ex || j >= t.ey || k >= t.ez) continue;
    const int lo = G::slot(i, j, k), hi = lo + G::kStride;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const T d = F[c * kFSlots + hi] - F[c * kFSlots + lo];
      dU[r][c] = A == 0 ? d + T(0) : dU[r][c] + d;   // dU = 0.0 + dFx ...
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas<T>)
b12_step_kernel(const T* __restrict__ src, T* __restrict__ dst,
                const int* __restrict__ faces, const T* __restrict__ inv_dx,
                T dt, T g, T gm1, int bs, int tiles_x, int tiles_y,
                int tiles_z) {
  extern __shared__ unsigned char smem[];
  T* P = reinterpret_cast<T*>(smem);           // [kFields][kPSlots] cells
  T* F = P + kFields * kPSlots;                // [5][kFSlots] one axis's fluxes
  const int per_block = tiles_x * tiles_y * tiles_z;
  const int tile = blockIdx.x % per_block;
  Tile t;
  t.b = blockIdx.x / per_block;
  t.x0 = tile / (tiles_y * tiles_z) * kTX;
  t.y0 = tile / tiles_z % tiles_y * kTY;
  t.z0 = tile % tiles_z * kTZ;
  t.ex = min(kTX, bs - t.x0);
  t.ey = min(kTY, bs - t.y0);
  t.ez = min(kTZ, bs - t.z0);
  const int* face = faces + t.b * 54;          // [3][2][9] of this block

  load_tile(src, face, t, bs, g, gm1, P);
  __syncthreads();
  T dU[kPerThread][5];
  axis_fluxes<T, 0>(src, face, t, bs, g, gm1, P, F);
  __syncthreads();
  accumulate<T, 0>(F, t, dU);
  __syncthreads();
  axis_fluxes<T, 1>(src, face, t, bs, g, gm1, P, F);
  __syncthreads();
  accumulate<T, 1>(F, t, dU);
  __syncthreads();
  axis_fluxes<T, 2>(src, face, t, bs, g, gm1, P, F);
  __syncthreads();
  accumulate<T, 2>(F, t, dU);

  const T dtdx = dt * inv_dx[t.b];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int cell = threadIdx.x + r * kThreads;
    const int i = cell / (kTY * kTZ), j = (cell / kTZ) % kTY, k = cell % kTZ;
    if (i >= t.ex || j >= t.ey || k >= t.ez) continue;
    const int at = cell_index(t.b, t.x0 + i, t.y0 + j, t.z0 + k, bs);
#pragma unroll
    for (int c = 0; c < 5; ++c) dst[at + c] = src[at + c] - dtdx * dU[r][c];
  }
}

template <typename T>
int advance_n(const T* u, T* out, T* scr, const int* faces, const T* inv_dx,
              double dt, double gamma, int B, int bs, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (kFields * kPSlots + 5 * kFSlots) * int(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      b12_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tx = (bs + kTX - 1) / kTX, ty = (bs + kTY - 1) / kTY,
            tz = (bs + kTZ - 1) / kTZ;
  const dim3 grid(B * tx * ty * tz);
  // as the plain version rounds them: torch.full((), dt, dtype), the
  // Python scalars gamma and gamma - 1.0 cast to the dtype
  const T dt_t = static_cast<T>(dt), g = static_cast<T>(gamma),
          gm1 = static_cast<T>(gamma - 1.0);
  const T* src = u;
  for (int k = 1; k <= n && err == cudaSuccess; ++k) {
    // step k writes out when n - k is even, so the last step lands in out
    T* dst = ((n - k) % 2 == 0) ? out : scr;
    b12_step_kernel<T><<<grid, kThreads, smem, s>>>(
        src, dst, faces, inv_dx, dt_t, g, gm1, bs, tx, ty, tz);
    err = cudaGetLastError();
    src = dst;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* b12_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// n steps of U [B, bs, bs, bs, 5] into out; scr is a second buffer of U's
// size, faces the [B, 3, 2, 9] int32 face table, inv_dx the [B] inverse cell
// sizes in U's type, dt the step and gamma the adiabatic index (cast to U's
// type here). bs even, B bs^3 5 < 2^31. Returns a cudaError_t.
int b12_advance_n_f32(const float* u, float* out, float* scr, const int* faces,
                      const float* inv_dx, double dt, double gamma, int B,
                      int bs, int n, void* stream) {
  return advance_n<float>(u, out, scr, faces, inv_dx, dt, gamma, B, bs, n,
                          stream);
}

int b12_advance_n_f64(const double* u, double* out, double* scr,
                      const int* faces, const double* inv_dx, double dt,
                      double gamma, int B, int bs, int n, void* stream) {
  return advance_n<double>(u, out, scr, faces, inv_dx, dt, gamma, B, bs, n,
                           stream);
}

}  // extern "C"
