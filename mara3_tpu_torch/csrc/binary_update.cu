// Kernels B11a and B11b: the two halves of the flagship advance's "split"
// variant (make_advance(fused="split")).
//
// B11a replaces mara3_tpu/kernels/binary_update.py::fused_fluxes (body
// _flux_kernel): one axis's face fluxes times the face length, from the
// guard-extended primitives and slopes (face extrapolation, locally
// isothermal HLLE with its reciprocal-first divide, viscous stress, the
// angular-momentum transform with Lz zeroed within 1e-8 R of the domain
// radius). The scheme launches it once per axis.
//
// B11b replaces mara3_tpu/kernels/binary_update.py::fused_update (body
// _kernel): the back half after the corrected fluxes: flux divergence,
// gravity/sink/buffer/floor (and geometric) sources, the update, the
// accounting totals and the fault count.
//
// Bound: device memory. B11a reads 9 values a cell of each extended array
// and writes 3 a face for some 110 flops a face; B11b reads 19 values and
// writes 3 a cell for some 130 flops: a few flops a byte, under the ~20 at
// which the card's float32 rate would bound them. One thread a face (B11a)
// or a cell (B11b), in the callers' component-last [B, ., ., C] layout,
// consecutive threads on consecutive faces or cells. The TPU kernels' lane
// layout (blocks on the lane axis, lane_chunk, _pad_lanes and the padded-lane
// mask) is not carried over: the arrays are taken as they are. B11b's totals
// are per-CTA partial sums in double with a second, fixed-order pass, as in
// B2 (binary_advance_core.cuh's block_sum and sum_total).
//
// Built with --fmad=false, so every product is rounded as the plain
// versions (kernels/binary_update.py) round it.

#include "binary_tpu_flux.cuh"

namespace {

using namespace mara;

// ---- B11a: the fluxes through every face along one axis ---------------------
// p_ex, g_lon, g_tra [B, bs+2, bs, 3] (axis 0) or [B, bs, bs+2, 3] (axis 1);
// xf [B, faces, 2]; spacing [B]; f [B, bs+1, bs, 3] or [B, bs, bs+1, 3]
template <typename T>
__global__ void fluxes_kernel(const T* __restrict__ p_ex,
                              const T* __restrict__ g_lon,
                              const T* __restrict__ g_tra,
                              const T* __restrict__ xf,
                              const T* __restrict__ spacing,
                              T* __restrict__ f, int B, int bs, int axis,
                              Params prm, const double* __restrict__ dyn) {
  const int nfi = axis == 0 ? bs + 1 : bs, nfj = axis == 0 ? bs : bs + 1;
  const int nej = axis == 0 ? bs : bs + 2;   // extended width along j
  const long long n = (long long)B * nfi * nfj;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  load_dynamic(prm, dyn);
  const int j = idx % nfj;
  const int i = (idx / nfj) % nfi;
  const int b = idx / ((long long)nfi * nfj);
  const int nei = axis == 0 ? bs + 2 : bs;
  // the cells beside face (i, j) in the extended array: (i, j) and the next
  // one along the axis
  const long long lo = ((long long)b * nei + i) * nej + j;
  const long long hi = lo + (axis == 0 ? nej : 1);
  T pl[3], pr[3], gl[3], gr[3], hl[3], hr[3];
  for (int c = 0; c < 3; ++c) {
    pl[c] = p_ex[lo * 3 + c];
    pr[c] = p_ex[hi * 3 + c];
    gl[c] = g_lon[lo * 3 + c];
    gr[c] = g_lon[hi * 3 + c];
    hl[c] = g_tra[lo * 3 + c];
    hr[c] = g_tra[hi * 3 + c];
  }
  T out[3];
  face_flux_tpu(axis, pl, pr, gl, gr, hl, hr, xf[idx * 2], xf[idx * 2 + 1],
                spacing[b], prm, true, out);
  for (int c = 0; c < 3; ++c) f[idx * 3 + c] = out[c];
}

// ---- B11b: divergence, sources, update, partial totals ----------------------
template <typename T>
__global__ void update_kernel(const T* __restrict__ u0,
                              const T* __restrict__ p0,
                              const T* __restrict__ fx,
                              const T* __restrict__ fy,
                              const T* __restrict__ xc,
                              const T* __restrict__ br,
                              const T* __restrict__ init,
                              const T* __restrict__ dA,
                              T* __restrict__ u1,
                              double* __restrict__ partials, int B, int bs,
                              Params prm, const double* __restrict__ dyn) {
  const long long n = (long long)B * bs * bs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  load_dynamic(prm, dyn);
  double acc[kTotals];
  for (int t = 0; t < kTotals; ++t) acc[t] = 0.0;
  if (idx < n) {
    const int j = idx % bs;
    const int i = (idx / bs) % bs;
    const int b = idx / ((long long)bs * bs);
    const long long fxl = ((long long)b * (bs + 1) + i) * bs + j;
    const long long fyl = ((long long)b * bs + i) * (bs + 1) + j;
    T U[3], P[3], in[3], div[3], V[3];
    for (int c = 0; c < 3; ++c) {
      U[c] = u0[idx * 3 + c];
      P[c] = p0[idx * 3 + c];
      in[c] = init[idx * 3 + c];
      div[c] = (fx[(fxl + bs) * 3 + c] - fx[fxl * 3 + c])
             + (fy[(fyl + 1) * 3 + c] - fy[fyl * 3 + c]);
    }
    update_cell<T, true>(U, P, in, br[idx], div, xc[idx * 2],
                         xc[idx * 2 + 1], dA[idx], prm, V, acc);
    for (int c = 0; c < 3; ++c) u1[idx * 3 + c] = V[c];
  }
  block_sum(acc, partials + (long long)blockIdx.x * kTotals);
}

// ---- B11b's second pass: fixed-order sum of the partials, one CTA a total --
__global__ void totals_kernel(const double* __restrict__ partials, int parts,
                              double* __restrict__ totals) {
  const double v = sum_total(partials, parts, blockIdx.x);
  if (threadIdx.x == 0) totals[blockIdx.x] = v;
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

template <typename T>
int fluxes(const T* p_ex, const T* g_lon, const T* g_tra, const T* xf,
           const T* spacing, T* f, int B, int bs, int axis,
           const double* hparams, int flags, const double* dyn,
           cudaStream_t stream) {
  const Params prm = read_params(hparams, flags);
  const long long faces = (long long)B * (bs + 1) * bs;
  fluxes_kernel<T><<<blocks_for(faces), kThreads, 0, stream>>>(
      p_ex, g_lon, g_tra, xf, spacing, f, B, bs, axis, prm, dyn);
  return cudaGetLastError();
}

template <typename T>
int update(const T* u0, const T* p0, const T* fx, const T* fy, const T* xc,
           const T* br, const T* init, const T* dA, T* u1, double* partials,
           double* totals, int B, int bs, const double* hparams, int flags,
           const double* dyn, cudaStream_t stream) {
  const Params prm = read_params(hparams, flags);
  const int parts = blocks_for((long long)B * bs * bs);
  update_kernel<T><<<parts, kThreads, 0, stream>>>(
      u0, p0, fx, fy, xc, br, init, dA, u1, partials, B, bs, prm, dyn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  totals_kernel<<<kTotals, kThreads, 0, stream>>>(partials, parts, totals);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int b11_num_partials(int B, int bs) { return blocks_for((long long)B * bs * bs); }

int b11_num_totals() { return kTotals; }

const char* b11_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dyn: kDynamic doubles on the device (dt, theta, the bodies), or null to
// take them from hparams
int b11a_fluxes_f32(const float* p_ex, const float* g_lon, const float* g_tra,
                    const float* xf, const float* spacing, float* f, int B,
                    int bs, int axis, const double* hparams, int flags,
                    const double* dyn, void* stream) {
  return fluxes<float>(p_ex, g_lon, g_tra, xf, spacing, f, B, bs, axis,
                       hparams, flags, dyn, static_cast<cudaStream_t>(stream));
}

int b11a_fluxes_f64(const double* p_ex, const double* g_lon,
                    const double* g_tra, const double* xf,
                    const double* spacing, double* f, int B, int bs, int axis,
                    const double* hparams, int flags, const double* dyn,
                    void* stream) {
  return fluxes<double>(p_ex, g_lon, g_tra, xf, spacing, f, B, bs, axis,
                        hparams, flags, dyn,
                        static_cast<cudaStream_t>(stream));
}

int b11b_update_f32(const float* u0, const float* p0, const float* fx,
                    const float* fy, const float* xc, const float* br,
                    const float* init, const float* dA, float* u1,
                    double* partials, double* totals, int B, int bs,
                    const double* hparams, int flags, const double* dyn,
                    void* stream) {
  return update<float>(u0, p0, fx, fy, xc, br, init, dA, u1, partials, totals,
                       B, bs, hparams, flags, dyn,
                       static_cast<cudaStream_t>(stream));
}

int b11b_update_f64(const double* u0, const double* p0, const double* fx,
                    const double* fy, const double* xc, const double* br,
                    const double* init, const double* dA, double* u1,
                    double* partials, double* totals, int B, int bs,
                    const double* hparams, int flags, const double* dyn,
                    void* stream) {
  return update<double>(u0, p0, fx, fy, xc, br, init, dA, u1, partials,
                        totals, B, bs, hparams, flags, dyn,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
