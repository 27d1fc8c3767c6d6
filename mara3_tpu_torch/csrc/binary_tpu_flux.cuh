// The face flux of the flagship advance as the TPU kernels of its "split"
// and "jnp_strips" variants compute it, shared by kernel B11a
// (binary_update.cu) and kernel B11c (binary_advance_strips.cu).
//
// Ports mara3_tpu/kernels/binary_update.py::_flux_kernel (B11a) and
// mara3_tpu/kernels/binary_advance.py::_hlle_viscous (B11c). Both differ
// from the reference-semantics face_flux of binary_advance_core.cuh, which
// kernels B2 and B3 run, in their rounding:
//   - the physical flux is vn (sigma v), not (vn sigma) v;
//   - the flux is transformed to angular momentum before it is scaled by
//     the face length, not after;
// and in two choices of their own, which `split_form` selects:
//   - B11a's HLLE multiplies by 1 / (ap - am) and groups (Ul - Ur) (ap am);
//     B11c's divides by (ap - am) and groups ((Ul - Ur) ap) am;
//   - the Lz flux is zeroed within prm.boundary_tol of the domain radius:
//     1e-8 R for B11a, isclose's 1e-8 + 1e-5 R for B11c (the caller sets
//     it).
// B11a is HLLE only (the JAX package raises on "split" with hllc); B11c
// also runs HLLC.
//
// Arithmetic follows the plain PyTorch versions (kernels/binary_update.py
// tpu_face_flux) operation for operation; built with --fmad=false.

#pragma once

#include "binary_advance_core.cuh"

namespace mara {

// fhat * face length at one face; pl/pr the cell values beside it, gl/gr
// the slopes along the face normal, hl/hr across it; (x, y) the face
// center; s the face length (the block spacing)
template <typename T>
__device__ void face_flux_tpu(int axis, const T pl[3], const T pr[3],
                              const T gl[3], const T gr[3], const T hl[3],
                              const T hr[3], T x, T y, T s,
                              const Params& prm, bool split_form,
                              T out[3]) {
  const T half = T(0.5) * s;
  T Pl[3], Pr[3];
  for (int c = 0; c < 3; ++c) {
    Pl[c] = pl[c] + gl[c] * half;
    Pr[c] = pr[c] - gr[c] * half;
  }
  const T cs2 = cs2_at(x, y, prm);
  const T r = sqrt(x * x + y * y);
  const T profile = prm.alpha_cutoff > 0.0
      ? T(0.5) * (T(1) + tanh(T(3) * (r - T(prm.alpha_cutoff))))
      : T(1);
  const T nu = prm.nu > 0.0
      ? profile * T(prm.nu)
      : profile * T(prm.alpha) * sqrt(cs2) * (r / T(prm.mach));
  const T mu = T(0.5) * nu * (Pl[0] + Pr[0]);

  const T cs = sqrt(cs2);
  const T vnl = Pl[1 + axis], vnr = Pr[1 + axis];
  const T Ul[3] = {Pl[0], Pl[0] * Pl[1], Pl[0] * Pl[2]};
  const T Ur[3] = {Pr[0], Pr[0] * Pr[1], Pr[0] * Pr[2]};
  const T pres_l = Pl[0] * cs2, pres_r = Pr[0] * cs2;
  T Fl[3], Fr[3];
  for (int c = 0; c < 3; ++c) {
    Fl[c] = vnl * Ul[c];
    Fr[c] = vnr * Ur[c];
  }
  Fl[1 + axis] = Fl[1 + axis] + pres_l;
  Fr[1 + axis] = Fr[1 + axis] + pres_r;

  T f[3];
  if (prm.hllc && !split_form) {
    // HLLC, Toro 3rd ed. sec 10.6, isothermal (binary_advance.py:108-135)
    const T sigma_bar = T(0.5) * (Pl[0] + Pr[0]);
    const T ppvrs = T(0.5) * (pres_l + pres_r)
                  - T(0.5) * (vnr - vnl) * sigma_bar * cs;
    const T pstar = fmax(T(0), ppvrs);
    const T ql = fmax(T(1), sqrt(pstar / pres_l));
    const T qr = fmax(T(1), sqrt(pstar / pres_r));
    const T sl = vnl - cs * ql;
    const T sr = vnr + cs * qr;
    const T den = Pl[0] * (sl - vnl) - Pr[0] * (sr - vnr);
    const T sstar = (pres_r - pres_l + vnl * Pl[0] * (sl - vnl)
                     - vnr * Pr[0] * (sr - vnr)) / den;
    if (sl >= T(0)) {
      for (int c = 0; c < 3; ++c) f[c] = Fl[c];
    } else if (sstar >= T(0)) {
      const T d = Pl[0] * (sl - vnl) / (sl - sstar);
      const T Us[3] = {d, axis == 0 ? d * sstar : d * Pl[1],
                       axis == 0 ? d * Pl[2] : d * sstar};
      for (int c = 0; c < 3; ++c) f[c] = Fl[c] + (Us[c] - Ul[c]) * sl;
    } else if (sr >= T(0)) {
      const T d = Pr[0] * (sr - vnr) / (sr - sstar);
      const T Us[3] = {d, axis == 0 ? d * sstar : d * Pr[1],
                       axis == 0 ? d * Pr[2] : d * sstar};
      for (int c = 0; c < 3; ++c) f[c] = Fr[c] + (Us[c] - Ur[c]) * sr;
    } else {
      for (int c = 0; c < 3; ++c) f[c] = Fr[c];
    }
  } else {
    const T ap = fmax(T(0), fmax(vnl + cs, vnr + cs));
    const T am = fmin(T(0), fmin(vnl - cs, vnr - cs));
    if (split_form) {
      const T den = T(1) / (ap - am);
      const T apam = ap * am;
      for (int c = 0; c < 3; ++c)
        f[c] = (Fl[c] * ap - Fr[c] * am - (Ul[c] - Ur[c]) * apam) * den;
    } else {
      for (int c = 0; c < 3; ++c)
        f[c] = (Fl[c] * ap - Fr[c] * am - (Ul[c] - Ur[c]) * ap * am)
               / (ap - am);
    }
  }

  // viscous stress (subprog_binary_scheme.cpp:220-262)
  if (axis == 0) {
    const T dx_ux = T(0.5) * (gl[1] + gr[1]);
    const T dx_uy = T(0.5) * (gl[2] + gr[2]);
    const T dy_ux = T(0.5) * (hl[1] + hr[1]);
    const T dy_uy = T(0.5) * (hl[2] + hr[2]);
    f[1] = f[1] - mu * (dx_ux - dy_uy);
    f[2] = f[2] - mu * (dx_uy + dy_ux);
  } else {
    const T dx_ux = T(0.5) * (hl[1] + hr[1]);
    const T dx_uy = T(0.5) * (hl[2] + hr[2]);
    const T dy_ux = T(0.5) * (gl[1] + gr[1]);
    const T dy_uy = T(0.5) * (gl[2] + gr[2]);
    f[1] = f[1] - mu * (dx_uy + dy_ux);
    f[2] = f[2] - (-mu) * (dx_ux - dy_uy);
  }

  if (!prm.conserve_p) {
    const T coord = axis == 0 ? x : y;
    const bool at_boundary =
        fabs(fabs(coord) - T(prm.domain_radius)) <= T(prm.boundary_tol);
    const T fsr = x * f[1] + y * f[2];
    const T flz = at_boundary ? T(0) : x * f[2] - y * f[1];
    f[1] = fsr;
    f[2] = flz;
  }
  for (int c = 0; c < 3; ++c) out[c] = f[c] * s;
}

}  // namespace mara
