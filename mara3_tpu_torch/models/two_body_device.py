"""Two-body orbital mechanics on tensors, for the device-resident flagship
step.

Port of mara3_tpu/models/two_body_jax.py: the formulas of models/two_body.py
(a re-design of src/model_two_body.hpp) on tensors of the run's device and
dtype, so the whole binary step (Kepler solve, element inversion,
perturbation bookkeeping) runs beside the hydro advance with no host round
trip. Every function broadcasts over leading axes, where schemes/
binary_step.py batches what the JAX package vmaps (the two perturbed body
sets of a stage, the stages of a multi-step launch).

Representations:
  elements  e10 [..., 10] = (pomega, tau, cm_x, cm_y, cm_vx, cm_vy, a, M,
            q, e)
  bodies    [..., 2, 5] rows (mass, x, y, vx, vy), the scheme's bodies.

Differences from the host module, by design (as in the JAX package):
  - Kepler's equation is solved by a FIXED count of Newton updates from a
    series starter (KEPLER_ITERS), not the reference's tolerance loop
    (model_two_body.hpp:131-160): a loop that tests convergence would read
    the device every pass;
  - compute_orbital_elements cannot raise on an unbound orbit; it yields
    NaN there instead.

Nothing here reads a tensor back to the host; unpack_elements takes host
numbers that the caller has already read.
"""

from __future__ import annotations

import math

import torch

from mara3_tpu_torch.models import two_body as tb
from mara3_tpu_torch.schemes.binary_scheme import _square_sum

# e10 component indices
POMEGA, TAU, CMX, CMY, CMVX, CMVY, A, M, Q, E = range(10)

KEPLER_ITERS = 10


def _stack(values, dim=-1):
    """torch.stack after broadcasting the values to one shape."""
    return torch.stack(torch.broadcast_tensors(*values), dim=dim)


def _hypot(x, y):
    """sqrt(x^2 + y^2) as jnp.hypot computes it: a sqrt(1 + (b/a)^2) with
    a = max(|x|, |y|), b = min(|x|, |y|), the square added unrounded as
    XLA's compiled code adds it. The near-circular element inversion
    amplifies an ulp of r1 into its gauge angles, so it rounds as the JAX
    package does rather than as torch.hypot does."""
    x, y = torch.abs(x), torch.abs(y)
    a, b = torch.maximum(x, y), torch.minimum(x, y)
    r = b / torch.where(a == 0.0, torch.ones_like(a), a)
    return torch.where(a == 0.0, a,
                       a * torch.sqrt(_square_sum(r, torch.ones_like(r))))


def pack_elements(fe: tb.FullOrbitalElements, dtype=torch.float64,
                  device="cpu"):
    el = fe.elements
    return torch.tensor([fe.pomega, fe.tau, fe.cm_position_x,
                         fe.cm_position_y, fe.cm_velocity_x,
                         fe.cm_velocity_y, el.separation, el.total_mass,
                         el.mass_ratio, el.eccentricity], dtype=dtype,
                        device=device)


def unpack_elements(e10) -> tb.FullOrbitalElements:
    """FullOrbitalElements from ten host numbers (a list or numpy array)."""
    v = [float(x) for x in e10]
    return tb.FullOrbitalElements(
        pomega=v[0], tau=v[1], cm_position_x=v[2], cm_position_y=v[3],
        cm_velocity_x=v[4], cm_velocity_y=v[5],
        elements=tb.OrbitalElements(v[6], v[7], v[8], v[9]))


def orbital_period(e10):
    return 2 * math.pi / torch.sqrt(e10[..., M] / e10[..., A] ** 3)


def _solve_kepler(ecc, M_anom):
    """E - e sin E = M by KEPLER_ITERS Newton updates from the series
    starter M + e sin M + (e^2/2) sin 2M, which puts Newton in its quadratic
    basin for e up to about 0.95 (two_body_jax._solve_kepler)."""
    x = M_anom + ecc * torch.sin(M_anom) \
        + 0.5 * ecc * ecc * torch.sin(2.0 * M_anom)
    for _ in range(KEPLER_ITERS):
        y = x - ecc * torch.sin(x) - M_anom
        x = x - y / (1.0 - ecc * torch.cos(x))
    return x


def compute_two_body_state(e10, t):
    """bodies [..., 2, 5] at time t from full elements e10 [..., 10]
    (model_two_body.hpp:168-270: Kepler solve, periapse rotation, CM
    boost)."""
    a, Mt, q, ecc = e10[..., A], e10[..., M], e10[..., Q], e10[..., E]
    P = orbital_period(e10)
    # the host path's `while t < tau: t += P`
    n = torch.clamp(torch.ceil((e10[..., TAU] - t) / P), min=0.0)
    tloc = t + n * P - e10[..., TAU]

    omega = torch.where(a == 0.0, torch.zeros_like(a),
                        torch.sqrt(Mt / a ** 3))
    mu = q / (1.0 + q)

    M_anom = omega * tloc
    Ecc = torch.where(ecc > 0.0, _solve_kepler(ecc, M_anom), M_anom)

    cE, sE = torch.cos(Ecc), torch.sin(Ecc)
    root = torch.sqrt(1.0 - ecc * ecc)
    x1 = -a * mu * (ecc - cE)
    y1 = +a * mu * sE * root
    vx1 = -a * mu * omega / (1.0 - ecc * cE) * sE
    vy1 = +a * mu * omega / (1.0 - ecc * cE) * cE * root
    m1 = Mt * (1.0 - mu)
    m2 = Mt * mu
    x2, y2, vx2, vy2 = -x1 / q, -y1 / q, -vx1 / q, -vy1 / q

    c = torch.cos(-e10[..., POMEGA])
    s = torch.sin(-e10[..., POMEGA])

    def transform(m, x, y, vx, vy):
        xr = +x * c + y * s
        yr = -x * s + y * c
        vxr = +vx * c + vy * s
        vyr = -vx * s + vy * c
        return _stack([m, xr + e10[..., CMX], yr + e10[..., CMY],
                       vxr + e10[..., CMVX], vyr + e10[..., CMVY]])

    return _stack([transform(m1, x1, y1, vx1, vy1),
                   transform(m2, x2, y2, vx2, vy2)], dim=-2)


def compute_orbital_elements(bodies, t):
    """The inverse map bodies [..., 2, 5] -> e10 [..., 10]
    (model_two_body.hpp:294-402). An unbound orbit (energy >= 0) gives NaN
    where the host path raises."""
    b1, b2 = bodies[..., 0, :], bodies[..., 1, :]
    M1, M2 = b1[..., 0], b2[..., 0]
    Mt = M1 + M2
    q = M2 / M1

    x_cm = (b1[..., 1] * M1 + b2[..., 1] * M2) / Mt
    y_cm = (b1[..., 2] * M1 + b2[..., 2] * M2) / Mt
    vx_cm = (b1[..., 3] * M1 + b2[..., 3] * M2) / Mt
    vy_cm = (b1[..., 4] * M1 + b2[..., 4] * M2) / Mt

    x1, y1 = b1[..., 1] - x_cm, b1[..., 2] - y_cm
    x2, y2 = b2[..., 1] - x_cm, b2[..., 2] - y_cm
    r1 = _hypot(x1, y1)
    r2 = _hypot(x2, y2)
    vx1, vy1 = b1[..., 3] - vx_cm, b1[..., 4] - vy_cm
    vx2, vy2 = b2[..., 3] - vx_cm, b2[..., 4] - vy_cm
    vf1 = -vx1 * y1 / r1 + vy1 * x1 / r1
    vf2 = -vx2 * y2 / r2 + vy2 * x2 / r2
    v1 = _hypot(vx1, vy1)

    E1 = 0.5 * M1 * (vx1 ** 2 + vy1 ** 2)
    E2 = 0.5 * M2 * (vx2 ** 2 + vy2 ** 2)
    L = M1 * r1 * vf1 + M2 * r2 * vf2
    En = E1 + E2 - M1 * M2 / (r1 + r2)
    En = torch.where(En < 0.0, En, torch.full_like(En, math.nan))

    a = -0.5 * M1 * M2 / En
    b = torch.sqrt(-0.5 * L * L / En * Mt / (M1 * M2))
    ecc = torch.sqrt(torch.clamp(1.0 - b * b / (a * a), 0.0, 1.0))
    omega = torch.sqrt(Mt / a ** 3)

    a1 = a * q / (1.0 + q)
    b1_ = b * q / (1.0 + q)

    circ = ecc == 0.0
    safe_e = torch.where(circ, torch.ones_like(ecc), ecc)
    cn = torch.where(circ, x1 / r1, (1.0 - r1 / a1) / safe_e)
    cf = a1 / r1 * (cn - ecc)
    root = torch.sqrt(1.0 - ecc * ecc)
    sn = torch.where(circ, y1 / r1,
                     (vx1 * x1 + vy1 * y1) / (safe_e * v1 * r1)
                     * torch.sqrt(1.0 - ecc * ecc * cn * cn))
    sf = (b1_ / r1) * sn

    cE = (ecc + cf) / (1.0 + ecc * cf)
    sE = root * sf / (1.0 + ecc * cf)

    EE = torch.atan2(sE, cE)
    MM = EE - ecc * sE
    tau = t - MM / omega

    ax = +(cn - ecc) * x1 + sn * root * y1
    ay = +(cn - ecc) * y1 - sn * root * x1
    pomega = torch.atan2(ay, ax)

    return _stack([pomega, tau, x_cm, y_cm, vx_cm, vy_cm, a, Mt, q, ecc])


def _wrap(delta, period):
    """min(|delta|, |delta +- period|) selection (model_two_body.hpp:
    492-523)."""
    lo = delta + period
    hi = delta - period
    best = torch.where(torch.abs(lo) < torch.abs(delta), lo, delta)
    return torch.where(torch.abs(hi) < torch.abs(best), hi, best)


def diff(a10, b10):
    """Periodic-aware perturbation b - a: pomega mod 2 pi, tau mod the
    orbital period of b."""
    d = b10 - a10
    pomega = _wrap(d[..., POMEGA], 2 * math.pi)
    tau = _wrap(d[..., TAU], orbital_period(b10))
    return torch.cat([pomega[..., None], tau[..., None], d[..., 2:]], dim=-1)


def perturbations(E, bodies, dM, dpx, dpy, fx, fy, t, no_accretion_force):
    """(d_acc, d_grv): the element changes of one advance
    (subprog_binary_scheme.cpp:882-902). The accreted body set takes the
    accreted mass dM and momentum (dpx, dpy) (unless no_accretion_force),
    the forced set the integrated gravitational force (fx, fy); each is
    inverted to elements at time t and diffed against E. bodies
    [..., 2, 5]; the totals [..., 2] per body; t broadcasts like bodies'
    leading axes."""
    m, x, y, vx, vy = (bodies[..., j] for j in range(5))
    if no_accretion_force:
        avx, avy = vx, vy
    else:
        avx = (m * vx + dpx) / (m + dM)
        avy = (m * vy + dpy) / (m + dM)
    acc = _stack([m + dM, x, y, avx, avy])
    grv = _stack([m, x, y, vx + fx / m, vy + fy / m])
    d = diff(E, compute_orbital_elements(torch.stack([acc, grv]), t))
    return d[0], d[1]


def diff_cm(a10, dt):
    """CM drift over dt (model_two_body.hpp:525-532)."""
    z = torch.zeros_like(a10[..., 0])
    return _stack([z, z, a10[..., CMVX] * dt, a10[..., CMVY] * dt,
                   z, z, z, z, z, z])
