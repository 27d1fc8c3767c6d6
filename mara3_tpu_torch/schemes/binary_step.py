"""The device-resident flagship step: CFL, RK stages and two-body
bookkeeping with no host round trip, and the chunked scans the fast driver
loop runs.

Port of mara3_tpu/schemes/binary_step.py. The host path
(subprograms/binary.py::next_solution) reads the device once per RK stage
(the totals and the fault flag) and once per step (dt) to run the scalar
orbital-element bookkeeping on the host. Here the whole step (the
reference's next_solution + advance_u orbital updates,
subprog_binary.cpp:258-292, subprog_binary_scheme.cpp:790-1020) stays on the
run's device: dt, the bodies and the elements are tensors
(models/two_body_device.py), and kernel B2 reads them from device memory.

State crosses a step as a dict of tensors (`solution_to_arrays`); its
`conserved` keeps the port's component-last [B, bs, bs, 3] layout, which
kernels B2 and B3 take, so no step transposes it. The JAX package's
component-first layout appears only at the edges
(subprograms/binary.fast_state_from_arrays / fast_state_to_arrays).

Faults. The hot scans are retry-free: a step that sees a negative density
flags it in its info row, and the driver repairs the chunk on the host by
rewinding to its head, replaying the good steps and running the faulted
step through make_fast_step(retry=True) (subprograms/binary._main_fast). The
JAX package chose this because XLA's lax.cond runs both branches; torch has
no such cost, but an in-loop retry would have to read the fault flag on
the host every step, which is what the chunked loop exists to avoid. Only
the retrying step, which the repair alone runs, reads it once per step.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.kernels import binary_multi as BM
from mara3_tpu_torch.models import two_body_device as tbd
from mara3_tpu_torch.schemes import binary_scheme

PAIR_FIELDS = ("mass_accreted_on", "angular_momentum_accreted_on",
               "integrated_torque_on", "work_done_on")
SCALAR_FIELDS = ("time", "mass_ejected", "angular_momentum_ejected")
ELEMENT_FIELDS = ("oe_acc", "oe_grav", "oe")


def solution_to_arrays(sol, dtype=None, device=None) -> dict:
    """The fast step's state from a Solution (subprograms/binary.py), on
    the solution's device in its dtype unless given."""
    u = sol.conserved
    dtype = dtype or u.dtype
    device = device or u.device
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    s = {"iteration": int(sol.iteration),
         "conserved": u.to(device=device, dtype=dtype).contiguous()}
    for key in SCALAR_FIELDS[1:]:
        s[key] = f(getattr(sol, key))
    s["time"] = f(sol.time)
    for key in PAIR_FIELDS:
        s[key] = f(tuple(getattr(sol, key)))
    for key, name in zip(ELEMENT_FIELDS, ("orbital_elements_acc",
                                          "orbital_elements_grav",
                                          "orbital_elements")):
        s[key] = tbd.pack_elements(getattr(sol, name), dtype, device)
    return s


def host_values(s, extra=()) -> dict:
    """Every field of a state but `conserved` as host numbers, and the 0-d
    tensors `extra` as the floats of out["extra"], read from the device in
    one copy."""
    keys = SCALAR_FIELDS + PAIR_FIELDS + ELEMENT_FIELDS
    flat = torch.cat([s[k].reshape(-1).to(torch.float64) for k in keys]
                     + [e.reshape(1).to(torch.float64) for e in extra])
    flat = flat.cpu().numpy()
    out, at = {"iteration": int(s["iteration"])}, 0
    for k in keys:
        n = s[k].numel()
        out[k] = float(flat[at]) if k in SCALAR_FIELDS else flat[at:at + n]
        at += n
    out["extra"] = [float(v) for v in flat[at:]]
    return out


def arrays_to_solution(s, sol_cls, h=None):
    """A Solution (of class sol_cls) from the fast step's state; `h`, when
    given, is host_values(s) already read."""
    h = host_values(s) if h is None else h
    return sol_cls(
        time=h["time"],
        iteration=h["iteration"],
        conserved=s["conserved"],
        mass_ejected=h["mass_ejected"],
        angular_momentum_ejected=h["angular_momentum_ejected"],
        **{k: (float(h[k][0]), float(h[k][1])) for k in PAIR_FIELDS},
        orbital_elements_acc=tbd.unpack_elements(h["oe_acc"]),
        orbital_elements_grav=tbd.unpack_elements(h["oe_grav"]),
        orbital_elements=tbd.unpack_elements(h["oe"]))


def _average(a, b):
    """The RK2 close (Solution.scaled_plus with weights 1/2, 1/2)."""
    if isinstance(a, int):
        return (a + b) // 2
    return 0.5 * a + 0.5 * b


def make_fast_step(sd, bookkeeping=True, retry=True):
    """step(s) -> (s, info): one whole step on the device. info holds dt,
    retried, invalid, disk_mass and disk_angular_momentum and every field
    of the new state but `conserved`. `sd` is the SolverData of
    subprograms/binary.py.

    retry=True runs the safe-mode retry (dt/10, theta=0,
    subprog_binary.cpp:285-292) when a stage saw a negative density; it
    reads the fault flag on the host once per step, and only the driver's
    repair of a faulted chunk uses it. retry=False never reads the device.
    bookkeeping=False skips the orbital-element updates (profiling only).

    step.advance(s) -> (s, dt, retried, invalid) is the step without the
    info dict, which the scans run."""
    tables = sd.advance.tables
    conserve_p = sd.conserve_linear_p
    dA_block = tables.dA[:, 0, 0]

    def stage(s, dt, theta):
        """One advance + orbital-element bookkeeping (the device analog of
        subprograms/binary.py::advance)."""
        bodies = tbd.compute_two_body_state(s["oe"], s["time"])
        u1, t, invalid = sd.advance(s["conserved"], bodies, dt, theta)
        E0 = s["oe"]
        if bookkeeping:
            d_acc, d_grv = tbd.perturbations(
                E0, bodies, t["mass_accreted_on"],
                t["momentum_x_accreted_on"], t["momentum_y_accreted_on"],
                t["integrated_force_x_on"], t["integrated_force_y_on"],
                s["time"], sd.no_accretion_force)
            d_cm = tbd.diff_cm(E0, dt)
        else:
            d_acc = d_grv = d_cm = torch.zeros_like(E0)
        live = (s["time"] > sd.begin_live_binary).to(E0.dtype)
        s1 = {
            "time": s["time"] + dt,
            "iteration": s["iteration"] + 1,
            "conserved": u1,
            "mass_ejected": s["mass_ejected"] + t["mass_ejected"],
            "angular_momentum_ejected": s["angular_momentum_ejected"]
                + t["angular_momentum_ejected"],
            "oe_acc": s["oe_acc"] + d_acc,
            "oe_grav": s["oe_grav"] + d_grv,
            "oe": E0 + (d_acc + d_grv + d_cm) * live,
        }
        for key in PAIR_FIELDS:
            s1[key] = s[key] + t[key]
        return s1, invalid

    def do_step(s, dt, theta):
        """RK1/RK2 composition (subprog_binary.cpp:258-283)."""
        s1, i1 = stage(s, dt, theta)
        if sd.rk_order == 1:
            return s1, i1
        s2, i2 = stage(s1, dt, theta)
        return ({k: _average(s[k], s2[k]) for k in s},
                torch.logical_or(i1, i2))

    def advance(s):
        u = s["conserved"]
        if sd.fixed_dt:
            dt = torch.full((), sd.recommended_time_step, dtype=u.dtype,
                            device=u.device)
        else:
            bodies = tbd.compute_two_body_state(s["oe"], s["time"])
            dt = sd.cfl_number * sd.maximum_timestep(u, bodies)
        s1, inv = do_step(s, dt, sd.plm_theta)
        if not retry:
            return s1, dt, inv, inv
        if bool(inv):
            s_safe, inv_safe = do_step(s, dt * 0.1, 0.0)
            return s_safe, dt * 0.1, inv, inv_safe
        return s1, dt, inv, torch.zeros_like(inv)

    def step(s):
        s_out, dt, retried, invalid = advance(s)
        u = s_out["conserved"]
        bc = torch.sum(u, dim=(1, 2))                     # [B, 3]
        if conserve_p:
            xc = tables.xc
            lz = xc[..., 0] * u[..., 2] - xc[..., 1] * u[..., 1]
            disk_L = torch.sum(torch.sum(lz, dim=(1, 2)) * dA_block)
        else:
            disk_L = torch.sum(bc[:, 2] * dA_block)
        info = {"dt": dt, "retried": retried, "invalid": invalid,
                "disk_mass": torch.sum(bc[:, 0] * dA_block),
                "disk_angular_momentum": disk_L}
        info.update({k: v for k, v in s_out.items() if k != "conserved"})
        return s_out, info

    step.advance = advance
    return step


# one packed float64 row per step, so a chunk of steps reads back to the
# host as ONE copy: the time (task marking), dt (the float64 time anchor)
# and the fault flag (repair). At a due time-series sample the driver
# replays to the due step and samples the whole state.
_INFO_LAYOUT = [
    ("time", 1), ("iteration", 1), ("dt", 1), ("retried", 1),
    ("invalid", 1),
]
INFO_INDEX = {}
_off = 0
for _name, _w in _INFO_LAYOUT:
    INFO_INDEX[_name] = slice(_off, _off + _w) if _w > 1 else _off
    _off += _w
INFO_WIDTH = _off


def _info_rows(times, iteration0, dts, retried, invalid):
    """[n, INFO_WIDTH] float64 rows on the device from per-step [n]
    tensors."""
    n = times.shape[0]
    its = iteration0 + 1 + torch.arange(n, dtype=torch.float64,
                                        device=times.device)
    return torch.stack([times.to(torch.float64), its,
                        dts.to(torch.float64), retried.to(torch.float64),
                        invalid.to(torch.float64)], dim=1)


def pack_info_host(info):
    """One step's info dict (of host numbers) as an [INFO_WIDTH] row."""
    import numpy as np
    return np.concatenate([np.asarray(info[name], np.float64).reshape(-1)
                           for name, _ in _INFO_LAYOUT])


def make_fast_scan(sd):
    """scan_steps(s, n) -> (s, rows [n, INFO_WIDTH]): n retry-free steps in
    a Python loop that keeps the state and the rows on the device; the
    driver reads the rows once per chunk (subprograms/binary._main_fast)."""
    advance = make_fast_step(sd, retry=False).advance

    def scan_steps(s, n: int):
        it0 = s["iteration"]
        times, dts, invalids = [], [], []
        for _ in range(n):
            s, dt, _, invalid = advance(s)
            times.append(s["time"])
            dts.append(dt)
            invalids.append(invalid)
        inv = torch.stack(invalids)
        return s, _info_rows(torch.stack(times), it0, torch.stack(dts),
                             inv, inv)

    return scan_steps


def multi_config(sd, k_chunk: int) -> BM.MultiConfig:
    cfg = sd.cfg_scheme
    return BM.MultiConfig(
        k_steps=k_chunk, rk_order=sd.rk_order, cfl=sd.cfl_number,
        theta=sd.plm_theta if cfg.reconstruct_method == "plm" else 0.0,
        fixed_dt=sd.recommended_time_step if sd.fixed_dt else None,
        live_after=float(sd.begin_live_binary),
        no_accretion_force=bool(sd.no_accretion_force))


def make_multi_scan(sd, k_chunk: int = 16):
    """The fast scan with up to k_chunk steps per launch of kernel B3
    (kernels/binary_multi.py): the launch runs the whole steps, the
    orbital-element bookkeeping and the work done included, and returns
    one row per stage; the scan only sums the rows. Returns scan_steps(s, n)
    with make_fast_scan's contract for any n: launches of k_chunk steps,
    then one shorter launch for the rest (the kernel takes its step count
    at run time, so no step of a chunk falls back to the per-step scan).

    The elements evolve per stage inside the launch once a stage starts
    after begin_live_binary (subprog_binary_scheme.cpp:882-902), as in the
    per-step path. Faults ride the rows, as in make_fast_scan.

    Under a profiler each launch is a `mara3.call` span (attribute `steps`,
    app/tracing.py) on the timeline.

    Scope: rk_order 1 or 2, plm or pcm (hlle and hllc, both formulations);
    anything else raises NotImplementedError and the driver runs the
    per-step scan."""
    cfg = sd.cfg_scheme
    if sd.rk_order not in (1, 2):
        raise NotImplementedError("multi-step kernel: rk_order 1 or 2")
    if cfg.reconstruct_method not in ("plm", "pcm"):
        raise NotImplementedError(cfg.reconstruct_method)
    rk = sd.rk_order
    tables = sd.advance.tables
    pair_rows = {key: binary_scheme.PAIR_TOTALS.index(key)
                 for key in PAIR_FIELDS}
    rec = tracing.recorder()

    def chunk(s, k):
        """One launch of k steps."""
        u_out, rows64 = BM.advance_k(tables, s["conserved"], s["oe"],
                                     s["time"], multi_config(sd, k))
        rows = rows64.to(s["time"].dtype)
        dts = rows[0::rk, BM.ROW_DT, 0]
        invalids = torch.amax(rows[:, BM.ROW_INVALID, 0].reshape(k, rk),
                              dim=1)
        # the stage-start times as the kernel's hydro used them
        t_st = rows[:, BM.ROW_TPREV, 0]
        if rk == 1:
            t_after = t_st + dts
        else:
            # the kernel's own time update (the state's 1/2-1/2 average)
            t_after = 0.5 * t_st[0::2] + 0.5 * (t_st[1::2] + dts)
        # the rk2 average halves every per-stage increment:
        # avg(s, stage(stage(s))) = s + (D1 + D2) / 2
        inc = (1.0 / rk) * torch.sum(rows, dim=0)
        ejected = inc[BM.ROW_EJECTED]
        s1 = {"time": t_after[k - 1], "iteration": s["iteration"] + k,
              "conserved": u_out,
              "mass_ejected": s["mass_ejected"] + ejected[0],
              "angular_momentum_ejected": s["angular_momentum_ejected"]
                  + ejected[1],
              "oe_acc": s["oe_acc"] + inc[BM.ROW_DACC],
              "oe_grav": s["oe_grav"] + inc[BM.ROW_DGRV],
              "oe": rows[rk * k - 1, BM.ROW_OE]}
        for key, q in pair_rows.items():
            s1[key] = s[key] + inc[q, :2]
        zeros = torch.zeros_like(dts)
        return s1, _info_rows(t_after, s["iteration"], dts, zeros, invalids)

    def scan_steps(s, n: int):
        parts = []
        while n > 0:
            k = min(k_chunk, n)
            with rec.span("mara3.call", steps=k):
                s, rows = chunk(s, k)
            parts.append(rows)
            n -= k
        return s, torch.cat(parts)

    scan_steps.k_chunk = k_chunk
    return scan_steps
