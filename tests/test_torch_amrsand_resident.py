"""Kernel B6's resident design (mara3_tpu_torch/csrc/amrsand_step.cu
resident_kernel), checked on the CPU through what its wrapper hands the
kernel: the ownership plan of the blocks (kernels/amrsand_step.
resident_plan) and the exchange between blocks (edge_rows,
guards_from_edges), against the plain version's guards and the JAX B6 in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import amrsand_step as J6
from mara3_tpu_torch.kernels import amrsand_step as T6
from mara3_tpu_torch.kernels import resident_loop as R
from mara3_tpu_torch.mesh import block_layout as TB
from mara3_tpu_torch.mesh import regrid as RG
from mara3_tpu_torch.subprograms import amrsand as TA

torch.set_num_threads(1)

H100 = R.H100      # 132 SMs, 227 KB a CTA


def seeded(depth, bs, seed=0, regrid=False):
    """(u [B, bs, bs, 1] float64, tables, leaves) of amrsand's quadtree
    with each cell scaled by 1 + 5% noise from a numpy seed; with regrid,
    on the tree one regrid makes of it (the state remapped to it)."""
    cfg = TA.config_template().create().update({"depth": depth,
                                                "block_size": bs})
    s = TA.new_solution(cfg, dtype=torch.float64)
    leaves, u = s.leaves, s.conserved.numpy()
    if regrid:
        new = RG.propose_leaves(leaves, RG.gradient_indicator(
            u, TB.block_dx(leaves, bs)), 0.3, 0.05, depth)
        assert new != leaves
        leaves, u = new, RG.remap_blocks(leaves, u, new)
    rng = np.random.default_rng(seed)
    u = np.asarray(u) * (1.0 + 0.05 * rng.uniform(size=np.shape(u)))
    s = TA.solution_from_arrays({"iteration": 0, "time": 0.0,
                                 "leaves": leaves, "conserved": u})
    nt = TB.build_neighbor_table(s.leaves)
    return (s.conserved, T6.guard_tables(nt, TA.block_spacings(s),
                                         TA.time_step(s)), s)


# -----------------------------------------------------------------------------
# the ownership plan
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 7, 131, 132, 133, 652, 1000])
@pytest.mark.parametrize("bs,itemsize", [(8, 8), (64, 4), (16, 4)])
def test_plan_owns_every_block_once_in_contiguous_runs(B, bs, itemsize):
    """CTA g owns blocks starts[g] .. starts[g + 1]: the runs cover 0 .. B
    in order, each block once, every CTA owns one block or more, the runs
    differ by at most one block, and the shared memory asked stays within
    one CTA's limit."""
    plan = T6.resident_plan(B, bs, itemsize, H100)
    if plan is None:
        assert not H100.fits(T6.resident_smem(-(-B // min(B, H100.sms)),
                                              bs, itemsize), 1)
        return
    starts = plan.starts
    assert starts.dtype == np.int32 and starts[0] == 0 and starts[-1] == B
    sizes = np.diff(starts)
    assert plan.ctas == min(B, H100.sms) == len(sizes)
    assert sizes.min() >= 1 and sizes.max() == plan.nb_max
    assert sizes.max() - sizes.min() <= 1
    owner = np.repeat(np.arange(plan.ctas), sizes)
    assert np.array_equal(np.sort(owner), owner) and len(owner) == B
    assert plan.smem == T6.resident_smem(plan.nb_max, bs, itemsize)
    assert H100.fits(plan.smem, 1)


def test_depth_7_block_64_fits_and_block_128_does_not():
    """amrsand's depth-7 tree (652 blocks): blocks of 64 fit in float32
    (5 a CTA, 84,740 B) and float64 (169,240 B) at 132 SMs and 227 KB;
    blocks of 128 fit in neither, so they take the launch-a-step design."""
    cfg = TA.config_template().create().update({"depth": 7,
                                                "block_size": 2})
    B = len(TA.new_solution(cfg).leaves)
    assert B == 652
    for itemsize, smem in ((4, 84740), (8, 169240)):
        plan = T6.resident_plan(B, 64, itemsize, H100)
        assert plan is not None and plan.ctas == 132 and plan.nb_max == 5
        assert plan.smem == smem <= H100.smem_optin
        assert T6.resident_plan(B, 128, itemsize, H100) is None


@pytest.mark.parametrize("bs", [6, 10, 96])
def test_plan_takes_power_of_two_blocks_only(bs):
    """A cell's row and column come from shifts and masks: other even
    block sizes take the launch-a-step design."""
    assert T6.resident_plan(40, bs, 4, H100) is None
    assert T6.resident_plan(40, 8, 4, H100) is not None


def test_plan_follows_the_cards_limits():
    """The same mesh on a card with less shared memory or fewer SMs: the
    plan is a function of the limits it is given."""
    small = H100._replace(smem_optin=48 * 1024, smem_per_sm=100 * 1024)
    assert T6.resident_plan(652, 64, 4, small) is None
    few = H100._replace(sms=100)
    plan = T6.resident_plan(652, 32, 4, few)
    assert plan.ctas == 100 and plan.nb_max == 7


# -----------------------------------------------------------------------------
# the exchange between blocks
# -----------------------------------------------------------------------------

def test_edge_rows_hold_each_blocks_hi_side_rows():
    u, _, _ = seeded(3, 8)
    v = u[..., 0]
    e = T6.edge_rows(v)
    assert tuple(e.shape) == (v.shape[0], 4, 8)
    assert torch.equal(e[:, 0], v[:, 7, :]) and torch.equal(e[:, 1],
                                                            v[:, 6, :])
    assert torch.equal(e[:, 2], v[:, :, 7]) and torch.equal(e[:, 3],
                                                            v[:, :, 6])


@pytest.mark.parametrize("regrid", [False, True], ids=["static", "regrid"])
def test_guards_from_the_edge_rows_equal_lo_guard(regrid):
    """Depth 3, block 8 (every face case: same level, coarser, finer) and
    the tree one regrid makes of depth 4's (208 blocks, every face case
    again): the guards read from the edge rows [B, 4, bs] equal _lo_guard
    on the state's own rows, bit for bit."""
    u, tab, _ = seeded(4 if regrid else 3, 8, seed=2, regrid=regrid)
    assert set(np.unique(tab.faces[:, :, 0].numpy())) == {0, 1, 2}
    v = u[..., 0]
    got = T6.guards_from_edges(T6.edge_rows(v), tab.faces)
    want = [T6._lo_guard(v[:, 7, :], v[:, 6, :], tab.faces[:, 0]),
            T6._lo_guard(v[:, :, 7], v[:, :, 6], tab.faces[:, 1])]
    assert torch.equal(got[:, 0], want[0]) and torch.equal(got[:, 1],
                                                           want[1])


@pytest.mark.parametrize("regrid", [False, True], ids=["static", "regrid"])
def test_owned_runs_stepped_through_the_edge_buffer_equal_plain(regrid):
    """The resident kernel's loop, as plain PyTorch: every CTA of a plan
    for 5 SMs steps its own run of blocks with guards read from the edge
    buffer the previous step wrote, n = 7: the plain version's bits."""
    u, tab, _ = seeded(4 if regrid else 3, 8, seed=3, regrid=regrid)
    plan = T6.resident_plan(u.shape[0], 8, 8, H100._replace(sms=5))
    assert plan.ctas == 5
    v = u[..., 0].clone()
    edges = T6.edge_rows(v)
    for _ in range(7):
        g = T6.guards_from_edges(edges, tab.faces)
        new = torch.empty_like(v)
        for a, b in zip(plan.starts[:-1], plan.starts[1:]):
            w = v[a:b]
            xm1 = torch.cat([g[a:b, 0, None, :], w[:, :-1, :]], dim=1)
            ym1 = torch.cat([g[a:b, 1, :, None], w[:, :, :-1]], dim=2)
            new[a:b] = w - tab.c[a:b, None, None] * (2.0 * w - xm1 - ym1)
        v, edges = new, T6.edge_rows(new)
    assert torch.equal(v[..., None], T6.advance_n_plain(u, tab, 7))


def test_plain_through_the_exchange_matches_jax_after_a_regrid():
    """B6's plain version, stepping through the edge rows, against the JAX
    B6 in interpret mode on the tree one regrid makes of depth 4's, 4
    steps: bit for bit."""
    u, tab, s = seeded(4, 8, seed=4, regrid=True)
    nt = TB.build_neighbor_table(s.leaves)
    dxb, dt = TA.block_spacings(s), TA.time_step(s)
    B = u.shape[0]
    mats = J6.build_guard_mats(nt, 8, -(-B // 8) * 8, np.float64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(J6.advance_n_pallas(
            jnp.asarray(u.numpy()), jnp.asarray(dxb.numpy()), mats, dt, 4,
            interpret=True))
    assert np.array_equal(T6.advance_n_plain(u, tab, 4).numpy(), want)
