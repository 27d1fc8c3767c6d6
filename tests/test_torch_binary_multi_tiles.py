"""Kernel B3's tile plan (kernels/binary_multi.tile_plan), the host-side
geometry that csrc/binary_multi.cu reads as tables, against what the JAX
package computes for the same mesh: the guard cells' sources
(mara3_tpu/mesh/block_layout.build_guard_gather and the guards that
extend_blocks_fast forms from them) and the finer neighbors' fluxes that
the coarse-fine correction sums (mara3_tpu/schemes/binary_scheme.
correct_coarse_fine_fluxes).

Meshes: the flagship's depth 3 (28 blocks, same, coarser and finer
neighbors on every face) at block 16, which one tile covers, and at block
40, which neither type's tile divides. The values are float64 from a
seed; sums taken in the kernel's order are compared bit for bit.

Sweep 2's pieces (kernels/binary_multi.tile_plan, march_ctas): on the
flagship's d6b96 mesh and at depth 3 with blocks of 24 and 40 (one clipped
strip a block; a full and a clipped one), for 132 SMs and an odd count, at
two and three CTAs an SM."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.mesh import block_layout as JL
from mara3_tpu.schemes import binary_scheme as JS
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.kernels import binary_multi as TM
from mara3_tpu_torch.mesh import block_layout as TL
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

MESHES = [(3, 16), (3, 40)]
MESH_IDS = [f"d{d}b{bs}" for d, bs in MESHES]
TILES = [(m, dtype) for m in MESHES for dtype in (torch.float32,
                                                 torch.float64)]
TILE_IDS = [f"d{d}b{bs}-{str(dtype)[6:]}" for (d, bs), dtype in TILES]


def meshes(depth, bs):
    """(the port's packed neighbor table, the JAX package's neighbor
    table, the port's) of the flagship's mesh."""
    over = {"depth": depth, "block_size": bs}
    tcfg = TB.create_config_template().create().update(over)
    jcfg = JB.create_config_template().create().update(over)
    tnt = TL.build_neighbor_table(TB.create_leaves(tcfg))
    return (TL.pack_neighbor_table(tnt),
            JL.build_neighbor_table(JB.create_leaves(jcfg)), tnt)


def plan(tab, bs, tile):
    """(tiles, ring, fine) of kernels/binary_multi.tile_plan as arrays."""
    tp = TM.tile_plan(tab, bs, tile)
    return tp.tiles.numpy(), tp.ring.numpy(), tp.fine.numpy()


def ring_values(v, ring):
    """The guard cells that the kernel's ring_value forms from v [N, C]: a
    copy of one cell, or 0.25 a + 0.25 b + 0.25 c + 0.25 d in slot
    order."""
    one = v[np.maximum(ring, 0)]                     # [B, 4, bs, 4, C]
    four = (0.25 * one[..., 0, :] + 0.25 * one[..., 1, :]
            + 0.25 * one[..., 2, :] + 0.25 * one[..., 3, :])
    return np.where((ring[..., 1] < 0)[..., None], one[..., 0, :], four)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_has_level_jumps_on_every_side(mesh):
    """Each face direction meets same-level, coarser and finer neighbors,
    so the tables below are checked in every case."""
    tab, nt, _ = meshes(*mesh)
    np.testing.assert_array_equal(tab[:, :, 0], nt.case)
    for f in range(4):
        assert set(np.unique(tab[:, f, 0])) == {0, 1, 2}, f


@pytest.mark.parametrize("mesh,dtype", TILES, ids=TILE_IDS)
def test_tiles_cover_every_cell_once(mesh, dtype):
    """The tiles of each block, clipped at its upper edges, cover its cells
    once; none is larger than the kernel's tile."""
    depth, bs = mesh
    tab, _, _ = meshes(depth, bs)
    B = tab.shape[0]
    ti, tj = TM.TILE[dtype]
    tiles = plan(tab, bs, (ti, tj))[0]
    assert tiles.dtype == np.int32 and tiles.shape[1] == 5
    count = np.zeros((B, bs, bs), np.int64)
    for b, i0, j0, ni, nj in tiles:
        assert 1 <= ni <= ti and 1 <= nj <= tj
        assert (ni == ti or i0 + ni == bs) and (nj == tj or j0 + nj == bs)
        count[b, i0:i0 + ni, j0:j0 + nj] += 1
    np.testing.assert_array_equal(count, 1)
    np.testing.assert_array_equal(np.sort(tiles[:, 0], kind="stable"),
                                  tiles[:, 0])
    per_block = -(-bs // ti) * -(-bs // tj)
    assert len(tiles) == B * per_block


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_ring_sources_are_the_jax_guard_gather(mesh):
    """The ring table names the cells of the JAX package's guard gather, in
    its slot order: one cell of weight 1 (same or coarser neighbor) or four
    of weight 1/4 (finer neighbors)."""
    depth, bs = mesh
    tab, nt, _ = meshes(depth, bs)
    ring = plan(tab, bs, TM.TILE[torch.float32])[1]
    gg = JL.build_guard_gather(nt, bs)
    assert ring.dtype == np.int32
    assert ring.shape == gg.indices.shape
    used = gg.weights > 0
    np.testing.assert_array_equal(ring >= 0, used)
    np.testing.assert_array_equal(np.where(used, ring, 0),
                                  np.where(used, gg.indices, 0))
    single = ring[..., 1] < 0
    np.testing.assert_array_equal(gg.weights[single][:, 0], 1.0)
    np.testing.assert_array_equal(gg.weights[~single], 0.25)
    np.testing.assert_array_equal(
        single, np.broadcast_to(tab[:, :, :1] != 2, single.shape))


@pytest.mark.parametrize("C", [3, 6], ids=["p", "g"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_ring_values_match_the_guard_cells(mesh, C):
    """Guard cells formed in the kernel's order from the ring table: bit
    for bit the port's guard_strips (the plain version's guards), and the
    JAX package's extend_blocks_fast to round-off (it sums with einsum)."""
    depth, bs = mesh
    tab, nt, tnt = meshes(depth, bs)
    B = tab.shape[0]
    ring = plan(tab, bs, TM.TILE[torch.float64])[1]
    rng = np.random.default_rng(depth * 100 + bs + C)
    U = rng.uniform(0.5, 1.5, (B, bs, bs, C))
    got = ring_values(U.reshape(-1, C), ring)               # [B, 4, bs, C]
    want = TL.guard_strips(torch.as_tensor(U),
                           TL.build_guard_gather(tnt, bs)).numpy()
    np.testing.assert_array_equal(got, want)
    gg = JL.build_guard_gather(nt, bs)
    ex = np.asarray(JL.extend_blocks_fast(jnp.asarray(U), gg, 0))
    ey = np.asarray(JL.extend_blocks_fast(jnp.asarray(U), gg, 1))
    jax_guards = np.stack([ex[:, 0], ex[:, -1], ey[:, :, 0], ey[:, :, -1]],
                          axis=1)
    np.testing.assert_allclose(got, jax_guards, rtol=1e-15, atol=0.0)


@pytest.mark.parametrize("axis", [0, 1], ids=["x", "y"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_fine_faces_are_the_jax_flux_correction(mesh, axis):
    """Where two finer neighbors meet a face, the sum of the two finer
    faces that the fine table names is bit for bit the flux that the JAX
    package's correct_coarse_fine_fluxes puts there; the table is -1 at
    every other face."""
    depth, bs = mesh
    tab, nt, _ = meshes(depth, bs)
    B = tab.shape[0]
    fine = plan(tab, bs, TM.TILE[torch.float32])[2]
    assert fine.dtype == np.int32
    shape = (B, bs + 1, bs, 1) if axis == 0 else (B, bs, bs + 1, 1)
    fhat = np.random.default_rng(7 + axis).normal(size=shape)
    corrected = np.asarray(JS.correct_coarse_fine_fluxes(
        jnp.asarray(fhat), nt, axis))[..., 0]
    flat = fhat.reshape(-1)
    for side in (0, 1):
        f = 2 * axis + side
        table = fine[:, f]                                  # [B, bs, 2]
        is_fine = tab[:, f, 0] == 2
        np.testing.assert_array_equal(table[~is_fine], -1)
        assert (table[is_fine] >= 0).all()
        n = bs + 1
        edge = (corrected[:, 0 if side == 0 else n - 1] if axis == 0
                else corrected[:, :, 0 if side == 0 else n - 1])
        sums = flat[table[..., 0]] + flat[table[..., 1]]
        np.testing.assert_array_equal(sums[is_fine], edge[is_fine])


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_fine_faces_face_back_onto_the_coarse_block(mesh):
    """Each finer face that sweep 2 recomputes lies on its block's edge
    toward the coarse block, and that block sees the coarse block as its
    coarser neighbor there: the recomputed flux reads the coarse block's
    cells as its guard, as the finer block's own face does."""
    depth, bs = mesh
    tab, _, _ = meshes(depth, bs)
    fine = plan(tab, bs, TM.TILE[torch.float32])[2]
    per = (bs + 1) * bs
    for b, f, pos in zip(*np.nonzero(fine[..., 0] >= 0)):
        axis, side = f >> 1, f & 1
        for h in (0, 1):
            nb, r = divmod(int(fine[b, f, pos, h]), per)
            i, j = divmod(r, bs) if axis == 0 else divmod(r, bs + 1)
            k = i if axis == 0 else j
            assert k == (bs if side == 0 else 0)
            back = 2 * axis + (1 - side)
            assert tab[nb, back, 0] == 1 and tab[nb, back, 2] == b
            along = j if axis == 0 else i
            assert along == (2 * pos) % bs + h


PIECE_MESHES = [(6, 96), (3, 24), (3, 40)]
# CTAs an SM of sweep 2: its launch bounds ask for three (csrc/
# binary_multi.cu kSweep2Ctas); the card's occupancy calculator gives the
# number the plan takes
PIECE_CASES = [(m, per_sm, sms) for m in PIECE_MESHES for per_sm in (2, 3)
               for sms in (132, 7)]
PIECE_IDS = [f"d{d}b{bs}-{per_sm}x{sms}sm"
             for (d, bs), per_sm, sms in PIECE_CASES]


@pytest.mark.parametrize("mesh,per_sm,sms", PIECE_CASES, ids=PIECE_IDS)
def test_march_pieces_cover_every_cell_once(mesh, per_sm, sms):
    """Sweep 2's pieces, which the CTAs of one wave claim in turn, cover
    every cell of every block once; each lies in one strip of 32 columns
    and holds at most a row-group of its rows, so no CTA marches more than
    one piece past the others; a strip that the block's edge clips keeps
    its lane count; some pieces start inside a block, on a row that is
    not a multiple of 32, and some meet a level jump at their lower edge;
    the costliest come first."""
    depth, bs = mesh
    tab, _, _ = meshes(depth, bs)
    B = tab.shape[0]
    G = TM.MARCH_ROWS
    plan = TM.tile_plan(tab, bs, TM.TILE[torch.float32])
    pieces = plan.pieces.numpy()
    assert pieces.dtype == np.int32 and pieces.shape[1] == 5
    strips = -(-bs // 32)
    assert len(pieces) == B * strips * -(-bs // G)
    n = TM.march_ctas(len(pieces), sms, per_sm)
    assert n == min(len(pieces), sms * per_sm)
    count = np.zeros((B, bs, bs), np.int64)
    for b, i0, j0, ni, nj in pieces:
        assert 1 <= ni <= G and (ni == G or i0 + ni == bs)
        assert j0 % 32 == 0 and nj == min(32, bs - j0)
        count[b, i0:i0 + ni, j0:j0 + nj] += 1
    np.testing.assert_array_equal(count, 1)
    # clipped strips keep their lanes: a strip is [j0, min(j0 + 32, bs))
    assert sorted(set(pieces[:, 4])) == sorted({min(32, bs - j0)
                                               for j0 in range(0, bs, 32)})
    assert ((pieces[:, 1] % 32) != 0).any()
    lower = pieces[:, 1] + pieces[:, 3] == bs
    assert (tab[pieces[lower, 0], 1, 0] != 0).any()
    # claimed costliest first: the full-height pieces, those with finer
    # neighbours' faces first among them; the short ones last
    ni = pieces[:, 3]
    assert (np.diff(ni) <= 0).all()
    b, i0, j0, _, nj = pieces.T.astype(np.int64)
    fine = tab[b, :, 0] == 2
    cost = (nj * fine[:, 0] * (i0 == 0) + nj * fine[:, 1] * (i0 + ni == bs)
            + ni * fine[:, 2] * (j0 == 0) + ni * fine[:, 3] * (j0 + nj == bs))
    assert (np.diff(cost[ni == G]) <= 0).all() and cost.max() > 0


@pytest.mark.parametrize("pieces,sms,per_sm,ctas", [
    (2856, 132, 3, 396), (2856, 7, 2, 14), (10, 132, 3, 10), (0, 132, 3, 1)])
def test_march_ctas_one_wave_or_one_a_piece(pieces, sms, per_sm, ctas):
    """Sweep 2 launches one wave (the card's SMs times its CTAs an SM), or
    one CTA a piece where the mesh has fewer pieces, and never none."""
    assert TM.march_ctas(pieces, sms, per_sm) == ctas
