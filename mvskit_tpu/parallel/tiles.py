"""Map-block (cell-row) tile sharding of the propagation step.

SURVEY.md §7.7: the reference's serpentine sweep walks the whole cell
grid of every image sequentially (reference pmmvps/propagate.cpp:78-121).
The engine's re-design already replaced the sweep with checkerboard rounds
(pipeline/propagate.py); this module shards those rounds' *spatial
index* — the per-image cell grids of the PatchManager (reference
pmmvps/patch_manager.hpp:90-104) — across a device mesh by cell ROW,
the SP/CP analog:

  * grid build (slots / vslots / z-buffer) runs tile-locally under
    `shard_map`: each device scatters and ranks only the (patch, view)
    pairs landing in its row window, so slot/depth memory and scatter
    traffic scale 1/k per device;
  * donor selection is a per-tile top-k merged into the exact global
    NCC-descending top-`budget` (bitwise identical to the unsharded
    `select_donors`);
  * the full-cell gate (reference propagate.cpp:166-173) reads the
    target cell's worst incumbent. A donor in the tile's boundary row
    targets its mesh neighbor's first/last row, so that row travels by
    a 1-cell `ppermute` halo exchange — the propagation halo of
    SURVEY.md §7;
  * the gauntlet's cross-view structures (occlusion z-buffers,
    vimages discovery) are global by nature — a hypothesis projects
    into arbitrary rows of *other* views — so the tiled grid is
    all-gathered once per phase for that stage (the cheap, MB-scale
    "Schur-style block reduction" step; the planes and the NCC compute,
    which dominate, never replicate).

`tiled_propagate_round` is observationally identical to
`pipeline.propagate.propagate_round` (asserted by tests/test_tiles.py
on the 8-device CPU mesh).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import grid as gridmod
from ..core.grid import GridState
from ..core.patches import PatchTable
from ..image.scene import Scene
from ..pipeline import propagate as pr

NEG = pr.NEG


def _tile_rows(scene: Scene, level: int, csize: int, k: int) -> Tuple[int, int]:
    """(rows per tile, padded total rows). Cell rows pad up to a
    multiple of the mesh size; padded rows hold no cells (every real
    cy < gh) and are sliced off before the gauntlet."""
    _, gh = gridmod.grid_dims(scene, level, csize)
    gh_l = (gh + k - 1) // k
    return gh_l, gh_l * k


def _halo_rows(x, axis: str, fill):
    """Exchange the boundary cell row of a [n, rows_local, gw] block
    with both mesh neighbors (1-cell propagation halo, SURVEY.md §7.7).
    Returns (from_prev, from_next), `fill`-valued at the mesh edges."""
    k = lax.axis_size(axis)
    fwd = [(i, (i + 1) % k) for i in range(k)]
    bwd = [(i, (i - 1) % k) for i in range(k)]
    from_prev = lax.ppermute(x[:, -1:, :], axis, fwd)
    from_next = lax.ppermute(x[:, :1, :], axis, bwd)
    idx = lax.axis_index(axis)
    from_prev = jnp.where(idx == 0, jnp.full_like(from_prev, fill), from_prev)
    from_next = jnp.where(
        idx == k - 1, jnp.full_like(from_next, fill), from_next
    )
    return from_prev, from_next


def tiled_build_grid(
    mesh: Mesh,
    scene: Scene,
    table: PatchTable,
    level: int,
    csize: int,
    capacity: int,
    v_capacity: Optional[int] = None,
    with_depth: bool = True,
    axis: str = "tile",
) -> GridState:
    """build_grid with cell rows sharded over `axis`: each tile runs
    the segmented per-cell top-K and z-buffer scatter only for its row
    window (exact per cell — cells are disjoint and every tile sees the
    whole patch table). Returns a GridState whose row axis is padded to
    mesh.shape[axis]*rows_local and row-sharded; `tiled_grid_to_global`
    slices it back. evicted is psum-combined (each over-capacity pair
    belongs to exactly one tile)."""
    if v_capacity is None:
        v_capacity = capacity
    k = mesh.shape[axis]
    gh_l, _ = _tile_rows(scene, level, csize, k)
    n = scene.n_images
    gw, _ = gridmod.grid_dims(scene, level, csize)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=GridState(
            slots=P(None, axis),
            vslots=P(None, axis),
            depth=P(None, axis),
            depth_idx=P(None, axis),
            evicted=P(),
        ),
    )
    def _build(scene, table):
        r0 = lax.axis_index(axis) * gh_l
        slots, evicted = gridmod._fill_slots(
            scene, table, table.images, level, csize, capacity,
            row_start=r0, row_count=gh_l,
        )
        vslots, _ = gridmod._fill_slots(
            scene, table, table.vimages, level, csize, v_capacity,
            row_start=r0, row_count=gh_l,
        )
        if with_depth:
            depth, depth_idx = gridmod.build_depth_maps(
                scene, table, level, csize, row_start=r0, row_count=gh_l
            )
        else:
            depth = jnp.full((n, gh_l, gw), gridmod.INF)
            depth_idx = jnp.full((n, gh_l, gw), -1, jnp.int32)
        evicted = lax.psum(evicted.astype(jnp.int32), axis) > 0
        return GridState(slots, vslots, depth, depth_idx, evicted)

    return _build(scene, table)


def tiled_grid_to_global(
    scene: Scene, grid: GridState, level: int, csize: int
) -> GridState:
    """Slice the row padding off a tiled GridState, yielding the global
    layout the cross-view stages consume (GSPMD all-gathers the shards
    where needed — the per-phase block-reduction step)."""
    _, gh = gridmod.grid_dims(scene, level, csize)
    sl = lambda a: a[:, :gh]
    return GridState(
        slots=sl(grid.slots),
        vslots=sl(grid.vslots),
        depth=sl(grid.depth),
        depth_idx=sl(grid.depth_idx),
        evicted=grid.evicted,
    )


def tiled_select_donors(
    mesh: Mesh,
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    budget: int,
    level: int,
    csize: int,
    axis: str = "tile",
    policy: str = "cell_first",
):
    """select_donors over a row-sharded grid: per-tile local top-k
    candidates, merged into the exact global priority-descending
    top-budget (a locally-dropped candidate has >= budget better
    candidates in its own tile, so it cannot reach the global top — the
    merge is lossless for any per-slot priority, including the
    cell_first rank-major one). Returns (pidx, img, cy, cx, ok),
    identical to propagate.select_donors on the same (padded-layout)
    grid."""
    k = mesh.shape[axis]
    gh_l, gh_pad = _tile_rows(scene, level, csize, k)
    n = scene.n_images
    gw, _ = gridmod.grid_dims(scene, level, csize)
    S = grid.capacity

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def _local(slots_local, images0, ncc, alive):
        flat = slots_local.reshape(-1)
        pidx = jnp.maximum(flat, 0)
        ar = jnp.arange(n * gh_l * gw * S, dtype=jnp.int32)
        slot_img = ar // (gh_l * gw * S)
        ok = (flat >= 0) & (images0[pidx] == slot_img) & alive[pidx]
        prio = pr.donor_priority(ncc[pidx], ar % S, ok, policy)
        vals, loc = lax.top_k(prio, budget)
        # local flat index -> global (padded-layout) flat index
        t = lax.axis_index(axis)
        cell_l = loc // S
        s = loc % S
        img = cell_l // (gh_l * gw)
        rem = cell_l % (gh_l * gw)
        cyl = rem // gw
        cx = rem % gw
        gflat = (((img * gh_pad) + t * gh_l + cyl) * gw + cx) * S + s
        return vals, gflat, jnp.take(pidx, loc)

    vals, gflat, cand_pidx = _local(
        grid.slots, table.images[:, 0], table.ncc, table.alive
    )  # each [k * budget]

    # exact global merge: scatter the candidates back into the full
    # (padded) flat-slot layout and re-run the same top-k the unsharded
    # select_donors performs
    nflat = n * gh_pad * gw * S
    prio_full = jnp.full((nflat,), NEG, jnp.float32).at[gflat].set(vals)
    pidx_full = jnp.zeros((nflat,), jnp.int32).at[gflat].set(cand_pidx)
    top_vals, top = lax.top_k(prio_full, budget)
    cell = top // S
    img = cell // (gh_pad * gw)
    rem = cell % (gh_pad * gw)
    cy = rem // gw
    cx = rem % gw
    return jnp.take(pidx_full, top), img, cy, cx, top_vals > NEG


def tiled_full_cell_gate(
    mesh: Mesh,
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    donor_img,
    donor_cy,
    donor_cx,
    axis_sp: int,
    direction: int,
    level: int,
    csize: int,
    axis: str = "tile",
):
    """The full-cell gate state (worst incumbent of each donor's target
    cell, reference propagate.cpp:166-173) over a row-sharded grid.

    Each tile evaluates the donors whose *source* row it owns; a target
    one row beyond the tile boundary is served by the 1-cell ppermute
    halo (`_halo_rows`). Results merge by psum — every donor has exactly
    one owner. Returns (full[B] bool, worst_ncc[B])."""
    k = mesh.shape[axis]
    gh_l, _ = _tile_rows(scene, level, csize, k)
    gw, _ = gridmod.grid_dims(scene, level, csize)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )
    def _gate(slots_local, ncc, dimg, dcy, dcx):
        worst_l = slots_local[..., -1]  # [n, gh_l, gw] int32
        prev, nxt = _halo_rows(worst_l, axis, fill=-1)
        worstp = jnp.concatenate([prev, worst_l, nxt], axis=1)

        r0 = lax.axis_index(axis) * gh_l
        ty = dcy + (direction if axis_sp == 1 else 0)
        tx = dcx + (direction if axis_sp == 0 else 0)
        own = (dcy >= r0) & (dcy < r0 + gh_l)
        tyl = jnp.clip(ty - r0 + 1, 0, gh_l + 1)
        txc = jnp.clip(tx, 0, gw - 1)
        w_idx = worstp[dimg, tyl, txc]
        full = own & (w_idx >= 0)
        worst_ncc = jnp.where(full, ncc[jnp.maximum(w_idx, 0)], 0.0)
        return (
            lax.psum(full.astype(jnp.int32), axis),
            lax.psum(worst_ncc, axis),
        )

    full_i, worst = _gate(grid.slots, table.ncc, donor_img, donor_cy, donor_cx)
    return full_i > 0, worst


def tiled_propagate_round(
    mesh: Mesh,
    scene: Scene,
    table: PatchTable,
    key,
    p: pr.PropagateParams,
    direction: int,
    ncc_threshold,
    ncc_threshold_before,
    use_depth: bool = True,
    quad_threshold=2.5,
    axis: str = "tile",
) -> Tuple[PatchTable, pr.RoundStats]:
    """propagate_round with the cell grids row-sharded over `axis`:
    tile-local grid build, exact merged donor selection, halo-exchanged
    full-cell gate, then the (batch-parallel) gauntlet on the
    re-assembled global grid. Observationally identical to the
    unsharded `propagate_round` under the same key (one shared grid
    build + donor set feeding BOTH spatial target directions, matching
    pipeline/propagate.propagate_round's key-split structure)."""
    key, k1a, k1b, k2 = jax.random.split(key, 4)
    grid_t = tiled_build_grid(
        mesh, scene, table, p.level, p.csize, p.cell_capacity,
        axis=axis,
    )
    table = table._replace(alive=table.alive & ~grid_t.evicted)

    donors = tiled_select_donors(
        mesh, scene, grid_t, table, p.donor_budget, p.level, p.csize,
        axis=axis, policy=p.donor_policy,
    )
    pidx, img, cy, cx, ok0 = donors
    grid = tiled_grid_to_global(scene, grid_t, p.level, p.csize)
    parts = []
    for axis_sp, k1 in ((0, k1a), (1, k1b)):
        gate_full, gate_worst = tiled_full_cell_gate(
            mesh, scene, grid_t, table, img, cy, cx, axis_sp, direction,
            p.level, p.csize, axis=axis,
        )
        parts.append(
            pr.generate_hypotheses(
                scene, table, grid, pidx, img, cy, cx, ok0, axis_sp,
                direction, k1, p,
                gate_full=gate_full, gate_worst_ncc=gate_worst,
            )
        )
    coord, normal, images, _, ok = (
        jnp.concatenate([pt[i] for pt in parts]) for i in range(5)
    )

    out = pr._gauntlet_chunked(
        scene, grid, table, coord, normal, images, ok, k2, p,
        ncc_threshold, ncc_threshold_before, use_depth,
        quad_threshold,
    )
    table = pr.insert_patches(table, out)
    stats = pr.RoundStats(
        total=jnp.sum(ok),
        fail0=jnp.sum(out.fail0),
        fail1=jnp.sum(out.fail1),
        passed=jnp.sum(out.ok),
    )
    return table, stats
