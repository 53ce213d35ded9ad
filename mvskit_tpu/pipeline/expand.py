"""PMVS-style scene-space expansion (the reference's alternative
propagation strategy).

Re-expresses Propagate::propagatePmvs / findEmptyBlocks / expandSub /
checkCounts / updateCounts (reference pmmvps/propagate.cpp:384-691; the
strategy is compiled but not called in the reference's live
configuration, propagate.cpp:47-52): instead of pushing hypotheses into
image-grid neighbor cells, each donor patch spawns candidates at 6
angular sectors on its own tangent plane at radius computeRadius(),
skipping sectors already filled by neighbors, with per-cell effort
counters throttling repeated expansion into the same cells.

The batched redesign processes a donor budget per round (score2-descending,
matching the reference's priority queue order) and carries the effort
counters as a dense [n, gh, gw] array across rounds.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import sampling
from . import filters as fl
from . import propagate as pr
from . import views as vw

N_SECTORS = 6  # reference propagate.cpp:415


class ExpandState(NamedTuple):
    counts: jnp.ndarray  # [n, gh, gw] effort counters (m_counts)


def init_state(scene: Scene, level: int, csize: int) -> ExpandState:
    gw, gh = gridmod.grid_dims(scene, level, csize)
    return ExpandState(
        counts=jnp.zeros((scene.n_images, gh, gw), jnp.int32)
    )


def _ortho4(z):
    return fl._ortho(z)


def find_empty_sectors(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    donor_rows,
    level: int,
    csize: int,
    neighbor_threshold: float,
    max_neighbors: int = 64,
):
    """findEmptyBlocks (reference propagate.cpp:414-472): per donor,
    project its neighbors into the tangent-plane frame, accumulate
    angular fill, and emit one candidate coordinate per empty sector at
    radius computeRadius. Returns (cand_coord[H, 6, 4], empty[H, 6])."""
    coord = table.coord[donor_rows]
    normal = table.normal[donor_rows]
    dscale = table.dscale[donor_rows]
    images = table.images[donor_rows]

    xdir, ydir = _ortho4(normal)
    radius = fl.compute_radius_batch(scene, coord, normal, images, level, csize)
    rlow = radius / 6.0
    rhigh = radius * 2.5

    nbrs, _ = fl.gather_neighbors_batch(
        scene, grid, table, coord, normal, dscale, images, donor_rows,
        level, csize, margin=1, scale=4.0,
        neighbor_threshold=neighbor_threshold, max_neighbors=max_neighbors,
    )
    nok = nbrs >= 0
    diff = table.coord[jnp.maximum(nbrs, 0)] - coord[:, None, :]
    fx = jnp.sum(diff * xdir[:, None, :], axis=-1)
    fy = jnp.sum(diff * ydir[:, None, :], axis=-1)
    ln = jnp.sqrt(jnp.maximum(fx * fx + fy * fy, 1e-20))
    in_annulus = nok & (ln >= rlow[:, None]) & (ln <= rhigh[:, None])

    ang = jnp.arctan2(fy, fx)
    ang = jnp.where(ang < 0.0, ang + 2.0 * math.pi, ang)
    findex = ang / (2.0 * math.pi / N_SECTORS)
    lo = jnp.floor(findex).astype(jnp.int32)
    hi = lo + 1
    w_hi = findex - lo.astype(findex.dtype)
    w_lo = 1.0 - w_hi

    H, K = nbrs.shape
    fill = jnp.zeros((H, N_SECTORS))
    fill = fill.at[
        jnp.arange(H)[:, None], lo % N_SECTORS
    ].add(jnp.where(in_annulus, w_lo, 0.0))
    fill = fill.at[
        jnp.arange(H)[:, None], hi % N_SECTORS
    ].add(jnp.where(in_annulus, w_hi, 0.0))
    empty = fill <= 0.0

    angles = (
        2.0 * math.pi * jnp.arange(N_SECTORS, dtype=jnp.float32) / N_SECTORS
    )
    cand = (
        coord[:, None, :]
        + jnp.cos(angles)[None, :, None] * radius[:, None, None] * xdir[:, None, :]
        + jnp.sin(angles)[None, :, None] * radius[:, None, None] * ydir[:, None, :]
    )
    return cand, empty


def check_counts(
    scene: Scene,
    grid: gridmod.GridState,
    counts,
    coord,
    images,
    level: int,
    csize: int,
    count_threshold,
    min_image_num: int,
    depth: int,
):
    """checkCounts (reference propagate.cpp:558-617): a candidate is
    throttled when too few of its cells are both unoccupied and below
    the effort threshold. Returns pass mask [B]."""
    cx, cy, valid = gridmod.patch_cells(scene, coord, images, level, csize)
    img = jnp.maximum(images, 0)
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]
    cxs = jnp.clip(cx, 0, gw - 1)
    cys = jnp.clip(cy, 0, gh - 1)
    occupied = grid.slots[img, cys, cxs, 0] >= 0
    count_full = counts[img, cys, cxs] >= count_threshold
    full = valid & (occupied | count_full)
    empty = valid & ~occupied & ~count_full
    n_full = jnp.sum(full, axis=1)
    n_empty = jnp.sum(empty, axis=1)
    need = min_image_num if depth <= 1 else min_image_num - 1
    blocked = (n_empty < need) & (n_full != 0)
    return ~blocked


def update_counts(scene, counts, coord, images, vimages, ok, level, csize):
    """updateCounts (reference propagate.cpp:619-691): increment the
    effort counter of every cell an accepted patch lands in."""
    gh, gw = counts.shape[1], counts.shape[2]

    def scatter(counts, lists):
        cx, cy, valid = gridmod.patch_cells(scene, coord, lists, level, csize)
        img = jnp.maximum(lists, 0)
        dest = (img * gh + jnp.clip(cy, 0, gh - 1)) * gw + jnp.clip(
            cx, 0, gw - 1
        )
        use = valid & ok[:, None]
        flat = counts.reshape(-1)
        flat = flat.at[jnp.where(use, dest, counts.size)].add(
            jnp.where(use, 1, 0), mode="drop"
        )
        return flat.reshape(counts.shape)

    counts = scatter(counts, images)
    counts = scatter(counts, vimages)
    return counts


def expand_round(
    scene: Scene,
    table: PatchTable,
    state: ExpandState,
    key,
    p: pr.PropagateParams,
    ncc_threshold,
    ncc_threshold_before,
    count_threshold,
    depth: int,
    use_depth: bool = True,
    quad_threshold=2.5,
) -> Tuple[PatchTable, ExpandState, pr.RoundStats]:
    """One PMVS-style expansion round: donors by score2 priority ->
    empty-sector candidates -> checkCounts throttle -> gauntlet ->
    updateCounts + insertion."""
    grid = gridmod.build_grid(scene, table, p.level, p.csize, p.cell_capacity)
    table = table._replace(alive=table.alive & ~grid.evicted)

    # donor selection: priority = score2 (the reference's queue order,
    # patch_manager.cpp:107-121 with PatchCmp over m_tmp)
    prio = jnp.where(
        table.alive & (count_valid(table.images) > 0),
        fl.score2(table, ncc_threshold),
        -jnp.inf,
    )
    budget = max(p.donor_budget // N_SECTORS, 1)
    _, donor_rows = lax.top_k(prio, budget)
    donor_ok = jnp.take(prio, donor_rows) > -jnp.inf

    cand, empty = find_empty_sectors(
        scene, grid, table, donor_rows, p.level, p.csize,
        p.neighbor_threshold, max_neighbors=max(p.neighbor_capacity, 64),
    )

    H = budget * N_SECTORS
    coord = cand.reshape(H, 4)
    donor_flat = jnp.repeat(donor_rows, N_SECTORS)
    normal = table.normal[donor_flat]
    images0 = table.images[donor_flat]
    ok = (empty & donor_ok[:, None]).reshape(H)

    # setGridsImages: drop views whose cell leaves the grid
    _, _, cell_ok = gridmod.patch_cells(scene, coord, images0, p.level, p.csize)
    images = vw.compact_list(images0, cell_ok)
    ok &= count_valid(images) > 0

    # scene mask gate (expandSub, propagate.cpp:515-517)
    ok &= sampling.scene_mask_ok(scene, coord, p.level)

    # effort throttle
    ok &= check_counts(
        scene, grid, state.counts, coord, images, p.level, p.csize,
        count_threshold, p.min_image_num, depth,
    )

    out = pr._gauntlet_chunked(
        scene, grid, table, coord, normal, images, ok, key, p,
        ncc_threshold, ncc_threshold_before, use_depth, quad_threshold,
    )
    counts = update_counts(
        scene, state.counts, out.coord, out.images, out.vimages, out.ok,
        p.level, p.csize,
    )
    table = pr.insert_patches(table, out)
    stats = pr.RoundStats(
        total=jnp.sum(ok),
        fail0=jnp.sum(out.fail0),
        fail1=jnp.sum(out.fail1),
        passed=jnp.sum(out.ok),
    )
    return table, ExpandState(counts), stats
