"""Outlier filtering as dense array passes.

Re-expresses the reference filter stage (reference pmmvps/filter.cpp):

  * filterOutside — per-patch gain = score2 minus the max "pressure"
    (ncc - tau) of non-neighbor co-cell patches per visible view, plus
    the occluding-view variant over vimages (filter.cpp:51-146);
  * filterExact  — per (patch, view) visibility against the z-buffer in
    the cell or its 4-neighborhood; views that fail are dropped, patches
    falling under minImageNum die (filter.cpp:148-263);
  * filterNeighbor + filterQuad — scene-space neighbor count gate and a
    batched least-squares quadric residual test (filter.cpp:265-430);
  * filterSmallGroups — connected components under isNeighbor via
    min-label propagation with path halving, replacing the serial BFS
    (filter.cpp:432-578).

The geometric neighbor predicates come from the driver (reference
pmmvps.cpp:117-180); the degree/radian swap bug at pmmvps.cpp:124 is
fixed here (cos(120 deg) = -0.5, the corrected form the reference
itself uses at :150) — see DIVERGENCES.md.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..pipeline import views as vw

INF = float(1e30)
COS120 = -0.5


def _ref_unit(scene: Scene, table: PatchTable, idx, level: int):
    """getUnit(patch.images[0], patch.coord) for patch rows `idx`."""
    ref = jnp.maximum(table.images[idx, 0], 0)
    return cam.get_unit(scene.cams, ref, table.coord[idx], level)


def score2(table: PatchTable, ncc_threshold):
    """Patch::score2 (reference patch.cpp:27-29)."""
    return jnp.maximum(0.0, table.ncc - ncc_threshold) * count_valid(
        table.images
    ).astype(jnp.float32)


def is_neighbor_pairs(
    scene: Scene,
    table: PatchTable,
    a_idx,
    b_idx,
    hunit,
    threshold,
    radius=None,
):
    """isNeighbor / isNeighborRadius (reference pmmvps.cpp:117-180) for
    index pairs. All args broadcast; returns bool."""
    na = table.normal[a_idx]
    nb = table.normal[b_idx]
    ndot = jnp.sum(na * nb, axis=-1)

    diff = table.coord[a_idx] - table.coord[b_idx]
    vunit = table.dscale[a_idx] + table.dscale[b_idx]
    vunit = jnp.where(vunit == 0.0, 1e-6, vunit)
    f0 = jnp.sum(na * diff, axis=-1)
    f1 = jnp.sum(nb * diff, axis=-1)
    ftmp = (jnp.abs(f0) + jnp.abs(f1)) / 2.0 / vunit

    hvec = (diff - f0[..., None] * na) + (diff - f1[..., None] * nb)
    hsize = jnp.sqrt(jnp.maximum(jnp.sum(hvec * hvec, axis=-1), 0.0)) / 2.0 / hunit

    ftmp = jnp.where(hsize > 1.0, ftmp / jnp.minimum(2.0, hsize), ftmp)
    ok = (ndot >= COS120) & (ftmp < threshold)
    if radius is not None:
        ok &= hsize <= radius / hunit
    return ok


def _cell_coords(scene: Scene, coord, lists, level: int, csize: int):
    cx, cy, valid = gridmod.patch_cells(scene, coord, lists, level, csize)
    return cx, cy, valid


# ----------------------------------------------------------------------
# filterOutside
# ----------------------------------------------------------------------

def gain_batch(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    coord,
    normal,
    dscale,
    ncc,
    images,
    vimages,
    self_rows,
    level: int,
    csize: int,
    ncc_threshold,
    neighbor_threshold1,
) -> jnp.ndarray:
    """Filter::computeGain for an arbitrary batch of patches
    (filter.cpp:108-146). `self_rows` [B] gives the table row of each
    batch entry (so a patch never presses on itself); pass -1 rows for
    hypotheses not in the table (reference Optim::check runs the same
    gain on not-yet-inserted patches, optim.cpp:300-309)."""
    B = coord.shape[0]
    nimg = count_valid(images).astype(jnp.float32)
    gains = jnp.maximum(0.0, ncc - ncc_threshold) * nimg

    ref = jnp.maximum(images[:, 0], 0)
    self_unit = cam.get_unit(scene.cams, ref, coord, level)

    def pressure_over(lists, slots, need_depth_gate):
        cx, cy, valid = _cell_coords(scene, coord, lists, level, csize)
        img = jnp.maximum(lists, 0)
        cxs = jnp.clip(cx, 0, grid.slots.shape[2] - 1)
        cys = jnp.clip(cy, 0, grid.slots.shape[1] - 1)
        cell = slots[img, cys, cxs]          # [B, M, S]
        occupied = cell >= 0
        cidx = jnp.maximum(cell, 0)

        hunit = (
            (
                self_unit[:, None, None]
                + _ref_unit(scene, table, cidx, level)
            )
            / 2.0
            * csize
        )
        nb = _is_neighbor_vs_table(
            scene, table, coord, normal, dscale, cidx, hunit,
            neighbor_threshold1,
        )
        press = table.ncc[cidx] - ncc_threshold
        use = (
            occupied
            & valid[..., None]
            & ~nb
            & (cidx != self_rows[:, None, None])
        )
        if need_depth_gate:
            # only co-cell patches BEHIND this patch press on it
            # (filter.cpp:136-141)
            pdepth = jnp.einsum(
                "bmc,bc->bm", scene.cams.oaxis[img], coord,
                precision=lax.Precision.HIGHEST,
            )[..., None]
            # channel-leading gather (no length-4 minor axis; see
            # _is_neighbor_vs_table)
            oax = scene.cams.oaxis[img]  # [B, M, 4]
            coord_t = table.coord.T
            bdepth = sum(
                oax[:, :, None, c] * coord_t[c][cidx] for c in range(4)
            )
            use = use & (pdepth < bdepth)
        maxp = jnp.max(
            jnp.where(use, press, 0.0), axis=2, initial=0.0
        )  # [B, M]
        return jnp.sum(jnp.where(valid, maxp, 0.0), axis=1)

    gains = gains - pressure_over(images, grid.slots, False)
    gains = gains - pressure_over(vimages, grid.slots, True)
    return gains


def _is_neighbor_vs_table(
    scene, table, coord, normal, dscale, b_idx, hunit, threshold,
    radius=None,
):
    """isNeighbor between explicit self patches (broadcast over b_idx's
    trailing dims) and table rows b_idx.

    Gathers are CHANNEL-LEADING: table coords/normals are fetched one
    component at a time from [4, N] transposes so no gathered temp ends
    in a length-4 minor axis (the layout choice is re-measured under
    ROADMAP C4)."""
    expand = (slice(None),) + (None,) * (b_idx.ndim - 1)
    ds = dscale[expand]
    coord_t = table.coord.T  # [4, N]
    normal_t = table.normal.T

    ndot = 0.0
    f0 = 0.0
    f1 = 0.0
    na_c, nb_c, d_c = [], [], []
    for c in range(4):
        na = normal[..., c][expand]
        nb = normal_t[c][b_idx]
        d = coord[..., c][expand] - coord_t[c][b_idx]
        ndot = ndot + na * nb
        f0 = f0 + na * d
        f1 = f1 + nb * d
        na_c.append(na)
        nb_c.append(nb)
        d_c.append(d)

    vunit = ds + table.dscale[b_idx]
    vunit = jnp.where(vunit == 0.0, 1e-6, vunit)
    ftmp = (jnp.abs(f0) + jnp.abs(f1)) / 2.0 / vunit

    h2 = 0.0
    for c in range(4):
        hv = (d_c[c] - f0 * na_c[c]) + (d_c[c] - f1 * nb_c[c])
        h2 = h2 + hv * hv
    hsize = jnp.sqrt(jnp.maximum(h2, 0.0)) / 2.0 / hunit
    ftmp = jnp.where(hsize > 1.0, ftmp / jnp.minimum(2.0, hsize), ftmp)
    ok = (ndot >= COS120) & (ftmp < threshold)
    if radius is not None:
        ok &= hsize <= radius / hunit
    return ok


def compute_gains(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    level: int,
    csize: int,
    ncc_threshold,
    neighbor_threshold1,
    chunk: int = 1024,
    row_limit=None,
) -> jnp.ndarray:
    """Filter::computeGain for every table row (filter.cpp:108-146).

    Chunked over rows: gain_batch gathers [B, n_views, S, 4] pressed
    coordinates, which unchunked at production capacity (2^18 rows x
    16 views x 16 slots) is a multi-GB temporary. `row_limit` bounds the rows scanned
    (compacted-table invariant, core/grid._fill_slots); rows beyond it
    return gain 0."""
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)
    C = min(chunk, N)
    nch = (N + C - 1) // C
    rows = jnp.arange(nch * C, dtype=jnp.int32).reshape(nch, C)

    def one(rs):
        rs = jnp.minimum(rs, N - 1)
        return gain_batch(
            scene, grid, table,
            table.coord[rs], table.normal[rs], table.dscale[rs],
            table.ncc[rs], table.images[rs], table.vimages[rs],
            rs, level, csize, ncc_threshold, neighbor_threshold1,
        )

    out = lax.map(one, rows).reshape(-1)[:N]
    if N < cap:
        out = jnp.concatenate([out, jnp.zeros((cap - N,), out.dtype)])
    return out


def filter_outside(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    level: int,
    csize: int,
    ncc_threshold,
    neighbor_threshold1,
    row_limit=None,
) -> Tuple[PatchTable, jnp.ndarray]:
    """Remove patches with negative gain (filter.cpp:51-97)."""
    gains = compute_gains(
        scene, grid, table, level, csize, ncc_threshold,
        neighbor_threshold1, row_limit=row_limit,
    )
    kill = table.alive & (gains < 0.0)
    return table._replace(alive=table.alive & ~kill), jnp.sum(kill)


# ----------------------------------------------------------------------
# filterExact
# ----------------------------------------------------------------------

def filter_exact(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    level: int,
    csize: int,
    wsize: int,
    min_image_num: int,
    neighbor_threshold1,
    angle_threshold1: float,
    use_depth: bool = True,
    row_limit=None,
) -> Tuple[PatchTable, jnp.ndarray]:
    """Per-(patch, view) exact visibility (filter.cpp:148-263): a view
    survives if the patch passes isVisible in its cell or any 4-neighbor
    cell; patches under minImageNum die. Survivors re-pick their
    reference view (setRefImage)."""
    cap, M = table.images.shape
    N = cap if row_limit is None else min(row_limit, cap)
    # chunked over rows: the visibility and setRefImage inner arrays
    # ([rows, M, 3, 4] projections, [rows, M, M] pairwise INCCs, window
    # textures) are multi-GB at full production capacity
    CH = min(8192, N)
    nch = (N + CH - 1) // CH
    rows_all = (jnp.arange(nch * CH, dtype=jnp.int32) % N).reshape(
        nch, CH
    )

    def one(rs):
        coord = table.coord[rs]
        normal = table.normal[rs]
        images = table.images[rs]
        cx, cy, valid = _cell_coords(scene, coord, images, level, csize)

        def vis_at(dx, dy):
            return gridmod.is_visible(
                scene, grid, table,
                coord[:, None, :], normal[:, None, :],
                jnp.maximum(images, 0), cx + dx, cy + dy,
                neighbor_threshold1, level, csize, use_depth,
            )

        safe = (
            vis_at(0, 0) | vis_at(-1, 0) | vis_at(1, 0)
            | vis_at(0, -1) | vis_at(0, 1)
        )
        keep = valid & safe

        new_images = vw.compact_list(images, keep)
        enough = count_valid(new_images) >= min_image_num
        new_images = vw.set_ref_image(
            scene, coord, normal, new_images, level, wsize,
            angle_threshold1,
        )
        new_images = jnp.where(enough[:, None], new_images, -1)
        return new_images, enough

    new_images, enough = lax.map(one, rows_all)
    new_images = new_images.reshape(nch * CH, M)[:N]
    enough = enough.reshape(-1)[:N]
    if N < cap:
        new_images = jnp.concatenate(
            [new_images, jnp.full((cap - N, M), -1, new_images.dtype)]
        )
        enough = jnp.concatenate(
            [enough, jnp.zeros((cap - N,), enough.dtype)]
        )
    killed = table.alive & ~enough
    return (
        table._replace(
            images=jnp.where(table.alive[:, None], new_images, table.images),
            alive=table.alive & enough,
        ),
        jnp.sum(killed),
    )


# ----------------------------------------------------------------------
# neighbor gathering (findNeighbors) + filterNeighbor/filterQuad
# ----------------------------------------------------------------------

def compute_radius_batch(scene: Scene, coord, normal, images, level: int, csize: int):
    """Propagate::computeRadius (reference propagate.cpp:474-481):
    second-smallest per-view unit times csize."""
    from ..ops.ncc import compute_units

    units = compute_units(scene, images, coord, normal, level)
    two = -lax.top_k(-units, 2)[0]  # two smallest
    return two[:, 1] * csize


def compute_radius(scene: Scene, table: PatchTable, level: int, csize: int):
    return compute_radius_batch(
        scene, table.coord, table.normal, table.images, level, csize
    )


def gather_neighbors(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    rows,
    level: int,
    csize: int,
    margin: int,
    scale: float,
    neighbor_threshold,
    max_neighbors: int,
    cand_cap: int = 1024,
):
    """findNeighbors (reference patch_manager.cpp:671-728) for patch
    rows `rows` [B]: candidates from (2*margin+1)^2 cells around the
    patch in every view of its images list, over both pgrids and
    vpgrids, gated by isNeighborRadius, deduplicated, first
    `max_neighbors` returned. Returns (nbrs[B, K] i32 -1-pad, count[B]
    total distinct BEFORE capping)."""
    return gather_neighbors_batch(
        scene, grid, table,
        table.coord[rows], table.normal[rows], table.dscale[rows],
        table.images[rows], rows,
        level, csize, margin, scale, neighbor_threshold, max_neighbors,
        cand_cap,
    )


def gather_neighbors_batch(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    coord,
    normal,
    dscale,
    lists,
    self_rows,
    level: int,
    csize: int,
    margin: int,
    scale: float,
    neighbor_threshold,
    max_neighbors: int,
    cand_cap: int = 1024,
):
    """findNeighbors for explicit self-patch attributes (the in-gauntlet
    check runs it on hypotheses not yet in the table)."""
    B = coord.shape[0]
    N, M = table.images.shape
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]

    cx, cy, valid = _cell_coords(scene, coord, lists, level, csize)

    radius = 1.5 * margin * compute_radius_batch(
        scene, coord, normal, lists, level, csize
    )
    # mean unit over images * csize (patch_manager.cpp:675-680)
    idx = jnp.maximum(lists, 0)
    units = cam.get_unit(scene.cams, idx, coord[:, None, :], level)
    nimg = jnp.maximum(count_valid(lists), 1)
    hunit = (
        jnp.sum(jnp.where(lists >= 0, units, 0.0), axis=1) / nimg * csize
    )

    offs = [(dy, dx) for dy in range(-margin, margin + 1)
            for dx in range(-margin, margin + 1)]
    cands = []
    for (dy, dx) in offs:
        ty = cy + dy
        tx = cx + dx
        inb = valid & (ty >= 0) & (ty < gh) & (tx >= 0) & (tx < gw)
        tyc = jnp.clip(ty, 0, gh - 1)
        txc = jnp.clip(tx, 0, gw - 1)
        img = jnp.maximum(lists, 0)
        c1 = jnp.where(inb[..., None], grid.slots[img, tyc, txc], -1)
        c2 = jnp.where(inb[..., None], grid.vslots[img, tyc, txc], -1)
        cands.append(c1.reshape(B, -1))
        cands.append(c2.reshape(B, -1))
    cand = jnp.concatenate(cands, axis=1)  # [B, Kc]
    Kc = cand.shape[1]

    # Compact + dedup FIRST, then test. ~85% of the Kc slot columns
    # are empty at production occupancy (~1.1 patches/cell) and each
    # real neighbor repeats once per (image x overlapping cell), so
    # running the geometric test on all Kc columns wastes ~6x table-
    # gather volume — measured 2.35 s per 4096-hypothesis chunk, 99%
    # of the depth>=2 in-gauntlet check (PERF.md round-3 breakdown).
    # The test depends only on the candidate's table row, so dedup
    # before/after it is equivalence-preserving. cand_cap bounds the
    # DISTINCT candidates tested (config.neighbor_cand_cap): at
    # production occupancy (~1.6 pairs/cell) the 25-cell x 2-grid
    # neighborhood holds ~100 distinct patches, so a few hundred is
    # ample; the post-cap test cost scales linearly with it.
    cand_cap = min(cand_cap, Kc)
    vals = jnp.where(cand >= 0, cand, N)
    svals = jnp.sort(vals, axis=1)
    uniq = jnp.concatenate(
        [jnp.ones((B, 1), bool), svals[:, 1:] != svals[:, :-1]], axis=1
    ) & (svals < N)
    # scatter-compact the unique ids to the front (rank = their index)
    rank = jnp.cumsum(uniq, axis=1) - 1
    rows = jnp.broadcast_to(
        jnp.arange(B, dtype=jnp.int32)[:, None], (B, Kc)
    )
    dest = jnp.where(uniq & (rank < cand_cap), rank, cand_cap)
    ucand = (
        jnp.full((B, cand_cap + 1), N, jnp.int32)
        .at[rows, dest]
        .set(svals)[:, :cand_cap]
    )

    cidx = jnp.minimum(ucand, N - 1)
    ok = (ucand < N) & table.alive[cidx] & (cidx != self_rows[:, None])
    nb = _is_neighbor_vs_table(
        scene, table, coord, normal, dscale, cidx,
        hunit[:, None], neighbor_threshold * scale, radius[:, None],
    )
    ok &= nb

    count = jnp.sum(ok, axis=1)
    vals2 = jnp.where(ok, cidx, N)  # already distinct per row
    sv2 = jnp.sort(vals2, axis=1)[:, :max_neighbors]
    nbrs = jnp.where(sv2 < N, sv2, -1).astype(jnp.int32)
    return nbrs, count


def _ortho(z):
    """Plane basis (reference filter.cpp:394-409 / propagate.cpp:483-498)."""
    ax = jnp.abs(z[..., 0])
    ay = jnp.abs(z[..., 1])
    zeros = jnp.zeros_like(z[..., 0])
    x_a = jnp.stack([z[..., 1], -z[..., 0], zeros, zeros], axis=-1)
    x_b = jnp.stack([zeros, z[..., 2], -z[..., 1], zeros], axis=-1)
    x_c = jnp.stack([-z[..., 2], zeros, z[..., 0], zeros], axis=-1)
    x = jnp.where(
        (ax > 0.5)[..., None],
        x_a,
        jnp.where((ay > 0.5)[..., None], x_b, x_c),
    )
    x = x / jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), 1e-20))
    z3 = z[..., :3]
    x3 = x[..., :3]
    y3 = jnp.cross(z3, x3)
    y = jnp.concatenate([y3, jnp.zeros_like(z[..., :1])], axis=-1)
    return x, y


def quad_residuals(scene, table, rows, nbrs, level, tau):
    return quad_residuals_batch(
        scene, table, table.coord[rows], table.normal[rows],
        table.images[rows], nbrs, level, tau,
    )


def quad_residuals_batch(
    scene: Scene,
    table: PatchTable,
    coord,
    normal,
    images,
    nbrs,
    level: int,
    tau: int,
):
    """Filter::filterQuad residual (reference filter.cpp:329-392):
    fit z = f(x, y) quadric over the neighbors in the patch plane frame
    and return the mean |residual| / unit, normalized by (nsize - 5).
    Masked least squares via 5x5 normal equations."""
    B, K = nbrs.shape
    xdir, ydir = _ortho(normal)

    nok = nbrs >= 0
    nidx = jnp.maximum(nbrs, 0)
    # channel-leading gather of the neighbor coordinates (same layout
    # as _is_neighbor_vs_table)
    coord_t = table.coord.T  # [4, N]
    d2 = 0.0
    fxs = 0.0
    fys = 0.0
    fzs = 0.0
    for c in range(4):
        dc = coord_t[c][nidx] - coord[:, None, c]
        d2 = d2 + dc * dc
        fxs = fxs + dc * xdir[:, None, c]
        fys = fys + dc * ydir[:, None, c]
        fzs = fzs + dc * normal[:, None, c]
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    cnt = jnp.maximum(jnp.sum(nok, axis=1), 1)
    h = jnp.sum(jnp.where(nok, dist, 0.0), axis=1) / cnt
    h = jnp.where(h == 0.0, 1.0, h)

    fxs = fxs / h[:, None]
    fys = fys / h[:, None]

    A = jnp.stack([fxs * fxs, fys * fys, fxs * fys, fxs, fys], axis=-1)
    Aw = jnp.where(nok[..., None], A, 0.0)
    bw = jnp.where(nok, fzs, 0.0)
    hi = lax.Precision.HIGHEST
    AtA = jnp.einsum("bki,bkj->bij", Aw, Aw, precision=hi)
    AtA = AtA + 1e-8 * jnp.eye(5)[None]
    Atb = jnp.einsum("bki,bk->bi", Aw, bw, precision=hi)
    x = jnp.linalg.solve(AtA, Atb[..., None])[..., 0]

    # unit = mean getUnit over the first min(tau, |images|) views
    # (filter.cpp:368-374)
    lists = images[:, :tau]
    idx = jnp.maximum(lists, 0)
    units = cam.get_unit(scene.cams, idx, coord[:, None, :], level)
    ucnt = jnp.maximum(jnp.sum(lists >= 0, axis=1), 1)
    unit = jnp.sum(jnp.where(lists >= 0, units, 0.0), axis=1) / ucnt
    unit = jnp.where(unit == 0.0, 1.0, unit)

    pred = jnp.einsum("bki,bi->bk", A, x, precision=hi)
    res = jnp.abs(pred - fzs) / unit[:, None]
    total = jnp.sum(jnp.where(nok, res, 0.0), axis=1)
    denom = jnp.sum(nok, axis=1) - 5
    return total / jnp.maximum(denom, 1), denom


def filter_neighbor_rows(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    row_offset,
    row_count: int,
    level: int,
    csize: int,
    tau: int,
    quad_threshold,
    neighbor_threshold,
    max_neighbors: int = 48,
    chunk: int = 1024,
    cand_cap: int = 1024,
) -> Tuple[PatchTable, jnp.ndarray]:
    """filterNeighbor over rows [row_offset, row_offset+row_count) —
    the driver dispatches the table in segments, which bounds each
    program's temporaries (ROADMAP A5 revisits the split)."""
    N = table.capacity
    n_chunks = (row_count + chunk - 1) // chunk
    rows_all = (
        row_offset + jnp.arange(n_chunks * chunk, dtype=jnp.int32)
    ) % N
    rows_all = rows_all.reshape(n_chunks, chunk)

    def one(rows):
        nbrs, count = gather_neighbors(
            scene, grid, table, rows, level, csize,
            margin=2, scale=4.0, neighbor_threshold=neighbor_threshold,
            max_neighbors=max_neighbors, cand_cap=cand_cap,
        )
        resid, denom = quad_residuals(scene, table, rows, nbrs, level, tau)
        reject = (count < 6) | ((denom >= 1) & (resid >= quad_threshold))
        return reject

    rejects = lax.map(one, rows_all).reshape(-1)[:row_count]
    rows = (row_offset + jnp.arange(row_count, dtype=jnp.int32)) % N
    kill = table.alive[rows] & rejects
    alive = table.alive.at[rows].set(table.alive[rows] & ~rejects)
    return table._replace(alive=alive), jnp.sum(kill)


def filter_neighbor(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    level: int,
    csize: int,
    tau: int,
    quad_threshold,
    neighbor_threshold,
    max_neighbors: int = 48,
    chunk: int = 1024,
    cand_cap: int = 1024,
) -> Tuple[PatchTable, jnp.ndarray]:
    """filterNeighbor (filter.cpp:265-327): fewer than 6 scene-space
    neighbors, or a too-large quadric residual, kills the patch."""
    return filter_neighbor_rows(
        scene, grid, table, jnp.int32(0), table.capacity,
        level, csize, tau, quad_threshold, neighbor_threshold,
        max_neighbors, chunk, cand_cap,
    )


# ----------------------------------------------------------------------
# filterSmallGroups
# ----------------------------------------------------------------------

def filter_small_groups(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    level: int,
    csize: int,
    neighbor_threshold2,
    iters: int = 32,
    row_limit=None,
) -> Tuple[PatchTable, jnp.ndarray]:
    """filterSmallGroups (filter.cpp:432-578): connected components
    under isNeighbor over the reference-view 3x3 cell graph; components
    smaller than max(20, alive/10000) are removed. BFS becomes
    min-label propagation with path halving (pointer jumping), so
    convergence is exponential in `iters`. `row_limit` bounds the rows
    scanned (compacted-table invariant)."""
    cap, M = table.images.shape
    N = cap if row_limit is None else min(row_limit, cap)
    gh, gw = grid.slots.shape[1], grid.slots.shape[2]

    ref_list = table.images[:N, :1]
    cx, cy, valid = _cell_coords(
        scene, table.coord[:N], ref_list, level, csize
    )
    cx, cy, valid = cx[:, 0], cy[:, 0], valid[:, 0]
    img = jnp.maximum(table.images[:N, 0], 0)

    cands = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ty, tx = cy + dy, cx + dx
            inb = valid & (ty >= 0) & (ty < gh) & (tx >= 0) & (tx < gw)
            tyc = jnp.clip(ty, 0, gh - 1)
            txc = jnp.clip(tx, 0, gw - 1)
            cands.append(jnp.where(inb[:, None], grid.slots[img, tyc, txc], -1))
            cands.append(jnp.where(inb[:, None], grid.vslots[img, tyc, txc], -1))
    cand = jnp.concatenate(cands, axis=1)  # [N, Kc]

    # grid slots only reference alive rows, which the compacted-table
    # invariant puts below N; clip defensively for the label gather
    cidx = jnp.clip(cand, 0, N - 1)
    me = jnp.arange(N, dtype=jnp.int32)
    ref_unit_all = _ref_unit(scene, table, me, level)  # [N]

    # edge construction gathers [rows, Kc, 4] neighbor coordinates;
    # chunk over rows to bound that temporary at full capacity.
    Kc = cand.shape[1]
    CH = min(2048, N)
    nch = (N + CH - 1) // CH
    rows_all = (jnp.arange(nch * CH, dtype=jnp.int32) % N).reshape(
        nch, CH
    )

    def edge_of(rs):
        cidx_c = cidx[rs]
        hunit_c = (
            (ref_unit_all[rs][:, None] + ref_unit_all[cidx_c])
            / 2.0
            * csize
        )
        return (
            (cand[rs] >= 0)
            & table.alive[cidx_c]
            & table.alive[rs][:, None]
            & is_neighbor_pairs(
                scene, table, rs[:, None], cidx_c, hunit_c,
                neighbor_threshold2,
            )
        )

    edge = lax.map(edge_of, rows_all).reshape(nch * CH, Kc)[:N]

    label = jnp.where(table.alive[:N], me, N)

    def body(_, label):
        nl = jnp.min(
            jnp.where(edge, label[cidx], N), axis=1, initial=N
        )
        label = jnp.minimum(label, nl)
        # path halving: label <- label[label]
        label = jnp.minimum(label, jnp.where(label < N, label.at[jnp.clip(label, 0, N - 1)].get(mode="clip"), N))
        return label

    label = lax.fori_loop(0, iters, body, label)

    sizes = jnp.zeros((N + 1,), jnp.int32).at[jnp.clip(label, 0, N)].add(
        jnp.where(table.alive[:N], 1, 0)
    )
    psize = jnp.sum(table.alive)
    threshold = jnp.maximum(20, psize // 10000)
    small = sizes[jnp.clip(label, 0, N)] < threshold
    if N < cap:
        small = jnp.concatenate([small, jnp.zeros((cap - N,), bool)])
    kill = table.alive & small
    return table._replace(alive=table.alive & ~kill), jnp.sum(kill)


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------

class FilterStats(NamedTuple):
    outside: jnp.ndarray
    exact: jnp.ndarray
    neighbor: jnp.ndarray
    groups: jnp.ndarray


def rebuild(
    scene: Scene,
    table: PatchTable,
    level: int,
    csize: int,
    capacity: int,
    neighbor_threshold,
    additive: bool,
    use_depth: bool = True,
    row_limit=None,
) -> Tuple[PatchTable, gridmod.GridState]:
    """setDepthMapsVGridsVPGridsAddPatchV (filter.cpp:628-655): rebuild
    depth maps, (re)derive vimages (cleared first when additive=0), and
    rebuild the v-grids."""
    if not additive:
        table = table._replace(vimages=jnp.full_like(table.vimages, -1))
    grid = gridmod.build_grid(
        scene, table, level, csize, capacity, row_limit=row_limit
    )
    vimages = gridmod.set_vimages(
        scene, grid, table, level, csize, neighbor_threshold, use_depth,
        row_limit=row_limit,
    )
    table = table._replace(vimages=vimages)
    grid = gridmod.build_grid(
        scene, table, level, csize, capacity, row_limit=row_limit
    )
    return table, grid


def run_filters(
    scene: Scene,
    table: PatchTable,
    *,
    level: int,
    csize: int,
    wsize: int,
    tau: int,
    min_image_num: int,
    cell_capacity: int,
    ncc_threshold,
    quad_threshold,
    neighbor_threshold,
    neighbor_threshold1,
    neighbor_threshold2,
    angle_threshold1: float,
    neighbor_chunk: int = 1024,
) -> Tuple[PatchTable, FilterStats]:
    """Filter::run (reference filter.cpp:25-49)."""
    table, grid = rebuild(
        scene, table, level, csize, cell_capacity, neighbor_threshold,
        additive=False,
    )
    table, n_out = filter_outside(
        scene, grid, table, level, csize, ncc_threshold, neighbor_threshold1
    )

    table, grid = rebuild(
        scene, table, level, csize, cell_capacity, neighbor_threshold,
        additive=True,
    )
    table, n_exact = filter_exact(
        scene, grid, table, level, csize, wsize, min_image_num,
        neighbor_threshold1, angle_threshold1,
    )

    table, grid = rebuild(
        scene, table, level, csize, cell_capacity, neighbor_threshold,
        additive=True,
    )
    table, n_nb = filter_neighbor(
        scene, grid, table, level, csize, tau, quad_threshold,
        neighbor_threshold, chunk=neighbor_chunk,
    )

    table, grid = rebuild(
        scene, table, level, csize, cell_capacity, neighbor_threshold,
        additive=True,
    )
    table, n_grp = filter_small_groups(
        scene, grid, table, level, csize, neighbor_threshold2
    )

    table, _ = rebuild(
        scene, table, level, csize, cell_capacity, neighbor_threshold,
        additive=True,
    )
    return table, FilterStats(n_out, n_exact, n_nb, n_grp)


# ----------------------------------------------------------------------
# in-gauntlet check (depth >= 2)
# ----------------------------------------------------------------------

def check_batch(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    coord,
    normal,
    dscale,
    ncc,
    images,
    vimages,
    *,
    level: int,
    csize: int,
    tau: int,
    ncc_threshold,
    quad_threshold,
    neighbor_threshold,
    neighbor_threshold1,
    max_neighbors: int = 48,
    cand_cap: int = 1024,
):
    """Optim::check (reference optim.cpp:300-323), run on hypothesis
    batches during propagation once depth >= 2: reject when the
    occlusion gain is negative, or when >6 scene-space neighbors exist
    and the quadric residual is too large. Returns reject mask [B]."""
    B = coord.shape[0]
    no_rows = jnp.full((B,), -1, jnp.int32)
    gains = gain_batch(
        scene, grid, table, coord, normal, dscale, ncc, images, vimages,
        no_rows, level, csize, ncc_threshold, neighbor_threshold1,
    )
    reject = gains < 0.0

    nbrs, count = gather_neighbors_batch(
        scene, grid, table, coord, normal, dscale, images, no_rows,
        level, csize, margin=2, scale=4.0,
        neighbor_threshold=neighbor_threshold,
        max_neighbors=max_neighbors, cand_cap=cand_cap,
    )
    resid, denom = quad_residuals_batch(
        scene, table, coord, normal, images, nbrs, level, tau
    )
    reject |= (count > 6) & (denom >= 1) & (resid >= quad_threshold)
    return reject
