"""Dense cell-grid spatial index (the reference's PatchManager).

The reference maintains mutable per-image cell vectors of patch
pointers (reference pmmvps/patch_manager.{hpp,cpp}: m_pgrids/m_vpgrids/
m_dpgrids, incrementally mutated by addPatch/removePatch). Here the
index is instead *rebuilt* as a deterministic dense pass over the patch
table:

  * slots  [n, gh, gw, S]  — per-cell patch indices sorted by NCC
    descending, capacity S = 2*csize^2 (reference propagate.cpp:25);
    built with a stable two-key sort (ncc desc, then cell key) and a
    segmented rank, replacing the O(k^2) bubble sort + eviction
    (patch_manager.cpp:406-433, propagate.cpp:88-99).
  * depth/depth_idx [n, gh, gw] — z-buffer of the front-most patch per
    cell via scatter-min (replacing updateDepthMaps / setDepthMaps,
    patch_manager.cpp:191-221, filter.cpp:580-626).
  * vslots — same as slots but over the `vimages` lists.

Patches evicted from any over-capacity cell are reported so the caller
can kill them globally, matching removePatch semantics in the
propagation cap enforcement (propagate.cpp:94-98).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam
from ..image.scene import Scene
from .patches import PatchTable

INF = float(1e30)


def grid_dims(scene: Scene, level: int, csize: int) -> Tuple[int, int]:
    """(gw, gh) — reference patch_manager.cpp:36-37 (ceil division)."""
    w = scene.width(level)
    h = scene.height(level)
    return (w + csize - 1) // csize, (h + csize - 1) // csize


class GridState(NamedTuple):
    slots: jnp.ndarray       # [n, gh, gw, S] i32, -1 empty, ncc desc
    vslots: jnp.ndarray      # [n, gh, gw, Sv] i32
    depth: jnp.ndarray       # [n, gh, gw] f32 (INF empty)
    depth_idx: jnp.ndarray   # [n, gh, gw] i32 (-1 empty)
    evicted: jnp.ndarray     # [N] bool — dropped from an over-full cell

    @property
    def capacity(self) -> int:
        return self.slots.shape[-1]


def patch_cells(
    scene: Scene, coord, lists, level: int, csize: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cell coordinates of each (patch, view-list entry) pair.

    Mirrors setGridsImages (reference patch_manager.cpp:223-239):
    ix = floor(px + 0.5) // csize, pairs projecting outside the grid are
    invalid. Returns (cx[N, M], cy[N, M], valid[N, M])."""
    gw, gh = grid_dims(scene, level, csize)
    idx = jnp.maximum(lists, 0)
    # dense-matmul projection + one-hot view select instead of a
    # per-pair gather of P[idx] f32[N, M, 3, 4] (camera.project_xy_lists;
    # whether the direct gather is cheaper on the GPU is ROADMAP C4)
    px, py, pvalid = cam.project_xy_lists(scene.cams, idx, coord, level)
    ix = jnp.floor(px + 0.5).astype(jnp.int32) // csize
    iy = jnp.floor(py + 0.5).astype(jnp.int32) // csize
    valid = (
        (lists >= 0)
        & pvalid
        & (ix >= 0)
        & (ix < gw)
        & (iy >= 0)
        & (iy < gh)
    )
    return ix, iy, valid


def _fill_slots(
    scene: Scene,
    table: PatchTable,
    lists: jnp.ndarray,
    level: int,
    csize: int,
    capacity: int,
    row_start=0,
    row_count: Optional[int] = None,
    row_limit: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Segmented per-cell top-K by NCC over (patch, list-entry) pairs.

    `row_start`/`row_count` restrict the build to a window of cell rows
    (the map-block tile of one shard, SURVEY.md §7.7): pairs landing
    outside the window are dropped and the returned slots cover only
    the window's rows. Because cells are disjoint and the two-key sort
    is stable, the per-cell content is identical to the corresponding
    rows of a full build. row_start may be a traced scalar (it only
    enters key arithmetic); row_count must be static.

    `row_limit` (static) declares that every alive TABLE row index is
    < row_limit (the compacted-table invariant, core/patches.
    compact_table): the pair sort then runs over row_limit*M pairs
    instead of capacity*M — at production occupancy a ~4x cut of the
    grid build, which is 24% of a propagation round (PROP_PARTS.json).
    The result is identical because dead rows contribute nothing.

    Returns (slots[n, row_count, gw, capacity], evicted[N])."""
    n = scene.n_images
    gw, gh = grid_dims(scene, level, csize)
    if row_count is None:
        row_count = gh
    N = table.capacity
    R = N if row_limit is None else min(row_limit, N)
    lists = lists[:R]
    M = lists.shape[1]

    cx, cy, valid = patch_cells(
        scene, table.coord[:R], lists, level, csize
    )
    valid = valid & table.alive[:R, None]
    cy = cy - row_start
    valid = valid & (cy >= 0) & (cy < row_count)
    img = jnp.maximum(lists, 0)
    key = (img * row_count + cy) * gw + cx
    nkeys = n * row_count * gw
    key = jnp.where(valid, key, nkeys)  # invalid -> sentinel bucket

    flat_key = key.reshape(-1)
    flat_ncc = jnp.broadcast_to(table.ncc[:R, None], (R, M)).reshape(-1)
    flat_pidx = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[:, None], (R, M)
    ).reshape(-1)

    # ONE lexicographic sort (cell key asc, then ncc desc) with the
    # patch index as payload — replaces two chained stable argsorts +
    # two gathers (each argsort is itself a full sort), halving the
    # grid build's sort work (reference bubble-sorts per cell,
    # patch_manager.cpp:223-239)
    from jax import lax

    skey, _, spidx = lax.sort(
        (flat_key, -flat_ncc, flat_pidx), num_keys=2, is_stable=True
    )

    # rank within each equal-key segment
    pos = jnp.arange(skey.shape[0])
    is_start = jnp.concatenate(
        [jnp.asarray([True]), skey[1:] != skey[:-1]]
    )
    seg_start = lax.cummax(jnp.where(is_start, pos, 0))
    rank = (pos - seg_start).astype(jnp.int32)

    in_slot = (skey < nkeys) & (rank < capacity)
    slots_flat = jnp.full((nkeys * capacity + 1,), -1, jnp.int32)
    dest = jnp.where(in_slot, skey * capacity + rank, nkeys * capacity)
    slots_flat = slots_flat.at[dest].set(jnp.where(in_slot, spidx, -1))
    slots = slots_flat[:-1].reshape(n, row_count, gw, capacity)

    # a pair that was valid but ranked out of its cell capacity
    over = (skey < nkeys) & (rank >= capacity)
    evicted = jnp.zeros((N,), bool).at[spidx].max(over)
    return slots, evicted


def _pow2_limit(n: int, cap: int) -> int:
    """Round a live-row bound up to the next power of two (capped):
    quantizes `row_limit` so its jit variants stay few."""
    r = 1
    while r < n:
        r *= 2
    return min(r, cap)


def build_depth_maps(
    scene: Scene, table: PatchTable, level: int, csize: int,
    row_start=0, row_count: Optional[int] = None,
    row_limit: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Z-buffer rebuild (reference filter.cpp:580-626): every alive
    patch projects into EVERY image; its optical-axis depth updates the
    floor/ceil cell quad. `row_start`/`row_count` restrict the build to
    a window of cell rows (exact for those rows: each cell's minimum
    only involves pairs targeting it, all of which the window sees);
    `row_limit` bounds the table rows scanned (compacted-table
    invariant, see _fill_slots).
    Returns (depth[n, row_count, gw], depth_idx)."""
    n = scene.n_images
    gw, gh = grid_dims(scene, level, csize)
    if row_count is None:
        row_count = gh
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)

    ids = jnp.arange(n, dtype=jnp.int32)
    xy, _, pvalid = cam.project(
        scene.cams, ids[None, :], table.coord[:N, None, :], level
    )
    fx = xy[..., 0] / csize
    fy = xy[..., 1] / csize
    x0 = jnp.floor(fx).astype(jnp.int32)
    x1 = jnp.ceil(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    y1 = jnp.ceil(fy).astype(jnp.int32)
    depth = jnp.einsum(
        "nc,pc->pn", scene.cams.oaxis, table.coord[:N],
        precision=jax.lax.Precision.HIGHEST,
    )  # [N, n]

    base_valid = pvalid & table.alive[:N, None]

    ncells = n * row_count * gw
    quads = ((x0, y0), (x1, y0), (x0, y1), (x1, y1))
    dest_l, ok_l = [], []
    for qx, qy in quads:
        qyl = qy - row_start
        ok = (
            base_valid & (qx >= 0) & (qx < gw)
            & (qy >= 0) & (qy < gh)
            & (qyl >= 0) & (qyl < row_count)
        )
        dest_l.append(jnp.where(
            ok, (ids[None, :] * row_count + qyl) * gw + qx, ncells
        ))
        ok_l.append(ok)
    # the 4 quad corners scatter as ONE batched scatter-min / -max pass
    # each (instead of 4 sequential scatters): same result (min/max are
    # order-free), one dispatchable op per pass
    dest4 = jnp.stack(dest_l).reshape(-1)       # [4*N*n]
    ok4 = jnp.stack(ok_l)                        # [4, N, n]
    depth4 = jnp.broadcast_to(depth, (4, N, n))
    dgrid = jnp.full((ncells + 1,), INF)
    dgrid = dgrid.at[dest4].min(
        jnp.where(ok4, depth4, INF).reshape(-1)
    )

    igrid = jnp.full((ncells + 1,), -1, jnp.int32)
    pidx4 = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None], (N, n)
    )[None]
    win = ok4 & (depth4 <= dgrid[dest4].reshape(4, N, n))
    igrid = igrid.at[dest4].max(
        jnp.where(win, pidx4, -1).reshape(-1)
    )
    return (
        dgrid[:-1].reshape(n, row_count, gw),
        igrid[:-1].reshape(n, row_count, gw),
    )


def build_grid(
    scene: Scene,
    table: PatchTable,
    level: int,
    csize: int,
    capacity: int,
    v_capacity: Optional[int] = None,
    with_depth: bool = True,
    row_limit: Optional[int] = None,
) -> GridState:
    if v_capacity is None:
        v_capacity = capacity
    slots, evicted = _fill_slots(
        scene, table, table.images, level, csize, capacity,
        row_limit=row_limit,
    )
    vslots, _ = _fill_slots(
        scene, table, table.vimages, level, csize, v_capacity,
        row_limit=row_limit,
    )
    if with_depth:
        depth, depth_idx = build_depth_maps(
            scene, table, level, csize, row_limit=row_limit
        )
    else:
        n = scene.n_images
        gw, gh = grid_dims(scene, level, csize)
        depth = jnp.full((n, gh, gw), INF)
        depth_idx = jnp.full((n, gh, gw), -1, jnp.int32)
    return GridState(slots, vslots, depth, depth_idx, evicted)


def is_visible(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    coord,
    normal,
    image,
    cx,
    cy,
    strict,
    level: int,
    csize: int,
    use_depth: bool = True,
):
    """Occlusion test against the cell z-buffer (reference
    patch_manager.cpp:335-376): visible when in bounds and either the
    cell is empty or the patch sits within a tolerance of the front
    surface along its viewing ray. All args broadcast."""
    gw, gh = grid_dims(scene, level, csize)
    inb = (cx >= 0) & (cx < gw) & (cy >= 0) & (cy < gh)
    if not use_depth:
        return inb

    img = jnp.maximum(image, 0)
    cxs = jnp.clip(cx, 0, gw - 1)
    cys = jnp.clip(cy, 0, gh - 1)
    didx = grid.depth_idx[img, cys, cxs]
    empty = didx < 0

    dp_coord = table.coord[jnp.maximum(didx, 0)]
    ray = coord - scene.cams.center[img]
    ray = ray / jnp.sqrt(
        jnp.maximum(jnp.sum(ray * ray, axis=-1, keepdims=True), 1e-20)
    )
    diff = jnp.sum(ray * (coord - dp_coord), axis=-1)
    factor = jnp.minimum(2.0, 2.0 + jnp.sum(ray * normal, axis=-1))
    unit = cam.get_unit(scene.cams, img, coord, level)
    near = diff < unit * csize * strict * factor
    return inb & (empty | near)


def visible_extra_views(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    coord,
    normal,
    images,
    vimages,
    alive,
    level: int,
    csize: int,
    neighbor_threshold: float,
    use_depth: bool = True,
):
    """setVImagesVGrids for an arbitrary batch (reference
    patch_manager.cpp:263-301): for every view not already in
    images/vimages, add it to vimages if the patch passes the
    visibility test there. Existing vimages keep their order; new views
    append in ascending id order (the reference's scan order).
    `table`/`grid` supply the z-buffer the test runs against.
    Returns new vimages [B, M]."""
    from .patches import compact_by_keys, member_mask, position_in_list

    B, M = images.shape
    n = scene.n_images
    vmember = member_mask(vimages, n)
    known = member_mask(images, n) | vmember

    ids = jnp.arange(n, dtype=jnp.int32)
    xy, _, pvalid = cam.project(
        scene.cams, ids[None, :], coord[:, None, :], level
    )
    cx = jnp.floor(xy[..., 0] + 0.5).astype(jnp.int32) // csize
    cy = jnp.floor(xy[..., 1] + 0.5).astype(jnp.int32) // csize
    vis = is_visible(
        scene,
        grid,
        table,
        coord[:, None, :],
        normal[:, None, :],
        ids[None, :],
        cx,
        cy,
        neighbor_threshold,
        level,
        csize,
        use_depth,
    )
    vis = vis & pvalid & alive[:, None]

    vpos = position_in_list(vimages, n).astype(jnp.float32)
    keys = jnp.where(
        vmember,
        vpos,
        jnp.where(vis & ~known, M + ids.astype(jnp.float32), INF),
    )
    out = compact_by_keys(keys, big=float(INF))
    return out[:, :M]


def set_vimages(
    scene: Scene,
    grid: GridState,
    table: PatchTable,
    level: int,
    csize: int,
    neighbor_threshold: float,
    use_depth: bool = True,
    row_limit: Optional[int] = None,
):
    """Table-wide setVImagesVGrids, chunked over rows (the inner
    per-view projection gathers [rows, n_views, 3, 4] matrices;
    chunking bounds that temporary at full capacity). `row_limit` bounds the
    rows scanned (compacted-table invariant); rows beyond it are dead
    and their vimages reset to -1."""
    cap = table.capacity
    N = cap if row_limit is None else min(row_limit, cap)
    CH = min(8192, N)
    nch = (N + CH - 1) // CH
    rows = (jnp.arange(nch * CH, dtype=jnp.int32) % N).reshape(nch, CH)

    def one(rs):
        return visible_extra_views(
            scene,
            grid,
            table,
            table.coord[rs],
            table.normal[rs],
            table.images[rs],
            table.vimages[rs],
            table.alive[rs],
            level,
            csize,
            neighbor_threshold,
            use_depth,
        )

    out = jax.lax.map(one, rows)
    out = out.reshape(nch * CH, -1)[:N]
    if N < cap:
        pad = jnp.full((cap - N, out.shape[1]), -1, out.dtype)
        out = jnp.concatenate([out, pad])
    return out
