"""Checkerboard PatchMatch propagation.

Data-parallel re-design of the reference's serpentine cell sweep (reference
pmmvps/propagate.cpp:72-237, `propagatePmImage`/`propagatePatch`/
`generatePatch`): instead of walking cells sequentially per image, each
round gathers the top donors of every cell (reference view patches,
NCC-ranked by the grid build), generates depth-transferred hypotheses
into the +-x / +-y neighbor cell with an in-cell jitter, and runs the
whole batch through the preProcess -> refine -> postProcess gauntlet in
fixed-size chunks. Insertion is rebuild-time per-cell top-K eviction,
which realizes the reference's "replace the worst incumbent only if
better" rule (propagate.cpp:166-201) as a deterministic dense pass.

The sweep direction alternates with the outer iteration exactly like
the reference (propagate.cpp:80-85); multiple rounds per iteration
recover the in-sweep chaining a serpentine pass gets for free.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core import grid as gridmod
from ..core.patches import PatchTable, count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import ncc as nccops
from . import refine as rf
from . import views as vw

NEG = float(-1e30)


class PropagateParams(NamedTuple):
    """Static configuration of one propagation round."""
    level: int
    csize: int
    wsize: int
    tau: int
    min_image_num: int
    cell_capacity: int
    angle_threshold0: float
    angle_threshold1: float
    max_angle_threshold: float
    ascale: float
    refine_rounds: int
    refine_cands: int
    refine_shrink: float
    refine_depth_radius: float
    refine_angle_radius: float
    neighbor_threshold: float
    donor_budget: int
    chunk: int
    neighbor_threshold1: float = 1.0
    depth2_check: bool = False
    grad_steps: int = 0
    grad_lr: float = 0.5
    luma_refine: bool = False
    neighbor_capacity: int = 48
    neighbor_cand_cap: int = 1024
    donor_policy: str = "cell_first"
    rgb_tail: int = 0
    # multi-illumination scoring (the live wiring of the reference's
    # dormant multi-illum getTex, optim.cpp:846-893): when > 1, the
    # gauntlet's NCC scores and the refinement objective average over
    # the illumination axis. View SELECTION (constraint/sortImages/
    # setRefImage) stays illum-0, like every reference variant.
    n_illums: int = 1


class RoundStats(NamedTuple):
    total: jnp.ndarray    # hypotheses attempted (m_ecount analog)
    fail0: jnp.ndarray    # failed preProcess (m_fcount0)
    fail1: jnp.ndarray    # failed postProcess (m_fcount1)
    passed: jnp.ndarray   # accepted (m_pcount)


def donor_priority(ncc_vals, slot_rank, ok, policy: str):
    """Donation priority of a grid slot.

    'cell_first' (default): every cell's slot-0 (best-NCC) patch
    outranks ANY cell's slot-1 patch — the array analog of the
    reference donating from every non-empty cell each sweep
    (propagate.cpp:88-121, per-cell NCC-descending sort). A pure
    global-NCC top-k ('ncc') starves low-texture frontier cells once
    the table outgrows the budget (the round-1 VERDICT coverage risk);
    rank-major order caps the per-cell donation instead, like the
    reference's MAX_NUM_OF_PATCHES cell cap. Within a rank the order is
    still NCC-descending. ncc is in [-1, 1], so a 2.5 rank step keeps
    ranks strictly separated."""
    if policy == "cell_first":
        prio = ncc_vals - 2.5 * slot_rank.astype(jnp.float32)
    else:
        prio = ncc_vals
    return jnp.where(ok, prio, NEG)


def select_donors(
    scene: Scene, grid: gridmod.GridState, table: PatchTable, budget: int,
    policy: str = "cell_first",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick up to `budget` donor (patch, cell) pairs, priority-ordered
    (donor_priority above).

    A slot donates only when the grid's image is the patch's reference
    view (reference propagate.cpp:104). Returns (pidx, img, cy, cx, ok)
    each [budget]."""
    n, gh, gw, S = grid.slots.shape
    flat = grid.slots.reshape(-1)
    pidx = jnp.maximum(flat, 0)
    ar = jnp.arange(n * gh * gw * S, dtype=jnp.int32)
    slot_img = ar // (gh * gw * S)
    is_ref = table.images[pidx, 0] == slot_img
    ok = (flat >= 0) & is_ref & table.alive[pidx]
    prio = donor_priority(table.ncc[pidx], ar % S, ok, policy)
    _, top = lax.top_k(prio, budget)
    cell = top // S
    img = cell // (gh * gw)
    rem = cell % (gh * gw)
    cy = rem // gw
    cx = rem % gw
    sel_ok = jnp.take(ok, top)
    return jnp.take(pidx, top), img, cy, cx, sel_ok


def generate_hypotheses(
    scene: Scene,
    table: PatchTable,
    grid: gridmod.GridState,
    donor_pidx,
    donor_img,
    donor_cy,
    donor_cx,
    donor_ok,
    axis: int,
    direction: int,
    key,
    p: PropagateParams,
    gate_full=None,
    gate_worst_ncc=None,
):
    """generatePatch for a donor batch (reference propagate.cpp:126-237):
    jittered target-cell pixel, depth transfer along the new ray, copied
    normal, view list re-projected (OOB views dropped), initial NCC; a
    full target cell additionally requires beating its worst incumbent.

    `gate_full`/`gate_worst_ncc` optionally supply the full-cell gate
    state per donor (used by the tile-sharded path, where the target
    cell's worst incumbent arrives by halo exchange instead of a global
    grid read — parallel/tiles.py).

    Returns (coord, normal, images, ncc0, ok)."""
    gw, gh = gridmod.grid_dims(scene, p.level, p.csize)
    tx = donor_cx + (direction if axis == 0 else 0)
    ty = donor_cy + (direction if axis == 1 else 0)
    inb = (tx >= 0) & (tx < gw) & (ty >= 0) & (ty < gh)

    jit = jax.random.uniform(
        key, (donor_pidx.shape[0], 2), minval=-0.5, maxval=0.5
    ) * p.csize
    fx = (p.csize * (2 * tx + 1) - 1) / 2.0 + jit[:, 0]
    fy = (p.csize * (2 * ty + 1) - 1) / 2.0 + jit[:, 1]

    dcoord = table.coord[donor_pidx]
    depth = jnp.sum(scene.cams.oaxis[donor_img] * dcoord, axis=-1)
    xy = jnp.stack([fx, fy], axis=-1)
    coord = cam.unproject(scene.cams, donor_img, xy, depth, p.level)
    normal = table.normal[donor_pidx]

    # setGridsImages: drop views whose cell projects out of the grid
    images = table.images[donor_pidx]
    _, _, cell_ok = gridmod.patch_cells(scene, coord, images, p.level, p.csize)
    images = vw.compact_list(images, cell_ok)
    has_views = count_valid(images) > 0

    ncc0 = nccops.compute_patch_ncc_n(
        scene, images, coord, normal, p.level, p.wsize, p.tau,
        p.angle_threshold1, n_illums=p.n_illums,
    )

    # full-cell gate (reference propagate.cpp:166-173): if the target
    # cell is at capacity, the newcomer must beat the worst incumbent
    if gate_full is None:
        txc = jnp.clip(tx, 0, gw - 1)
        tyc = jnp.clip(ty, 0, gh - 1)
        worst = grid.slots[donor_img, tyc, txc, p.cell_capacity - 1]
        gate_full = worst >= 0
        gate_worst_ncc = table.ncc[jnp.maximum(worst, 0)]
    beats = ncc0 > gate_worst_ncc
    ok = donor_ok & inb & has_views & jnp.where(gate_full, beats, True)
    return coord, normal, images, ncc0, ok


class GauntletOut(NamedTuple):
    coord: jnp.ndarray
    normal: jnp.ndarray
    images: jnp.ndarray
    vimages: jnp.ndarray
    ncc: jnp.ndarray
    dscale: jnp.ndarray
    ascale: jnp.ndarray
    ok: jnp.ndarray
    fail0: jnp.ndarray
    fail1: jnp.ndarray


def run_gauntlet(
    scene: Scene,
    grid: gridmod.GridState,
    table: PatchTable,
    coord,
    normal,
    images,
    ok_in,
    key,
    p: PropagateParams,
    ncc_threshold,
    ncc_threshold_before,
    use_depth: bool,
    quad_threshold=2.5,
) -> GauntletOut:
    """preProcess -> refinePatch -> postProcess for a hypothesis batch
    (the gauntlet of reference propagate.cpp:182-196)."""
    pre = vw.pre_process(
        scene, coord, normal, images,
        level=p.level, wsize=p.wsize, tau=p.tau,
        min_image_num=p.min_image_num,
        ncc_threshold_before=ncc_threshold_before,
        angle_threshold0=p.angle_threshold0,
        angle_threshold1=p.angle_threshold1,
        max_angle_threshold=p.max_angle_threshold,
    )
    fail0 = ok_in & ~pre.ok

    res = rf.refine_batch(
        scene, coord, normal, pre.images, pre.dscale, key,
        level=p.level, wsize=p.wsize, tau=p.tau,
        min_image_num=p.min_image_num,
        angle_threshold1=p.angle_threshold1, ascale=p.ascale,
        rounds=p.refine_rounds, n_cands=p.refine_cands,
        shrink=p.refine_shrink,
        init_depth_radius=p.refine_depth_radius,
        init_angle_radius=p.refine_angle_radius,
        grad_steps=p.grad_steps, grad_lr=p.grad_lr,
        luma=p.luma_refine,
        n_illums=p.n_illums, rgb_tail=p.rgb_tail,
    )

    post_images, post_ok, _ = vw.post_process_core(
        scene, res.coord, res.normal, pre.images,
        level=p.level, wsize=p.wsize, tau=p.tau,
        min_image_num=p.min_image_num, ncc_threshold=ncc_threshold,
        angle_threshold0=p.angle_threshold0,
        angle_threshold1=p.angle_threshold1,
        n_illums=p.n_illums,
    )
    ok = ok_in & pre.ok & post_ok
    fail1 = ok_in & pre.ok & ~post_ok

    vimages = gridmod.visible_extra_views(
        scene, grid, table,
        res.coord, res.normal, post_images,
        jnp.full_like(post_images, -1), ok,
        p.level, p.csize, p.neighbor_threshold, use_depth,
    )

    if p.depth2_check:
        # Optim::check (reference optim.cpp:292-295, 300-323): once
        # depth >= 2 the gauntlet also applies the occlusion-gain and
        # quadric tests against the round-start grid
        from . import filters as fl

        reject = fl.check_batch(
            scene, grid, table, res.coord, res.normal, pre.dscale,
            res.ncc, post_images, vimages,
            level=p.level, csize=p.csize, tau=p.tau,
            ncc_threshold=ncc_threshold,
            quad_threshold=quad_threshold,
            neighbor_threshold=p.neighbor_threshold,
            neighbor_threshold1=p.neighbor_threshold1,
            max_neighbors=p.neighbor_capacity,
            cand_cap=p.neighbor_cand_cap,
        )
        fail1 = fail1 | (ok & reject)
        ok = ok & ~reject

    return GauntletOut(
        coord=res.coord, normal=res.normal, images=post_images,
        vimages=vimages, ncc=res.ncc, dscale=pre.dscale,
        ascale=pre.ascale, ok=ok, fail0=fail0, fail1=fail1,
    )


def insert_patches(table: PatchTable, out: GauntletOut) -> PatchTable:
    """Fill accepted hypotheses into dead rows of the patch table,
    best-NCC first. If accepted > free rows, the worst overflow drops
    (the grid's per-cell capacity bounds the live population anyway)."""
    N = table.capacity
    B = out.ok.shape[0]
    dead = ~table.alive
    dead_rank = jnp.cumsum(dead) - 1  # rank of each dead row

    acc_key = jnp.where(out.ok, -out.ncc, jnp.float32(1e30))
    acc_order = jnp.argsort(acc_key)
    n_acc = jnp.sum(out.ok)

    take = acc_order[jnp.clip(dead_rank, 0, B - 1)]
    write = dead & (dead_rank < n_acc)

    def mix(old, new):
        shaped = new[take]
        if old.ndim > 1:
            m = write.reshape((-1,) + (1,) * (old.ndim - 1))
        else:
            m = write
        return jnp.where(m, shaped, old)

    return PatchTable(
        coord=mix(table.coord, out.coord),
        normal=mix(table.normal, out.normal),
        ncc=mix(table.ncc, out.ncc),
        dscale=mix(table.dscale, out.dscale),
        ascale=mix(table.ascale, out.ascale),
        images=mix(table.images, out.images),
        vimages=mix(table.vimages, out.vimages),
        alive=table.alive | write,
    )


def propagate_round(
    scene: Scene,
    table: PatchTable,
    key,
    p: PropagateParams,
    direction: int,
    ncc_threshold,
    ncc_threshold_before,
    use_depth: bool = True,
    quad_threshold=2.5,
    row_limit=None,
) -> Tuple[PatchTable, RoundStats]:
    """One propagation round: each donor propagates into BOTH its x-
    and y-neighbor target cell from one shared grid build and donor
    selection — exactly the reference's per-patch behavior inside a
    sweep (propagate.cpp:106-108 fires propagatePatch for the x and y
    neighbor of the SAME cell state). One grid build + donor top-k per
    round instead of two (the round-3 breakdown put build_grid at 24%
    of the round, PROP_PARTS.json; the insertions of a round become
    donors in the NEXT round, which the multi-round schedule covers)."""
    key, k1a, k1b, k2 = jax.random.split(key, 4)
    grid = gridmod.build_grid(
        scene, table, p.level, p.csize, p.cell_capacity,
        row_limit=row_limit,
    )
    # cap enforcement kills over-capacity patches globally
    # (reference propagate.cpp:94-98 removePatch)
    table = table._replace(alive=table.alive & ~grid.evicted)

    donors = select_donors(
        scene, grid, table, p.donor_budget, p.donor_policy
    )
    parts = [
        generate_hypotheses(
            scene, table, grid, *donors, axis, direction, k, p
        )
        for axis, k in ((0, k1a), (1, k1b))
    ]
    coord, normal, images, _, ok = (
        jnp.concatenate([pt[i] for pt in parts]) for i in range(5)
    )

    out = _gauntlet_chunked(
        scene, grid, table, coord, normal, images, ok, k2, p,
        ncc_threshold, ncc_threshold_before, use_depth,
        quad_threshold,
    )
    table = insert_patches(table, out)
    stats = RoundStats(
        total=jnp.sum(ok),
        fail0=jnp.sum(out.fail0),
        fail1=jnp.sum(out.fail1),
        passed=jnp.sum(out.ok),
    )
    return table, stats


def _gauntlet_chunked(
    scene, grid, table, coord, normal, images, ok, key, p,
    ncc_threshold, ncc_threshold_before, use_depth, quad_threshold=2.5,
) -> GauntletOut:
    H = coord.shape[0]
    C = min(p.chunk, H)
    n_chunks = (H + C - 1) // C
    pad = n_chunks * C - H

    def padc(x):
        if pad:
            x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape((n_chunks, C) + x.shape[1:])

    keys = jax.random.split(key, n_chunks)
    ok_p = padc(ok & jnp.ones((H,), bool))

    def one(args):
        c, n, im, o, k = args
        return run_gauntlet(
            scene, grid, table, c, n, im, o, k, p,
            ncc_threshold, ncc_threshold_before, use_depth,
            quad_threshold,
        )

    outs = lax.map(
        one, (padc(coord), padc(normal), padc(images), ok_p, keys)
    )
    flat = jax.tree_util.tree_map(
        lambda x: x.reshape((n_chunks * C,) + x.shape[2:])[:H], outs
    )
    return flat
