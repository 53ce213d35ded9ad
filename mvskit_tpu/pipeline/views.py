"""Batched view-selection logic (the reference's pre/post-processing).

Re-expresses Optim::preProcess / postProcess and their helpers
(reference pmmvps/optim.cpp:137-398) as masked array programs over a
batch of patch hypotheses. A patch's view set is an ordered index list
[B, M] (-1 padded, entry 0 = reference view); every list operation is a
key-sort compaction, so the whole gauntlet stays inside one jit region
with static shapes.

Thresholds are passed as (possibly traced) scalars so the driver's
threshold annealing (reference pmmvps.cpp:70-74) does not retrigger
compilation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from ..core.patches import (
    compact_by_keys,
    count_valid,
    member_mask,
    position_in_list,
)
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import ncc as nccops
from ..ops import sampling

INF = float(1e30)


def _unit_rays(scene: Scene, view_ids, coord):
    """Normalized rays coord -> camera center for broadcast view ids."""
    ray = scene.cams.center[view_ids] - coord
    n = jnp.sqrt(jnp.maximum(jnp.sum(ray * ray, axis=-1), 1e-20))
    return ray / n[..., None]


def compact_list(images: jnp.ndarray, keep: jnp.ndarray) -> jnp.ndarray:
    """Keep marked entries of an ordered list, preserving order."""
    M = images.shape[-1]
    pos = jnp.arange(M, dtype=jnp.float32)
    keys = jnp.where(keep & (images >= 0), pos, INF)
    order = jnp.argsort(keys, axis=-1)
    newi = jnp.take_along_axis(images, order, axis=-1)
    skeys = jnp.take_along_axis(keys, order, axis=-1)
    return jnp.where(skeys < INF, newi, -1)


def add_images(scene: Scene, coord, normal, images, level: int, angle_threshold0):
    """Optim::addImages (reference optim.cpp:165-205): append every view
    that projects strictly inside the image at `level` and sees the
    patch front within angle_threshold0. Existing entries keep their
    order; new ones are appended in ascending view-id order."""
    B, M = images.shape
    n = scene.n_images
    member = member_mask(images, n)
    pos = position_in_list(images, n).astype(jnp.float32)

    ids = jnp.arange(n, dtype=jnp.int32)
    xy, _, pvalid = cam.project(
        scene.cams, ids[None, :], coord[:, None, :], level
    )
    w = float(scene.width(level))
    h = float(scene.height(level))
    inb = (
        (xy[..., 0] >= 0.0)
        & (xy[..., 0] < w - 1.0)
        & (xy[..., 1] >= 0.0)
        & (xy[..., 1] < h - 1.0)
    )
    rays = _unit_rays(scene, ids[None, :], coord[:, None, :])
    dots = jnp.sum(rays * normal[:, None, :], axis=-1)
    cand = (~member) & pvalid & inb & (dots >= jnp.cos(angle_threshold0))
    if scene.covis is not None:
        # vis.dat covisibility: only the reference view's covisible set
        # is eligible (the visdata2 iteration of reference
        # optim.cpp:179-180, with a real vis.dat behind it)
        ref = jnp.maximum(images[:, 0], 0)
        cand &= scene.covis[ref]

    keys = jnp.where(member, pos, jnp.where(cand, M + ids.astype(jnp.float32), INF))
    return compact_by_keys(keys, big=float(INF))


def constraint_images(
    scene: Scene, coord, normal, images, level: int, wsize: int,
    angle_threshold1: float, ncc_threshold,
):
    """Optim::constraintImages (reference optim.cpp:207-219): keep the
    reference view plus views whose non-robust INCC vs the reference is
    below 1 - ncc_threshold."""
    tex, valid = nccops.texs_for_views(
        scene, images, coord, normal, level, wsize, angle_threshold1
    )
    inccs = nccops.incc_vs_ref(tex, valid, robust=False)
    keep = inccs < (1.0 - ncc_threshold)
    keep = keep.at[:, 0].set(True)
    return compact_list(images, keep)


def compute_units_members(scene: Scene, coord, normal, level: int):
    """Per-view units for ALL views (reference optim.cpp:86-107 variant
    that drops back-facing views): unit = getUnit/(ray.normal), INF if
    ray.normal <= 0. Returns (units[B, n], rays[B, n, 4])."""
    n = scene.n_images
    ids = jnp.arange(n, dtype=jnp.int32)
    rays = _unit_rays(scene, ids[None, :], coord[:, None, :])
    dots = jnp.sum(rays * normal[:, None, :], axis=-1)
    unit = cam.get_unit(scene.cams, ids[None, :], coord[:, None, :], level)
    units = jnp.where(dots > 0.0, unit / jnp.where(dots > 0, dots, 1.0), INF)
    return units, rays


def sort_images(scene: Scene, coord, normal, images, level: int, is_fixed: bool = True):
    """Optim::sortImages (reference optim.cpp:221-258): greedy ordering
    by footprint unit with a baseline-diversity penalty — after picking
    a view, every remaining unit is multiplied by
    threshold / clamp(1 - ray_sel . ray_j, thr/2, thr). Views with
    ray.normal <= 0 are excluded. Fewer than 2 usable views -> empty.
    is_fixed pins the current reference view first."""
    B, M = images.shape
    n = scene.n_images
    member = member_mask(images, n)
    units, rays = compute_units_members(scene, coord, normal, level)
    units = jnp.where(member, units, INF)

    usable = jnp.sum(units < INF, axis=1)

    if is_fixed:
        # unit of the first usable view in list order is forced to 0
        pos = position_in_list(images, n).astype(jnp.float32)
        pos = jnp.where(units < INF, pos, INF)
        first = jnp.argmin(pos, axis=1)
        has = jnp.any(units < INF, axis=1)
        units = jnp.where(
            (jnp.arange(n)[None, :] == first[:, None]) & has[:, None],
            0.0,
            units,
        )

    threshold = 1.0 - math.cos(10.0 * math.pi / 180.0)

    def body(t, carry):
        units, out = carry
        sel = jnp.argmin(units, axis=1)
        selu = jnp.take_along_axis(units, sel[:, None], axis=1)[:, 0]
        ok = selu < INF
        out = out.at[:, t].set(jnp.where(ok, sel.astype(jnp.int32), -1))
        rsel = jnp.take_along_axis(rays, sel[:, None, None], axis=1)[:, 0]
        ftmp = jnp.clip(
            1.0 - jnp.sum(rays * rsel[:, None, :], axis=-1),
            threshold / 2.0,
            threshold,
        )
        units = jnp.where(units < INF, units * threshold / ftmp, INF)
        units = jnp.where(
            jnp.arange(n)[None, :] == sel[:, None], INF, units
        )
        return units, out

    out = jnp.full((B, M), -1, jnp.int32)
    _, out = lax.fori_loop(0, min(M, n), body, (units, out))
    return jnp.where(usable[:, None] >= 2, out, -1)


def filter_images_by_angle(scene: Scene, coord, normal, images, angle_threshold1):
    """Optim::filterImagesByAngle (reference optim.cpp:325-346): drop
    views seeing the patch at a grazing angle; if the REFERENCE view
    fails, the whole patch dies (empty list)."""
    idx = jnp.maximum(images, 0)
    rays = _unit_rays(scene, idx, coord[:, None, :])
    dots = jnp.sum(rays * normal[:, None, :], axis=-1)
    keep = dots >= jnp.cos(angle_threshold1)
    ref_dead = (~keep[:, 0]) & (images[:, 0] >= 0)
    out = compact_list(images, keep)
    return jnp.where(ref_dead[:, None], -1, out)


def set_ref_image(
    scene: Scene, coord, normal, images, level: int, wsize: int,
    angle_threshold1: float,
):
    """Optim::setRefImage (reference optim.cpp:348-383): reference view
    = the one minimizing the summed pairwise robust INCC (invalid pairs
    contribute the 2.0 penalty, exactly as the reference accumulates
    them); swapped to the front of the list."""
    B, M = images.shape
    tex, valid = nccops.texs_for_views(
        scene, images, coord, normal, level, wsize, angle_threshold1
    )
    pairs = nccops.incc_pairwise(tex, valid, robust=True)
    present = images >= 0
    pair_present = present[:, :, None] & present[:, None, :]
    sums = jnp.sum(jnp.where(pair_present, pairs, 0.0), axis=2)
    sums = jnp.where(present, sums, INF)
    refpos = jnp.argmin(sums, axis=1)

    # swap positions 0 and refpos
    pos = jnp.arange(M, dtype=jnp.int32)[None, :]
    take = jnp.where(
        pos == 0,
        refpos[:, None],
        jnp.where(pos == refpos[:, None], 0, pos),
    )
    return jnp.take_along_axis(images, take, axis=1)


def check_angles(scene: Scene, coord, images, min_angle, max_angle):
    """PhotoSet::checkAngles (reference photoSet.cpp:77-103): at least
    one view pair must subtend an angle in (min_angle, max_angle)."""
    idx = jnp.maximum(images, 0)
    rays = _unit_rays(scene, idx, coord[:, None, :])
    dots = jnp.einsum(
        "bic,bjc->bij", rays, rays, precision=lax.Precision.HIGHEST
    )
    ang = jnp.arccos(jnp.clip(dots, -1.0, 1.0))
    present = images >= 0
    M = images.shape[1]
    iu = jnp.triu(jnp.ones((M, M), bool), k=1)[None]
    ok_pair = (
        iu
        & present[:, :, None]
        & present[:, None, :]
        & (ang > min_angle)
        & (ang < max_angle)
    )
    return jnp.sum(ok_pair, axis=(1, 2)) >= 1


def set_scales(scene: Scene, coord, images, level: int, tau: int, wsize: int):
    """PatchManager::setScales (reference patch_manager.cpp:378-399):
    dscale = scene displacement along the ref ray per ~half-pixel mean
    reprojection motion in the other views; ascale = atan(dscale /
    (unit * wsize/2)). Returns (dscale[B], ascale[B])."""
    ref = jnp.maximum(images[:, 0], 0)
    unit = cam.get_unit(scene.cams, ref, coord, level)
    unit2 = 2.0 * unit
    ray = -_unit_rays(scene, ref, coord)  # coord - center, normalized

    nimg = count_valid(images)
    num = jnp.minimum(tau, nimg)

    others = images[:, 1:tau]
    oidx = jnp.maximum(others, 0)
    xy0, _, _ = cam.project(scene.cams, oidx, coord[:, None, :], level)
    back = coord[:, None, :] - (unit2 * 1.0)[:, None, None] * ray[:, None, :]
    xy1, _, _ = cam.project(scene.cams, oidx, back, level)
    diff = jnp.linalg.norm(xy0 - xy1, axis=-1)
    posi = jnp.arange(1, tau)[None, :]
    use = (others >= 0) & (posi < num[:, None])
    total = jnp.sum(jnp.where(use, diff, 0.0), axis=1)

    denom = jnp.maximum(num - 1, 1).astype(jnp.float32)
    mean_motion = total / denom
    dscale = jnp.where(mean_motion > 0.0, unit2 / jnp.where(mean_motion > 0, mean_motion, 1.0), 0.0)
    ascale = jnp.arctan(dscale / (unit * wsize / 2.0))
    return dscale, ascale


class GauntletResult(NamedTuple):
    images: jnp.ndarray   # [B, M]
    ok: jnp.ndarray       # [B] bool
    dscale: jnp.ndarray   # [B]
    ascale: jnp.ndarray   # [B]


def pre_process(
    scene: Scene,
    coord,
    normal,
    images,
    *,
    level: int,
    wsize: int,
    tau: int,
    min_image_num: int,
    ncc_threshold_before,
    angle_threshold0: float,
    angle_threshold1: float,
    max_angle_threshold: float,
) -> GauntletResult:
    """Optim::preProcess (reference optim.cpp:137-163)."""
    images = add_images(scene, coord, normal, images, level, angle_threshold0)
    images = constraint_images(
        scene, coord, normal, images, level, wsize, angle_threshold1,
        ncc_threshold_before,
    )
    images = sort_images(scene, coord, normal, images, level, is_fixed=True)
    dscale, ascale = set_scales(scene, coord, images, level, tau, wsize)
    enough = count_valid(images) >= min_image_num
    angles_ok = check_angles(
        scene, coord, images, max_angle_threshold, angle_threshold1
    )
    ok = enough & angles_ok
    images = jnp.where(ok[:, None], images, -1)
    return GauntletResult(images, ok, dscale, ascale)


def post_process_core(
    scene: Scene,
    coord,
    normal,
    images,
    *,
    level: int,
    wsize: int,
    tau: int,
    min_image_num: int,
    ncc_threshold,
    angle_threshold0: float,
    angle_threshold1: float,
    n_illums: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Optim::postProcess steps 1-8 (reference optim.cpp:260-287):
    count gate -> scene-mask gate -> addImages -> constraint ->
    angle filter -> count gate -> setRefImage -> constraint -> count.
    The depth-dependent visibility/occlusion checks (setVImagesVGrids,
    check()) live in the propagation/filter stages where grid state is
    available. Returns (images, ok, ncc_score)."""
    ok = count_valid(images) >= min_image_num
    ok &= sampling.scene_mask_ok(scene, coord, level)

    images = add_images(scene, coord, normal, images, level, angle_threshold0)
    images = constraint_images(
        scene, coord, normal, images, level, wsize, angle_threshold1,
        ncc_threshold,
    )
    images = filter_images_by_angle(scene, coord, normal, images, angle_threshold1)
    ok &= count_valid(images) >= min_image_num

    images = set_ref_image(scene, coord, normal, images, level, wsize, angle_threshold1)
    images = constraint_images(
        scene, coord, normal, images, level, wsize, angle_threshold1,
        ncc_threshold,
    )
    ok &= count_valid(images) >= min_image_num

    score = nccops.compute_patch_ncc_n(
        scene, images, coord, normal, level, wsize, tau,
        angle_threshold1, n_illums=n_illums,
    )
    images = jnp.where(ok[:, None], images, -1)
    return images, ok, score
