"""Patch seeding (the reference's DepthNormInit stage).

Two paths, mirroring reference pmmvps/depth_normal_init.cpp:29-144:

  * live path — resume from `ply/00000000.patch` (the reference
    hardwires isTest=1, depth_normal_init.cpp:30-33): parse the patch
    file, translate image ids to indices, drop unknown views, clear
    vimages (patch_manager.cpp:450-462);
  * PLY path — seed cloud `ply/00000000.ply` plus per-view normal maps
    `ply/%08d.ply` (pixel-indexed camera-frame normals rotated to world
    by R; depth_normal_init.cpp:36-144): one patch per seed visible in
    >=2 mask-passing views, averaged world normal, free-choice
    sortImages, scales and NCC initialized (the reference leaves ncc
    unset here and computes it lazily in sortPatches — we compute it
    eagerly since donor ranking needs it).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MVSConfig
from ..core import patches as pt
from ..geometry import camera as cam
from ..image.scene import Scene
from ..io import patch_io, ply
from ..ops import ncc as nccops
from . import views as vw


def rq_decompose(M: np.ndarray):
    """M = K R with K upper-triangular (positive diagonal), R rotation."""
    rev = M[::-1].T
    q, r = np.linalg.qr(rev)
    K = r.T[::-1, ::-1]
    R = q.T[::-1]
    # enforce positive diagonal on K
    s = np.sign(np.diag(K))
    s[s == 0] = 1.0
    K = K * s[None, :]
    R = R * s[:, None]
    if np.linalg.det(R) < 0:
        K = -K
        R = -R
    return K, R


def rotation_of_view(scene: Scene, index: int) -> np.ndarray:
    """World->camera rotation from the projection matrix (generalizes
    the reference's CONTOUR2-only Camera::setR, camera.cpp:179-197)."""
    M = np.asarray(scene.cams.P[index][:, :3], dtype=np.float64)
    _, R = rq_decompose(M)
    return R


def finalize_seeds(
    scene: Scene,
    cfg: MVSConfig,
    coord: np.ndarray,
    normal: np.ndarray,
    images: np.ndarray,
    ncc: Optional[np.ndarray] = None,
    dscale: Optional[np.ndarray] = None,
    ascale: Optional[np.ndarray] = None,
) -> pt.PatchTable:
    """Build the device patch table; fill any missing scales/scores."""
    table = pt.from_numpy(
        coord, normal, images, cfg.max_patches, scene.n_images,
        ncc=ncc, dscale=dscale, ascale=ascale,
    )
    n = coord.shape[0]
    need_scales = dscale is None or ascale is None
    need_ncc = ncc is None
    if need_scales or need_ncc:
        # one jitted program for the device work instead of many
        # eager dispatches
        def _fill(scene, table):
            rows = slice(0, n)
            c = table.coord[rows]
            nm = table.normal[rows]
            im = table.images[rows]
            if need_scales:
                ds, asc = vw.set_scales(
                    scene, c, im, cfg.level, cfg.tau, cfg.wsize
                )
                table = table._replace(
                    dscale=table.dscale.at[rows].set(ds),
                    ascale=table.ascale.at[rows].set(asc),
                )
            if need_ncc:
                scores = nccops.compute_patch_ncc_n(
                    scene, im, c, nm, cfg.level, cfg.wsize, cfg.tau,
                    cfg.angle_threshold1,
                    n_illums=scene.n_illums if cfg.use_illums else 1,
                )
                table = table._replace(ncc=table.ncc.at[rows].set(scores))
            alive = table.alive & (pt.count_valid(table.images) > 0)
            return table._replace(alive=alive)

        return jax.jit(_fill)(scene, table)
    # patches that lost every view die immediately
    alive = table.alive & (pt.count_valid(table.images) > 0)
    return table._replace(alive=alive)


def seed_from_patch_file(
    scene: Scene, cfg: MVSConfig, path: str
) -> pt.PatchTable:
    data = patch_io.read_patch_file(path)
    id2idx = {img: i for i, img in enumerate(cfg.images)}

    keep, imgs = [], []
    for i, lst in enumerate(data["images"]):
        translated = [id2idx[v] for v in lst if v in id2idx]
        if translated:
            keep.append(i)
            imgs.append(translated)
    keep = np.asarray(keep, dtype=np.int64)
    n = len(keep)
    if n == 0:
        raise ValueError(f"no usable patches in {path}")
    images = patch_io.lists_to_padded(imgs, scene.n_images)

    return finalize_seeds(
        scene, cfg,
        data["coord"][keep].astype(np.float32),
        data["normal"][keep].astype(np.float32),
        images,
        ncc=data["ncc"][keep].astype(np.float32),
        dscale=data["dscale"][keep].astype(np.float32),
        ascale=data["ascale"][keep].astype(np.float32),
    )


def _seed_chunk(
    coord: np.ndarray,
    P_host: np.ndarray,
    nmaps: np.ndarray,
    have_map: np.ndarray,
    masks0,
    w0: int,
    h0: int,
    n_images: int,
):
    """Vectorized per-seed work for one chunk (depth_normal_init.cpp:
    36-94): project into every view, gate by bounds/mask, average the
    per-view world normals, keep seeds with >=2 views and a nonzero
    normal. Returns (coord, normal, images_padded) for the survivors."""
    # project every seed into every view at level 0 (host numpy)
    ic = np.einsum("nij,sj->nsi", P_host, coord.astype(np.float64))
    z = ic[:, :, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = np.floor(ic[:, :, 0] / z + 0.5).astype(np.int64)
        y = np.floor(ic[:, :, 1] / z + 0.5).astype(np.int64)
    inb = (z > 0) & (x >= 0) & (x < w0) & (y >= 0) & (y < h0)
    xs = np.clip(x, 0, w0 - 1)
    ys = np.clip(y, 0, h0 - 1)
    if masks0 is not None:
        mask_ok = masks0[np.arange(n_images)[:, None], ys, xs] > 0
        inb &= mask_ok
    # reference requires getMask > 0, which can never pass without
    # masks; treating no-mask as pass instead (DIVERGENCES.md)

    # averaged world normal over mask-passing views that carry a map
    contrib = nmaps[np.arange(n_images)[:, None], ys, xs]  # [n, S, 3]
    w = (inb & have_map[:, None])[..., None]
    nsum = np.sum(np.where(w, contrib, 0.0), axis=0)       # [S, 3]
    nview = inb.sum(axis=0)
    nrm = np.linalg.norm(nsum, axis=1)
    keep = (nview >= 2) & (nrm > 0)
    if not keep.any():
        return None
    n3 = nsum[keep] / nrm[keep][:, None]
    ckeep = coord[keep]
    normal = np.concatenate(
        [n3, -np.sum(ckeep[:, :3] * n3, axis=1, keepdims=True)], axis=1
    ).astype(np.float32)
    # padded ascending view lists without a per-seed loop
    inbk = inb[:, keep].T  # [K, n_images]
    slot = np.cumsum(inbk, axis=1) - 1
    images = np.full((inbk.shape[0], n_images), -1, np.int32)
    rows, cols = np.nonzero(inbk)
    images[rows, slot[rows, cols]] = cols
    return ckeep, normal, images


def seed_from_plys(
    scene: Scene, cfg: MVSConfig, prefix: str, chunk: int = 1 << 18
) -> pt.PatchTable:
    seed_path = os.path.join(prefix, "ply", "00000000.ply")
    pts = ply.read_ply(seed_path)["xyz"]
    n_seeds = pts.shape[0]
    coord = np.concatenate(
        [pts, np.ones((n_seeds, 1))], axis=1
    ).astype(np.float32)

    # per-view pixel-indexed world-frame normal maps
    w0, h0 = scene.width(0), scene.height(0)
    # one device->host camera fetch for all views, not one per view
    P_host = np.asarray(scene.cams.P, dtype=np.float64)
    nmaps = np.zeros((scene.n_images, h0, w0, 3), dtype=np.float32)
    have_map = np.zeros(scene.n_images, dtype=bool)
    for i in range(scene.n_images):
        p = os.path.join(prefix, "ply", f"{i + 1:08d}.ply")
        if not os.path.exists(p):
            continue
        d = ply.read_ply(p)
        if "normal" not in d:
            continue
        _, R = rq_decompose(P_host[i][:, :3])
        world = d["normal"] @ R.T  # reference: R * normal3
        x = d["xyz"][:, 0].astype(np.int64)
        y = d["xyz"][:, 1].astype(np.int64)
        ok = (x >= 0) & (x < w0) & (y >= 0) & (y < h0)
        nmaps[i, y[ok], x[ok]] = world[ok]
        have_map[i] = True

    masks0 = None
    if scene.masks is not None:
        masks0 = np.asarray(
            scene.masks[:, : w0 * h0]
        ).reshape(scene.n_images, h0, w0)

    # chunk the seed axis: real seed clouds run to millions of points
    # and the [n_images, S, 3] projection intermediates must stay
    # bounded in host memory; each chunk is fully vectorized
    parts = []
    for off in range(0, n_seeds, chunk):
        r = _seed_chunk(
            coord[off : off + chunk], P_host, nmaps, have_map,
            masks0, w0, h0, scene.n_images,
        )
        if r is not None:
            parts.append(r)

    if not parts:
        raise ValueError(f"no seeds with >=2 visible views in {seed_path}")
    coord_a = np.concatenate([p[0] for p in parts]).astype(np.float32)
    normal_a = np.concatenate([p[1] for p in parts]).astype(np.float32)
    images = np.concatenate([p[2] for p in parts])

    # free-choice reference view ordering (sortImages isFixed=0,
    # depth_normal_init.cpp:78) — jitted as one program
    images_j = jax.jit(
        lambda s, c, n, im: vw.sort_images(
            s, c, n, im, cfg.level, is_fixed=False
        )
    )(
        scene,
        jnp.asarray(coord_a),
        jnp.asarray(normal_a),
        jnp.asarray(images),
    )
    return finalize_seeds(
        scene, cfg, coord_a, normal_a, np.asarray(images_j)
    )


def seed(scene: Scene, cfg: MVSConfig, prefix: str, resume_iter: int = 0) -> pt.PatchTable:
    """DepthNormInit::createPatches: prefer the .patch checkpoint."""
    patch_path = os.path.join(prefix, "ply", f"{resume_iter:08d}.patch")
    if os.path.exists(patch_path):
        return seed_from_patch_file(scene, cfg, patch_path)
    return seed_from_plys(scene, cfg, prefix)
