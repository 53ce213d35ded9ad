"""Batched NCC photo-consistency scoring — the hot op of PM-MVS.

Batched fusion of the reference's texture grab + normalization + NCC
chain (reference pmmvps/optim.cpp:790-948, 601-628, 630-706): for a
batch of patch hypotheses, warp a wsize x wsize window on the patch
plane into each candidate view (bilinear, with per-(patch,view) dynamic
pyramid level), zero-mean/unit-RMS normalize, and reduce to robust
inverse-NCC scores. Everything is one jit region; the per-view axis is
a vectorized dimension rather than the reference's serial view loop.

Layout: window tensors are WINDOWS-MAJOR: ``tex[T, B, L]`` with
L = C * SPAD lanes per (view, patch) row, so every per-window reduction
runs over the minor axis. Within a row, channel c occupies lanes
[c*SPAD, c*SPAD + S); on the gather path SPAD = S, and any lanes >= S
in a block are zeroed by `normalize_tex`, so downstream inner products
are plain lane sums. `normalize_tex` also
folds the 1/sqrt(C*S) mean factor into the values: the dot of two
normalized rows IS the reference's mean NCC dot (optim.cpp:601-609)
with no further division. Aggregation outputs return batch-major
[B]/[B, T] (small).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import camera as cam
from ..image.scene import Scene
from . import sampling

BIG = float(2**30)


def robustincc(incc):
    """incc / (1 + 3 incc) (reference optim.cpp:622-624)."""
    return incc / (1.0 + 3.0 * incc)


def unrobustincc(rincc):
    """Inverse of robustincc (reference optim.cpp:626-628)."""
    return rincc / (1.0 - 3.0 * rincc)


def _dot4(a, b):
    return jnp.sum(a * b, axis=-1)


def _unit_ray_to_camera(scene: Scene, index, coord):
    """Normalized ray from patch to camera center (w component 0)."""
    ray = scene.cams.center[index] - coord
    n = jnp.sqrt(jnp.maximum(jnp.sum(ray * ray, axis=-1), 1e-20))
    return ray / n[..., None]


def _window_tail(scene: Scene, c_xy, dx, dy, level: int, wsize: int):
    """Shared tail of window_geometry / window_geometry_views: footprint
    ratio -> level shift -> rescaled lattice steps -> border-safety
    check -> lattice origin (reference optim.cpp:806-822).

    Returns (tl[..., 2], dx2[..., 2], dy2[..., 2], new_level[...],
    valid_safe[...])."""
    n_levels = scene.lvl_widths.shape[0]
    # the +-2 level_diff clamp below can reach level+2, so the scene
    # must carry at least level+3 pyramid levels (the reference builds
    # m_level+3, pmmvps.cpp:36) or windows would silently vanish in the
    # static level-size sweep — fail loudly at trace time instead
    assert n_levels >= level + 3, (
        f"scene has {n_levels} pyramid levels; getTex at level {level} "
        f"needs >= {level + 3} (reference pmmvps.cpp:36)"
    )
    ratio = (
        jnp.sqrt(jnp.maximum(jnp.sum(dx * dx, axis=-1), 1e-20))
        + jnp.sqrt(jnp.maximum(jnp.sum(dy * dy, axis=-1), 1e-20))
    ) / 2.0
    level_diff = jnp.floor(jnp.log2(ratio) + 0.5).astype(jnp.int32)
    level_diff = jnp.clip(level_diff, -level, 2)
    scale = jnp.exp2(level_diff.astype(jnp.float32))
    new_level = level + level_diff

    c2 = c_xy / scale[..., None]
    dx2 = dx / scale[..., None]
    dy2 = dy / scale[..., None]

    margin = wsize // 2
    half = dx2 * margin
    halfy = dy2 * margin
    minxy = c2 - jnp.abs(half) - jnp.abs(halfy)
    maxxy = c2 + jnp.abs(half) + jnp.abs(halfy)
    # level-size lookup as a static one-hot sweep over the (few) levels
    # (fuses into one elementwise pass; new_level is in range by the clamp +
    # the trace-time assert above)
    w_l = jnp.zeros(new_level.shape, jnp.float32)
    h_l = jnp.zeros(new_level.shape, jnp.float32)
    for l in range(n_levels):
        ml = new_level == l
        w_l = jnp.where(ml, scene.lvl_widths[l].astype(jnp.float32), w_l)
        h_l = jnp.where(ml, scene.lvl_heights[l].astype(jnp.float32), h_l)
    margin2 = 2.0
    valid_safe = (
        (minxy[..., 0] >= margin2)
        & (maxxy[..., 0] < w_l - 1.0 - margin2)
        & (minxy[..., 1] >= margin2)
        & (maxxy[..., 1] < h_l - 1.0 - margin2)
    )
    tl = c2 - half - halfy
    return tl, dx2, dy2, new_level, valid_safe


def window_geometry(
    scene: Scene, idx, coord, pxaxis, pyaxis, normal, level: int,
    wsize: int, angle_threshold1: float,
):
    """The geometric half of Optim::getTex (reference optim.cpp:790-822):
    viewing-angle gate, footprint-driven level shift, border-safety
    check, and the projected lattice origin/steps at the final level.

    Returns (tl[..., 2], dx[..., 2], dy[..., 2], new_level[...],
    valid[...])."""
    ray = _unit_ray_to_camera(scene, idx, coord)
    weight = jnp.maximum(0.0, _dot4(ray, normal))
    valid_angle = weight >= math.cos(angle_threshold1)

    c_xy, _, c_ok = cam.project(scene.cams, idx, coord, level)
    px_xy, _, _ = cam.project(scene.cams, idx, coord + pxaxis, level)
    py_xy, _, _ = cam.project(scene.cams, idx, coord + pyaxis, level)
    dx = px_xy - c_xy
    dy = py_xy - c_xy

    tl, dx2, dy2, new_level, valid_safe = _window_tail(
        scene, c_xy, dx, dy, level, wsize
    )
    valid = valid_angle & valid_safe & c_ok
    return tl, dx2, dy2, new_level, valid


def window_geometry_views(
    scene: Scene, views_t, coord, pxaxis, pyaxis, normal, level: int,
    wsize: int, angle_threshold1: float,
):
    """window_geometry for a [T, B] view batch sharing per-patch
    geometry, re-expressed dense-over-views.

    Projection is linear, so every view's P projects the whole patch
    batch at once: one [B, 4] @ [4, 3V] f32-HIGHEST matmul per lattice
    point (P @ (c + a) = P@c + P@a since the plane axes have w = 0),
    and the T live views are then picked by a static one-hot sum over
    V — no per-row camera gathers or per-row matvecs (whether a direct
    gather is better on the GPU is ROADMAP B1/C4).
    Semantics mirror window_geometry / Optim::getTex (reference
    optim.cpp:790-822) and Camera::project (camera.cpp:310-326);
    padded rows (views_t == -1) select nothing and come back invalid.
    """
    T, B = views_t.shape
    V = scene.n_images
    cams = scene.cams
    prec = jax.lax.Precision.HIGHEST

    Pcat = cams.P.reshape(V * 3, 4).T.astype(jnp.float32)  # [4, 3V]
    qc = jnp.dot(coord, Pcat, precision=prec).reshape(B, V, 3)
    qx = jnp.dot(pxaxis, Pcat, precision=prec).reshape(B, V, 3)
    qy = jnp.dot(pyaxis, Pcat, precision=prec).reshape(B, V, 3)

    # viewing-angle gate dense over views: weight = max(0,
    # dot(unit(center_v - c), normal)) (_unit_ray_to_camera + _dot4).
    # The ray norm is computed subtract-then-square ([B, V, 3] diff, a
    # few elementwise passes vs the 9-component projection matmuls above): the
    # expanded |c|^2 - 2 c.cen + |cen|^2 form cancels catastrophically
    # when the patch-camera distance is small relative to the
    # coordinate magnitudes and can flip the gate near the
    # cos(angle_threshold1) boundary (round-4 advisor finding).
    c3 = coord[:, :3]
    n3 = normal[:, :3]
    cen = cams.center[:, :3].astype(jnp.float32)            # [V, 3]
    diff = cen[None, :, :] - c3[:, None, :]                 # [B, V, 3]
    rnorm = jnp.sqrt(
        jnp.maximum(jnp.sum(diff * diff, axis=-1), 1e-20)
    )
    wraw = jnp.sum(diff * n3[:, None, :], axis=-1) / rnorm  # [B, V]
    ang_ok = jnp.maximum(0.0, wraw) >= math.cos(angle_threshold1)

    # static one-hot selection of the T live views (V static
    # where+accumulate passes fuse into one elementwise sweep; exact)
    q = jnp.concatenate([qc, qx, qy], axis=-1)              # [B, V, 9]
    selq = jnp.zeros((T, B, 9), jnp.float32)
    sel_ang = jnp.zeros((T, B), bool)
    for v in range(V):
        m = views_t == v
        selq = jnp.where(m[..., None], q[:, v][None], selq)
        sel_ang = jnp.where(m, ang_ok[:, v][None], sel_ang)
    ic = selq[..., 0:3]

    s = cam.level_scale(level)

    def proj_xy(p):
        # Camera::project semantics (camera.cpp:310-326)
        z = p[..., 2]
        ok = z > 0.0
        safe_z = jnp.where(ok, z, 1.0)
        xy = p[..., :2] / (safe_z * s)[..., None]
        xy = jnp.clip(xy, -1e9, 1e9)
        return jnp.where(ok[..., None], xy, cam.BEHIND), ok

    c_xy, c_ok = proj_xy(ic)
    px_xy, _ = proj_xy(ic + selq[..., 3:6])
    py_xy, _ = proj_xy(ic + selq[..., 6:9])
    dx = px_xy - c_xy
    dy = py_xy - c_xy

    tl, dx2, dy2, new_level, valid_safe = _window_tail(
        scene, c_xy, dx, dy, level, wsize
    )
    valid = sel_ang & valid_safe & c_ok
    # materialize the per-window geometry ONCE, as [T, B] scalar planes.
    # Without this barrier XLA may fuse the V-step one-hot select into
    # the sampler's per-sample operand prep and recompute it S times
    # per window (ROADMAP C4 re-measures it on the GPU).
    (tlx, tly, dxx, dxy, dyx, dyy, new_level, valid) = (
        jax.lax.optimization_barrier(
            (tl[..., 0], tl[..., 1], dx2[..., 0], dx2[..., 1],
             dy2[..., 0], dy2[..., 1], new_level, valid)
        )
    )
    tl = jnp.stack([tlx, tly], axis=-1)
    dx2 = jnp.stack([dxx, dxy], axis=-1)
    dy2 = jnp.stack([dyx, dyy], axis=-1)
    return tl, dx2, dy2, new_level, valid


def get_tex(
    scene: Scene,
    index,
    coord,
    pxaxis,
    pyaxis,
    normal,
    level: int,
    wsize: int,
    angle_threshold1: float,
    illum=0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Texture window per (hypothesis, view): Optim::getTex (reference
    optim.cpp:790-844). Batch shape [...]; returns
    (tex[3, ..., wsize*wsize], valid[...])."""
    idx = jnp.maximum(jnp.asarray(index, jnp.int32), 0)
    tl, dx2, dy2, new_level, valid = window_geometry(
        scene, idx, coord, pxaxis, pyaxis, normal, level, wsize,
        angle_threshold1,
    )
    s = wsize * wsize
    xs = jnp.arange(wsize, dtype=jnp.float32)
    # lattice coordinates as [..., S] per component (no trailing 2-dim)
    lat_x = jnp.tile(xs, wsize)      # sample index -> x offset count
    lat_y = jnp.repeat(xs, wsize)    # sample index -> y offset count
    shape = tl.shape[:-1] + (s,)
    gx = (
        tl[..., 0, None] + dx2[..., 0, None] * lat_x + dy2[..., 0, None] * lat_y
    )
    gy = (
        tl[..., 1, None] + dx2[..., 1, None] * lat_x + dy2[..., 1, None] * lat_y
    )
    lvl = jnp.broadcast_to(new_level[..., None], shape)
    iidx = jnp.broadcast_to(idx[..., None], shape)
    tex = sampling.sample_color_ch(scene, iidx, gx, gy, lvl, illum)
    return tex, valid


def normalize_tex(tex, channels: int, s: int):
    """Zero-mean normalization (reference optim.cpp:917-940) in the
    windows-major layout, with two folds that keep every later pass a
    plain lane reduction:

    - per-channel mean over the S live lanes of each block, joint RMS
      over all C*S live lanes (exactly optim.cpp:923-935);
    - duplicate lanes (>= s within each SPAD block) are ZEROED;
    - values are scaled by 1/sqrt(C*S), so `tex_dot` of two normalized
      rows is the reference's mean dot with no division.

    tex: [..., L] raw samples, L = channels * spad -> same shape."""
    L = tex.shape[-1]
    spad = L // channels
    lane = np.arange(L) % spad
    live = jnp.asarray((lane < s).astype(np.float32))
    texm = tex * live
    if channels == 1:
        ave = jnp.sum(texm, axis=-1, keepdims=True) / s
    else:
        # per-channel means via static lane masks (exact f32 sums),
        # broadcast back onto each block
        blk = np.arange(L) // spad
        ave = 0.0
        for c in range(channels):
            mc = jnp.asarray(
                ((blk == c) & (lane < s)).astype(np.float32)
            )
            ave = ave + jnp.sum(texm * mc, axis=-1, keepdims=True) / s * mc
    diff = (tex - ave) * live
    ssd = jnp.sum(diff * diff, axis=-1, keepdims=True)
    cs = channels * s
    msd = jnp.sqrt(ssd / cs)
    msd = jnp.where(msd == 0.0, 1.0, msd)
    return diff / (msd * math.sqrt(cs))


def tex_dot(tex0, tex1):
    """Mean elementwise product (reference optim.cpp:601-609): with the
    1/sqrt(C*S) fold of normalize_tex, the mean is a plain lane sum.
    Inputs [..., L]."""
    return jnp.sum(tex0 * tex1, axis=-1)


def texs_for_views(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    angle_threshold1: float,
    illum=0,
    luma: bool = False,
):
    """Windows for a [B, T] view list sharing per-patch plane axes.

    Plane axes come from the *reference* view views[:, 0] (reference
    optim.cpp:635-638: getPAxes on indexes[0] only). views == -1 marks
    padding. Returns (tex[T, B, L] normalized windows-major, valid
    [T, B]) — the windows-major layout (see module docstring)."""
    ref = jnp.maximum(views[..., 0], 0)
    pxaxis, pyaxis = cam.get_paxes(scene.cams, ref, coord, normal, level)

    B, T = views.shape
    views_t = views.T  # [T, B]
    idx = jnp.maximum(views_t, 0)
    tl, dx2, dy2, new_level, valid = window_geometry_views(
        scene, views_t, coord, pxaxis, pyaxis, normal, level, wsize,
        angle_threshold1,
    )
    if scene.view_mesh is not None:
        tex, channels = _sample_windows_view_sharded(
            scene, idx, tl, dx2, dy2, new_level, wsize, illum, luma,
        )
    else:
        tex, channels = sample_windows_raw(
            scene, idx, tl, dx2, dy2, new_level, wsize, illum, luma,
        )
    valid = valid & (views_t >= 0)
    return normalize_tex(tex, channels, wsize * wsize), valid


def sample_windows_raw(
    scene: Scene, idx, tl, dx2, dy2, new_level, wsize: int, illum, luma,
):
    """The sampling half of getTex on a [T, B] pair batch: raw
    (unnormalized) windows gathered from the scene's packed planes
    (4 int32 fetches per bilinear RGB sample; one per luma sample from
    the quad planes). Returns (tex[T, B, C * wsize^2], channels)."""
    T, B = idx.shape
    s = wsize * wsize
    xs = jnp.arange(wsize, dtype=jnp.float32)
    lat_x = jnp.tile(xs, wsize)[None, None, :]      # [1, 1, S]
    lat_y = jnp.repeat(xs, wsize)[None, None, :]
    gx = tl[:, :, 0, None] + dx2[:, :, 0, None] * lat_x + dy2[:, :, 0, None] * lat_y
    gy = tl[:, :, 1, None] + dx2[:, :, 1, None] * lat_x + dy2[:, :, 1, None] * lat_y
    lvl = jnp.broadcast_to(new_level[:, :, None], (T, B, s))
    iidx = jnp.broadcast_to(idx[:, :, None], (T, B, s))
    if luma and scene.planes_luma_quad is not None:
        tex = sampling.sample_luma_quad(scene, iidx, gx, gy, lvl, illum)
    elif scene.planes_packed is not None:
        tex = sampling.sample_color_ch_packed(scene, iidx, gx, gy, lvl, illum)
    else:
        tex = sampling.sample_color_ch(scene, iidx, gx, gy, lvl, illum)
    # [C, T, B, S] channel-leading gather output -> windows-major rows
    channels = tex.shape[0]
    tex = jnp.moveaxis(tex, 0, 2).reshape(T, B, channels * s)
    return tex, channels


def _sample_windows_view_sharded(
    scene: Scene, idx, tl, dx2, dy2, new_level, wsize: int, illum, luma,
):
    """sample_windows_raw with the plane arrays sharded over the view
    axis of scene.view_mesh (the TP analog; SURVEY.md §2): every device
    samples only the (pair, view) entries whose view it owns, on its
    local plane shard, and the disjoint contributions combine by psum
    over the `view` mesh axis (the collective replacing the reference's
    all-views loop, optim.cpp:420-425)."""
    import dataclasses
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = scene.view_mesh
    axis = scene.view_axis
    k = mesh.shape[axis]
    n_local = scene.n_images // k
    assert n_local * k == scene.n_images, (scene.n_images, k)

    # the worker scene: plane leaves sharded over views, cameras and
    # level metadata replicated, aux markers cleared so the local
    # sampling takes the plain path
    work = dataclasses.replace(scene, masks=None, covis=None, view_mesh=None)
    sharded = lambda leaf: None if leaf is None else P(axis)
    spec_scene = dataclasses.replace(
        work,
        planes=P(axis),
        cams=P(),
        lvl_offsets=P(),
        lvl_widths=P(),
        lvl_heights=P(),
        planes_packed=sharded(work.planes_packed),
        planes_luma_quad=sharded(work.planes_luma_quad),
    )
    # the channel count is static: the same path selection as
    # sample_windows_raw on the pre-shard scene
    channels = 1 if luma and scene.planes_luma_quad is not None else 3

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_scene, P(), P(), P(), P(), P()),
        out_specs=P(),
    )
    def _sample(scn, idxg, tl, dx2, dy2, new_level):
        from jax import lax

        base = lax.axis_index(axis) * n_local
        local = (idxg >= base) & (idxg < base + n_local)
        lidx = jnp.where(local, idxg - base, 0)
        tex, _ = sample_windows_raw(
            scn, lidx, tl, dx2, dy2, new_level, wsize, illum, luma,
        )
        tex = jnp.where(local[:, :, None], tex, 0.0)
        return lax.psum(tex, axis)

    return _sample(work, idx, tl, dx2, dy2, new_level), channels


def incc_cost(tex, valid, minimum):
    """cost_func aggregation (reference optim.cpp:401-468, pairwise=0):
    unweighted mean of robustincc(1 - dot(ref, other)) over valid others;
    2.0 when the reference window is invalid or fewer than minimum-1
    others are valid.

    tex: [T, B, L] normalized; valid: [T, B]; minimum: [B] or scalar.
    Returns cost [B]."""
    dots = tex_dot(tex[:1], tex)  # [T, B]
    r = robustincc(1.0 - dots)
    ok = valid & valid[:1]
    ok = ok.at[0].set(False)
    denom = jnp.sum(ok, axis=0)
    ans = jnp.sum(jnp.where(ok, r, 0.0), axis=0)
    cost = ans / jnp.maximum(denom, 1)
    cost = jnp.where(denom >= jnp.asarray(minimum) - 1, cost, 2.0)
    return jnp.where(valid[0], cost, 2.0)


def incc_weighted(tex, valid, weights, robust: bool = True):
    """computeINCC aggregation (reference optim.cpp:684-706): weighted
    mean of [robust]incc(1 - dot(ref, other)); 2.0 when no weight.
    tex: [T, B, L]; weights: batch-major [B, T]."""
    dots = tex_dot(tex[:1], tex)  # [T, B]
    incc = 1.0 - dots
    if robust:
        incc = robustincc(incc)
    w = weights.T  # [T, B]
    ok = valid & valid[:1]
    ok = ok.at[0].set(False)
    tw = jnp.sum(jnp.where(ok, w, 0.0), axis=0)
    score = jnp.sum(jnp.where(ok, incc * w, 0.0), axis=0)
    score = jnp.where(tw > 0.0, score / jnp.where(tw == 0, 1.0, tw), 2.0)
    return jnp.where(valid[0], score, 2.0)


def incc_vs_ref(tex, valid, robust: bool):
    """Per-view INCC against the reference view (reference
    optim.cpp:708-746): entry 0 is 0; invalid entries are 2.
    tex: [T, B, L]. Returns batch-major [B, T]."""
    dots = tex_dot(tex[:1], tex)  # [T, B]
    incc = 1.0 - dots
    if robust:
        incc = robustincc(incc)
    out = jnp.where(valid & valid[:1], incc, 2.0)
    out = out.at[0].set(jnp.where(valid[0], 0.0, 2.0))
    return out.T


def incc_pairwise(tex, valid, robust: bool):
    """All-pairs INCC matrix [B, T, T] (reference optim.cpp:748-783);
    diagonal 0, invalid pairs 2. tex [T, B, L], valid [T, B]."""
    T, B = valid.shape
    dots = jnp.einsum(
        "tbl,ubl->btu", tex, tex, precision=jax.lax.Precision.HIGHEST
    )
    incc = 1.0 - dots
    if robust:
        incc = robustincc(incc)
    vb = valid.T  # [B, T]
    pair_ok = vb[:, :, None] & vb[:, None, :]
    out = jnp.where(pair_ok, incc, 2.0)
    eye = jnp.eye(T, dtype=bool)[None]
    return jnp.where(eye, 0.0, out)


def compute_units(scene: Scene, views, coord, normal, level: int):
    """Per-view footprint units (reference optim.cpp:109-132):
    getUnit / (ray . normal), BIG when the view sees the back side."""
    idx = jnp.maximum(views, 0)
    unit = cam.get_unit(scene.cams, idx, coord[:, None, :], level)
    ray = _unit_ray_to_camera(scene, idx, coord[:, None, :])
    dot = _dot4(ray, normal[:, None, :])
    unit = jnp.where(dot > 0.0, unit / jnp.where(dot > 0, dot, 1.0), BIG)
    return jnp.where(views >= 0, unit, BIG)


def compute_weights(scene: Scene, views, coord, normal, level: int):
    """Resolution-ratio weights (reference optim.cpp:942-948):
    w_i = min(1, unit_0 / unit_i), w_0 = 1."""
    units = compute_units(scene, views, coord, normal, level)
    w = jnp.minimum(1.0, units[:, :1] / units)
    return w.at[:, 0].set(1.0)


def compute_patch_ncc_n(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    tau: int,
    angle_threshold1: float,
    n_illums: int = 1,
):
    """compute_patch_ncc dispatching on the (static) illumination count:
    the gauntlet's scoring entry point when the config wires
    multi-illumination through (config.use_illums; the reference's
    multi-illum getTex at optim.cpp:846-893 re-expressed live)."""
    if n_illums <= 1:
        return compute_patch_ncc(
            scene, views, coord, normal, level, wsize, tau,
            angle_threshold1,
        )
    return compute_patch_ncc_illums(
        scene, views, coord, normal, level, wsize, tau, angle_threshold1
    )


def compute_patch_ncc_illums(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    tau: int,
    angle_threshold1: float,
):
    """Multi-illumination NCC: the weighted robust INCC averaged over
    the illumination axis (the capability of the reference's
    multi-illum getTex, optim.cpp:846-893, whose consuming cost path
    was left dormant — each illumination is scored against the same
    geometry and the robust scores are averaged). Falls back to the
    single-illum score when the scene has one illumination."""
    v = views[:, :tau]
    weights = compute_weights(scene, v, coord, normal, level)
    nviews = jnp.sum(views >= 0, axis=1)
    scores = []
    for il in range(scene.n_illums):
        tex, valid = texs_for_views(
            scene, v, coord, normal, level, wsize, angle_threshold1,
            illum=il,
        )
        s = incc_weighted(tex, valid, weights, robust=True)
        scores.append(jnp.where(nviews < 2, 2.0, s))
    score = sum(scores) / len(scores)
    return 1.0 - unrobustincc(score)


def compute_patch_ncc(
    scene: Scene,
    views,
    coord,
    normal,
    level: int,
    wsize: int,
    tau: int,
    angle_threshold1: float,
):
    """PatchManager::computeNcc (reference patch_manager.cpp:401-404):
    ncc = 1 - unrobustincc(weighted robust INCC over the first tau views).

    views: [B, M] ordered view list (-1 pad). Returns ncc [B]."""
    v = views[:, :tau]
    weights = compute_weights(scene, v, coord, normal, level)
    tex, valid = texs_for_views(
        scene, v, coord, normal, level, wsize, angle_threshold1
    )
    nviews = jnp.sum(views >= 0, axis=1)
    score = incc_weighted(tex, valid, weights, robust=True)
    score = jnp.where(nviews < 2, 2.0, score)  # computeINCC size guard
    return 1.0 - unrobustincc(score)
