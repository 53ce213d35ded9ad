"""Device-side texture/mask sampling from flattened pyramids.

Replaces the reference's pointer-walking bilinear fetch (reference
image/image.cpp:447-471) and mask lookups (image.cpp:749-781) with
batched gathers over the Scene's flat pyramid planes. The pyramid level
may be a *traced* per-sample integer — level selection is just index
arithmetic against `lvl_offsets`/`lvl_widths`.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..image.scene import Scene


def _flatten_planes(scene: Scene):
    n, ni, t, _ = scene.planes.shape
    return scene.planes.reshape(n * ni * t, 3), ni, t


def sample_color_ch(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear color fetch, channel-LEADING output [3, ...].

    Gathers each RGB channel separately from the flat interleaved
    plane buffer and accumulates the four bilinear taps immediately, so
    only [..., S]-shaped arrays are materialized.
    """
    flat = scene.planes.reshape(-1)  # interleaved RGB
    ni = scene.planes.shape[1]
    t = scene.planes.shape[2]
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]

    lx = jnp.clip(x.astype(jnp.int32), 0, w - 2)
    ly = jnp.clip(y.astype(jnp.int32), 0, h - 2)
    dx1 = jnp.clip(x - lx.astype(x.dtype), 0.0, 1.0)
    dy1 = jnp.clip(y - ly.astype(y.dtype), 0.0, 1.0)
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1
    f00 = dx0 * dy0
    f10 = dx1 * dy0
    f01 = dx0 * dy1
    f11 = dx1 * dy1

    base = (
        (jnp.asarray(image_idx, jnp.int32) * ni + illum) * t
        + off + ly * w + lx
    ) * 3
    row = w * 3

    chans = []
    for c in range(3):
        b = base + c
        v = (
            jnp.take(flat, b) * f00
            + jnp.take(flat, b + 3) * f10
            + jnp.take(flat, b + row) * f01
            + jnp.take(flat, b + row + 3) * f11
        )
        chans.append(v)
    return jnp.stack(chans, axis=0)


def sample_color_ch_packed(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear fetch from the PACKED int32 planes, channel-leading
    [3, ...] output.

    Packing RGB u8 into one int32 turns 12 fetches per bilinear sample
    into 4 — pyramid levels are u8-quantized, so the packing is
    lossless. This is the engine's NCC window sampler (ops/ncc
    sample_windows_raw)."""
    flat = scene.planes_packed.reshape(-1)
    ni = scene.planes_packed.shape[1]
    t = scene.planes_packed.shape[2]
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]

    lx = jnp.clip(x.astype(jnp.int32), 0, w - 2)
    ly = jnp.clip(y.astype(jnp.int32), 0, h - 2)
    dx1 = jnp.clip(x - lx.astype(x.dtype), 0.0, 1.0)
    dy1 = jnp.clip(y - ly.astype(y.dtype), 0.0, 1.0)
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1
    f00 = dx0 * dy0
    f10 = dx1 * dy0
    f01 = dx0 * dy1
    f11 = dx1 * dy1

    base = (
        (jnp.asarray(image_idx, jnp.int32) * ni + illum) * t
        + off + ly * w + lx
    )

    r = g = b = 0.0
    for doff, wgt in ((0, f00), (1, f10), (w, f01), (w + 1, f11)):
        v = jnp.take(flat, base + doff)
        r = r + (v & 0xFF).astype(jnp.float32) * wgt
        g = g + ((v >> 8) & 0xFF).astype(jnp.float32) * wgt
        b = b + ((v >> 16) & 0xFF).astype(jnp.float32) * wgt
    return jnp.stack([r, g, b], axis=0)


def sample_luma_quad(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear LUMA fetch from the quad-packed planes: each int32
    holds the four u8 luminances of a pixel's 2x2 bilinear support, so
    one random fetch yields a complete bilinear sample — 12x fewer
    fetches than per-channel RGB. Returns [1, ...] (channel-leading,
    luma-only; the NCC math is channel-count agnostic).

    This powers the opt-in luma_mode fast path (DIVERGENCES.md): NCC on
    luminance instead of RGB, the common choice in GPU MVS pipelines."""
    flat = scene.planes_luma_quad.reshape(-1)
    ni = scene.planes_luma_quad.shape[1]
    t = scene.planes_luma_quad.shape[2]
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]

    lx = jnp.clip(x.astype(jnp.int32), 0, w - 2)
    ly = jnp.clip(y.astype(jnp.int32), 0, h - 2)
    dx1 = jnp.clip(x - lx.astype(x.dtype), 0.0, 1.0)
    dy1 = jnp.clip(y - ly.astype(y.dtype), 0.0, 1.0)
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1

    idx = (
        (jnp.asarray(image_idx, jnp.int32) * ni + illum) * t
        + off + ly * w + lx
    )
    v = jnp.take(flat, idx)
    y00 = (v & 0xFF).astype(jnp.float32)
    y10 = ((v >> 8) & 0xFF).astype(jnp.float32)
    y01 = ((v >> 16) & 0xFF).astype(jnp.float32)
    y11 = ((v >> 24) & 0xFF).astype(jnp.float32)
    out = (
        y00 * dx0 * dy0 + y10 * dx1 * dy0 + y01 * dx0 * dy1 + y11 * dx1 * dy1
    )
    return out[None]


def sample_color(scene: Scene, image_idx, x, y, level, illum=0):
    """Bilinear color fetch at float pixel coords (x, y) of `level`.

    Matches reference image.cpp:447-471: lx = int(x) truncation, weights
    from the fractional parts, 2x2 tap. Indices are clamped for safety —
    validity (border margins) is the caller's responsibility, as in the
    reference where getTexSafe pre-checks bounds (optim.cpp:895-915).

    image_idx, x, y, level broadcast; returns [..., 3] float32.
    """
    flat, ni, t = _flatten_planes(scene)
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]

    lx = jnp.clip(x.astype(jnp.int32), 0, w - 2)
    ly = jnp.clip(y.astype(jnp.int32), 0, h - 2)
    dx1 = jnp.clip(x - lx.astype(x.dtype), 0.0, 1.0)
    dy1 = jnp.clip(y - ly.astype(y.dtype), 0.0, 1.0)
    dx0 = 1.0 - dx1
    dy0 = 1.0 - dy1

    base = (jnp.asarray(image_idx, jnp.int32) * ni + illum) * t + off
    i00 = base + ly * w + lx
    i10 = i00 + 1
    i01 = i00 + w
    i11 = i01 + 1

    idx = jnp.stack([i00, i10, i01, i11], axis=-1)  # [..., 4]
    wts = jnp.stack(
        [dx0 * dy0, dx1 * dy0, dx0 * dy1, dx1 * dy1], axis=-1
    )  # [..., 4]
    taps = jnp.take(flat, idx, axis=0)  # [..., 4, 3]
    return jnp.sum(taps * wts[..., None], axis=-2)


def sample_color_bicubic(scene: Scene, image_idx, x, y, level, illum=0):
    """Bicubic color fetch (reference image.cpp:345-446, the
    PMMVPS_IMAGE_BICUBIC variant): 4x4 Catmull-Rom-style taps with the
    reference's exact weight polynomials. Channel-leading [3, ...]."""
    flat = scene.planes.reshape(-1)
    ni = scene.planes.shape[1]
    t = scene.planes.shape[2]
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]

    x1 = jnp.clip(jnp.floor(x).astype(jnp.int32), 1, w - 3)
    y1 = jnp.clip(jnp.floor(y).astype(jnp.int32), 1, h - 3)
    p = jnp.clip(x - x1.astype(x.dtype), 0.0, 1.0)
    q = jnp.clip(y - y1.astype(y.dtype), 0.0, 1.0)

    def w0(f):  # weight at offset -1 (reference: (((-1)f+5)f-8)f+4 at f=1+t)
        g = 1.0 + f
        return ((-g + 5.0) * g - 8.0) * g + 4.0

    def w1(f):  # weight at offset 0
        return ((f - 2.0) * f) * f + 1.0

    wx = (w0(p), w1(p), w1(1.0 - p), w0(1.0 - p))
    wy = (w0(q), w1(q), w1(1.0 - q), w0(1.0 - q))

    base = (
        (jnp.asarray(image_idx, jnp.int32) * ni + illum) * t
        + off + (y1 - 1) * w + (x1 - 1)
    ) * 3
    row = w * 3

    chans = []
    for c in range(3):
        acc = 0.0
        for j in range(4):
            rowacc = 0.0
            for i in range(4):
                rowacc = rowacc + jnp.take(
                    flat, base + c + j * row + i * 3
                ) * wx[i]
            acc = acc + rowacc * wy[j]
        chans.append(acc)
    return jnp.stack(chans, axis=0)


def sample_mask(scene: Scene, image_idx, x, y, level):
    """Nearest-neighbor mask lookup (reference image.cpp:749-781).

    Returns float: 255 inside, 0 outside, -1 when out of image bounds or
    when the scene has no masks.
    """
    if scene.masks is None:
        return jnp.full(jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y)), -1.0)
    level = jnp.asarray(level, dtype=jnp.int32)
    off = scene.lvl_offsets[level]
    w = scene.lvl_widths[level]
    h = scene.lvl_heights[level]
    ix = jnp.floor(x + 0.5).astype(jnp.int32)
    iy = jnp.floor(y + 0.5).astype(jnp.int32)
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    ixc = jnp.clip(ix, 0, w - 1)
    iyc = jnp.clip(iy, 0, h - 1)
    t = scene.masks.shape[1]
    flat = scene.masks.reshape(-1)
    val = jnp.take(flat, jnp.asarray(image_idx, jnp.int32) * t + off + iyc * w + ixc)
    return jnp.where(inb, val, -1.0)


def scene_mask_ok(scene: Scene, coord, level):
    """Scene-level mask test (reference photoSet.cpp:223-233): a point
    fails iff ANY view's mask maps it to 0; out-of-bounds (-1) passes.

    coord: [..., 4]; returns bool [...]."""
    if scene.masks is None:
        return jnp.ones(coord.shape[:-1], dtype=bool)
    from ..geometry import camera as cam

    n = scene.n_images
    idx = jnp.arange(n, dtype=jnp.int32).reshape((n,) + (1,) * (coord.ndim - 1))
    xy, _, valid = cam.project(scene.cams, idx, coord[None], level)
    vals = sample_mask(scene, idx, xy[..., 0], xy[..., 1], level)
    vals = jnp.where(valid, vals, -1.0)
    return jnp.all(vals != 0.0, axis=0)


def color_at_coord(scene: Scene, image_idx, coord, level, illum=0):
    """Photo::getColor — project then sample (reference photo.cpp:22-46)."""
    from ..geometry import camera as cam

    xy, _, valid = cam.project(scene.cams, image_idx, coord, level)
    col = sample_color(scene, image_idx, xy[..., 0], xy[..., 1], level, illum)
    return jnp.where(valid[..., None], col, 0.0)
