"""Scene container: cameras + image pyramids + masks as dense arrays.

Dense-array replacement for the reference's PhotoSet/Photo/Image object
graph (reference: image/photoSet.{hpp,cpp}, image/image.{hpp,cpp}).
All views are stacked into single arrays; pyramid levels are flattened
and concatenated per view so that a *traced* per-sample pyramid level
becomes plain index arithmetic:

    planes[v, illum, lvl_offsets[l] + y * lvl_widths[l] + x, :]

which is what lets the dynamic level selection of the texture fetch
(reference optim.cpp:806-811) live inside one jitted kernel.

Pyramid construction matches the reference bit-for-bit (golden-parity
oracle in tests/test_golden_parity.py): [1 3 3 1] x [1 3 3 1] separable
kernel, stride 2, out-of-bounds taps skipped without renormalization
(reference image.cpp:268-277), per-level re-quantization to uint8 via
floor(c + 0.5) (image.cpp:308-310). Masks use the OR-dilating 2x2
pyramid (image.cpp:717-747).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import CameraSet, load_camera_set, make_camera_set
from . import decode

# ----------------------------------------------------------------------
# pyramid construction (host side, numpy)
# ----------------------------------------------------------------------

_K1D = np.array([1.0, 3.0, 3.0, 1.0])
_K2D = np.outer(_K1D, _K1D) / 64.0


def level_dims(width: int, height: int, max_level: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-level dims by successive halving (reference image.cpp:135-138)."""
    ws, hs = [width], [height]
    for _ in range(1, max_level):
        ws.append(ws[-1] // 2)
        hs.append(hs[-1] // 2)
    return tuple(ws), tuple(hs)


def downsample_once(img: np.ndarray, filter: int = 0) -> np.ndarray:
    """One pyramid level step on a [H, W, C] float image.

    filter mirrors the reference (image.cpp:284-298):
      0 = [1 3 3 1]^2 weighted average (the live path),
      1 = max over the 4x4 support,
      2 = min over the 4x4 support.
    Returns the unquantized float result (caller re-quantizes)."""
    h, w = img.shape[:2]
    ho, wo = h // 2, w // 2
    # reference image.cpp:268-277: taps outside [0, h-1] x [0, w-1] are
    # skipped with no weight renormalization; the last parent row/col
    # (ytmp == h-1) DOES contribute (the guard is `h - 1 < ytmp`).
    # Zero/255 padding reproduces the skip exactly.
    src = np.array(img, dtype=np.float32)
    fill = 0.0 if filter != 2 else 255.0
    pad = np.full((h + 3, w + 3) + img.shape[2:], fill, dtype=np.float32)
    pad[1 : 1 + h, 1 : 1 + w] = src
    if filter == 0:
        out = np.zeros((ho, wo) + img.shape[2:], dtype=np.float32)
    elif filter == 1:
        out = np.zeros((ho, wo) + img.shape[2:], dtype=np.float32)
    else:
        out = np.full((ho, wo) + img.shape[2:], 255.0, dtype=np.float32)
    for i in range(-1, 3):
        for j in range(-1, 3):
            tap = pad[
                1 + i : 1 + i + 2 * ho : 2, 1 + j : 1 + j + 2 * wo : 2
            ]
            if filter == 0:
                out += _K2D[i + 1, j + 1] * tap
            elif filter == 1:
                out = np.maximum(out, tap)
            else:
                out = np.minimum(out, tap)
    return out


def build_pyramid(
    img_u8: np.ndarray, max_level: int, filter: int = 0
) -> List[np.ndarray]:
    """Full image pyramid, re-quantized to uint8 values per level
    (kept as float32 for the device)."""
    levels = [np.asarray(img_u8, dtype=np.float32)]
    for _ in range(1, max_level):
        down = downsample_once(levels[-1], filter)
        down = np.clip(np.floor(down + 0.5), 0.0, 255.0)
        levels.append(down.astype(np.float32))
    return levels


def build_mask_pyramid(mask_u8: np.ndarray, max_level: int) -> List[np.ndarray]:
    """OR-dilating mask pyramid (reference image.cpp:717-747)."""
    levels = [np.asarray(mask_u8, dtype=np.uint8)]
    for _ in range(1, max_level):
        prev = levels[-1]
        h, w = prev.shape
        ho, wo = h // 2, w // 2
        ys0 = 2 * np.arange(ho)
        ys1 = np.minimum(h - 1, ys0 + 1)
        xs0 = 2 * np.arange(wo)
        xs1 = np.minimum(w - 1, xs0 + 1)
        acc = (
            prev[np.ix_(ys0, xs0)].astype(np.int32)
            + prev[np.ix_(ys0, xs1)]
            + prev[np.ix_(ys1, xs0)]
            + prev[np.ix_(ys1, xs1)]
        )
        levels.append(np.where(acc > 0, 255, 0).astype(np.uint8))
    return levels


# ----------------------------------------------------------------------
# Scene pytree
# ----------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Scene:
    """All per-scene device state.

    planes : [n_images, n_illums, total_px, 3] f32 — flattened pyramids
    masks  : [n_images, total_px] f32 in {0, 255}, or None
    cams   : CameraSet
    lvl_offsets/widths/heights : [L] i32 device copies of the static meta
    """

    planes: jnp.ndarray
    masks: Optional[jnp.ndarray]
    cams: CameraSet
    lvl_offsets: jnp.ndarray
    lvl_widths: jnp.ndarray
    lvl_heights: jnp.ndarray
    # packed RGB (r | g<<8 | b<<16) int32 per pixel — the NCC sampler's
    # operand: one random fetch returns all 3 channels (pyramid levels
    # are u8-quantized, so packing is lossless)
    planes_packed: Optional[jnp.ndarray] = None
    # packed 2x2 LUMA quad (y00|y10<<8|y01<<16|y11<<24) int32 per pixel:
    # ONE fetch yields a full bilinear sample (luma-NCC fast mode)
    planes_luma_quad: Optional[jnp.ndarray] = None
    # optional [n, n] bool covisibility (vis.dat); None = all pairs
    covis: Optional[jnp.ndarray] = None
    # static:
    widths: Tuple[int, ...] = dataclasses.field(default=())
    heights: Tuple[int, ...] = dataclasses.field(default=())
    offsets: Tuple[int, ...] = dataclasses.field(default=())
    max_level: int = 0
    # view-sharding marker (parallel/shard.enable_view_sharding): when
    # set, every texture fetch in ops/ncc.texs_for_views runs under
    # shard_map with the plane arrays sharded over this mesh axis and
    # the cross-view windows combined by psum (the TP analog; SURVEY.md
    # §2). The mesh is static metadata — it participates in jit cache
    # keys, not in tracing.
    view_mesh: Optional[object] = None
    view_axis: str = "view"

    def tree_flatten(self):
        children = (
            self.planes,
            self.masks,
            self.cams,
            self.lvl_offsets,
            self.lvl_widths,
            self.lvl_heights,
            self.planes_packed,
            self.planes_luma_quad,
            self.covis,
        )
        aux = (
            self.widths, self.heights, self.offsets, self.max_level,
            self.view_mesh, self.view_axis,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    @property
    def n_images(self) -> int:
        return self.planes.shape[0]

    @property
    def n_illums(self) -> int:
        return self.planes.shape[1]

    @property
    def has_mask(self) -> bool:
        return self.masks is not None

    def width(self, level: int) -> int:
        return self.widths[level]

    def height(self, level: int) -> int:
        return self.heights[level]


def pairwise_view_distances(scene: "Scene") -> np.ndarray:
    """PhotoSet::setDistances (reference photoSet.cpp:105-148): optical
    center distances normalized by their mean, plus an angular penalty
    max(0, 1 - axis_i . axis_j - cos 10deg). The reference computes this
    and never consumes it; exposed here as scene statistics (useful for
    view-pair selection heuristics)."""
    centers = np.asarray(scene.cams.center)[:, :3]
    n = centers.shape[0]
    diff = centers[:, None, :] - centers[None, :, :]
    dist = np.linalg.norm(diff, axis=-1)
    off = ~np.eye(n, dtype=bool)
    denom = off.sum()
    if denom == 0:
        return dist
    avedis = dist[off].mean()
    if avedis == 0.0:
        raise ValueError("all the optical centers are identical")
    dist = dist / avedis
    axes = np.asarray(scene.cams.oaxis)[:, :3]
    margin = np.cos(np.deg2rad(10.0))
    ang = np.maximum(0.0, 1.0 - axes @ axes.T - margin)
    return dist + ang


def scene_from_arrays(
    projections: np.ndarray,
    images: Sequence[np.ndarray],
    masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    max_level: int = 4,
    cams: Optional[CameraSet] = None,
) -> Scene:
    """Build a Scene from in-memory arrays.

    images: per view either [H, W, 3] or [n_illums, H, W, 3] uint8.
    All views must share dimensions (pad beforehand otherwise).
    """
    imgs = []
    for im in images:
        a = np.asarray(im)
        if a.ndim == 3:
            a = a[None]
        imgs.append(a)
    n = len(imgs)
    n_illums = imgs[0].shape[0]
    h, w = imgs[0].shape[1:3]
    for a in imgs:
        assert a.shape == (n_illums, h, w, 3), "all views must share dims"

    ws, hs = level_dims(w, h, max_level)
    offsets = []
    total = 0
    for l in range(max_level):
        offsets.append(total)
        total += ws[l] * hs[l]
    offsets = tuple(offsets)

    planes = np.zeros((n, n_illums, total, 3), dtype=np.float32)
    for v in range(n):
        for il in range(n_illums):
            pyr = build_pyramid(imgs[v][il], max_level)
            for l in range(max_level):
                planes[v, il, offsets[l] : offsets[l] + ws[l] * hs[l]] = pyr[
                    l
                ].reshape(-1, 3)

    mask_arr = None
    if masks is not None and any(m is not None for m in masks):
        mask_arr = np.full((n, total), 255.0, dtype=np.float32)
        for v in range(n):
            if masks[v] is None:
                continue
            mpyr = build_mask_pyramid(masks[v], max_level)
            for l in range(max_level):
                mask_arr[v, offsets[l] : offsets[l] + ws[l] * hs[l]] = (
                    mpyr[l].reshape(-1).astype(np.float32)
                )

    if cams is None:
        cams = make_camera_set(projections)
    packed = (
        planes[..., 0].astype(np.int32)
        | (planes[..., 1].astype(np.int32) << 8)
        | (planes[..., 2].astype(np.int32) << 16)
    )
    # luma quad: per pixel, the 2x2 bilinear support's luminances packed
    # into one int32 (per level; x+1/y+1 clamped at level edges)
    luma = np.clip(np.round(
        0.299 * planes[..., 0] + 0.587 * planes[..., 1]
        + 0.114 * planes[..., 2]
    ), 0, 255).astype(np.int32)
    lq = np.zeros_like(luma)
    for l in range(max_level):
        o, wl, hl = offsets[l], ws[l], hs[l]
        lv = luma[..., o : o + wl * hl].reshape(n, n_illums, hl, wl)
        xp = np.minimum(np.arange(wl) + 1, wl - 1)
        yp = np.minimum(np.arange(hl) + 1, hl - 1)
        q = (
            lv
            | (lv[..., :, xp] << 8)
            | (lv[..., yp, :] << 16)
            | (lv[..., yp, :][..., :, xp] << 24)
        )
        lq[..., o : o + wl * hl] = q.reshape(n, n_illums, -1)
    return Scene(
        planes=jnp.asarray(planes),
        masks=None if mask_arr is None else jnp.asarray(mask_arr),
        planes_packed=jnp.asarray(packed),
        planes_luma_quad=jnp.asarray(lq),
        cams=cams,
        lvl_offsets=jnp.asarray(offsets, dtype=jnp.int32),
        lvl_widths=jnp.asarray(ws, dtype=jnp.int32),
        lvl_heights=jnp.asarray(hs, dtype=jnp.int32),
        widths=ws,
        heights=hs,
        offsets=offsets,
        max_level=max_level,
    )


def load_visdata(path: str, image_ids: Sequence[int]) -> Optional[np.ndarray]:
    """Parse a PMVS-style vis.dat covisibility file:
        VISDATA
        <n>
        <id> <k> <id_0> ... <id_{k-1}>   (one row per image)
    Returns [n, n] bool over the configured image list (diagonal True),
    or None if the file does not exist. The reference declares the
    useVisData option but leaves this branch unimplemented
    (option.cpp:167-169)."""
    import os as _os

    if not _os.path.exists(path):
        return None
    with open(path) as f:
        toks = f.read().split()
    if not toks or toks[0] != "VISDATA":
        raise ValueError(f"bad vis.dat header in {path}")
    id2idx = {img: i for i, img in enumerate(image_ids)}
    n = len(image_ids)
    covis = np.eye(n, dtype=bool)
    pos = 1
    count = int(toks[pos]); pos += 1
    for _ in range(count):
        img = int(toks[pos]); k = int(toks[pos + 1]); pos += 2
        row = [int(v) for v in toks[pos : pos + k]]; pos += k
        if img not in id2idx:
            continue
        i = id2idx[img]
        for v in row:
            if v in id2idx:
                covis[i, id2idx[v]] = True
    return covis


def load_scene(prefix: str, image_ids: Sequence[int], nillums: int, max_level: int, use_vis_data: bool = False) -> Scene:
    """Load a scene from the reference dataset directory contract
    (reference photoSet.cpp:20-61):

      image/%04d%04d.{jpg,ppm,png,tiff}  view x illumination
      txt/%08d.txt                       CONTOUR camera files
      mask/%08d.{pgm,pbm}                optional masks
    """
    n = len(image_ids)
    cam_paths = [os.path.join(prefix, "txt", f"{i:08d}.txt") for i in range(n)]
    cams = load_camera_set(cam_paths)

    images = []
    masks = []
    for i in range(n):
        illums = []
        for il in range(nillums):
            base = os.path.join(prefix, "image", f"{i:04d}{il:04d}")
            path = None
            for ext in (".jpg", ".jpeg", ".ppm", ".png", ".tiff"):
                if os.path.exists(base + ext):
                    path = base + ext
                    break
            if path is None:
                raise FileNotFoundError(f"no image for view {i} illum {il}: {base}.*")
            illums.append(decode.load_rgb(path))
        images.append(np.stack(illums))
        masks.append(decode.load_mask(os.path.join(prefix, "mask", f"{i:08d}")))

    scene = scene_from_arrays(
        projections=np.asarray(cams.P, dtype=np.float64),
        images=images,
        masks=masks,
        max_level=max_level,
        cams=cams,
    )
    if use_vis_data:
        covis = load_visdata(os.path.join(prefix, "vis.dat"), image_ids)
        if covis is not None:
            scene = dataclasses.replace(scene, covis=jnp.asarray(covis))
    return scene
