"""Vectorized pinhole camera model for the PM-MVS engine.

Array-first re-expression of the reference camera (reference:
image/camera.{hpp,cpp}). Instead of one C++ object per view with a
vector of per-level 3x4 matrices, all cameras live in a single struct of
arrays (`CameraSet`), and the per-level projection collapses to a scale:
``P_level = diag(2^-l, 2^-l, 1) @ P_0`` (reference camera.cpp:91-100
halves rows 0 and 1 per level), so only ``P_0`` is stored and levels may
be *traced* per-sample — which is what makes the dynamic level selection
of the texture fetch (reference optim.cpp:806-811) jit-compatible.

File formats supported: CONTOUR (raw 3x4), CONTOUR2 (K + Euler
angles/translation) — reference camera.cpp:102-141.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel returned by project() for points behind the camera
# (reference camera.cpp:313-315).
BEHIND = -65535.0


class CameraSet(NamedTuple):
    """All cameras of a scene as dense arrays (pytree).

    Fields (n = number of views):
      P        [n, 3, 4]  level-0 projection matrices
      Minv     [n, 3, 3]  inverse of P[:, :3, :3] (for unproject)
      center   [n, 4]     optical centers, homogeneous w=1 (camera.cpp:295-308)
      oaxis    [n, 4]     optical axis row, normalized (camera.cpp:68-69)
      xaxis    [n, 3]     orthonormal camera axes as recomputed by
      yaxis    [n, 3]     Optim::setAxesScales (reference optim.cpp:43-55);
      zaxis    [n, 3]     identical to Camera::updateCamera's axes
      ipscale  [n]        fx + fy (reference optim.cpp:57-64)
      ipscale_cam [n]     (|row0|+|row1|)/2 (reference camera.cpp:80-88)
    """

    P: jnp.ndarray
    Minv: jnp.ndarray
    center: jnp.ndarray
    oaxis: jnp.ndarray
    xaxis: jnp.ndarray
    yaxis: jnp.ndarray
    zaxis: jnp.ndarray
    ipscale: jnp.ndarray
    ipscale_cam: jnp.ndarray

    @property
    def n_images(self) -> int:
        return self.P.shape[0]


# ----------------------------------------------------------------------
# Construction (host-side, numpy)
# ----------------------------------------------------------------------

def quat2proj(q: Sequence[float]) -> np.ndarray:
    """Euler-angle (degrees) + translation -> 4x4 [R|t] (camera.cpp:241-261)."""
    a, b, g = (math.radians(q[0]), math.radians(q[1]), math.radians(q[2]))
    s1, s2, s3 = math.sin(a), math.sin(b), math.sin(g)
    c1, c2, c3 = math.cos(a), math.cos(b), math.cos(g)
    proj = np.zeros((4, 4), dtype=np.float64)
    proj[0, 0] = c2 * c3
    proj[0, 1] = c3 * s2 * s1 - s3 * c1
    proj[1, 0] = s3 * c2
    proj[1, 1] = s3 * s2 * s1 + c3 * c1
    proj[2, 0] = -s2
    proj[2, 1] = c2 * s1
    proj[0, 2] = c3 * s2 * c1 + s3 * s1
    proj[1, 2] = s3 * s2 * c1 - c3 * s1
    proj[2, 2] = c2 * c1
    proj[0, 3] = q[3]
    proj[1, 3] = q[4]
    proj[2, 3] = q[5]
    proj[3, 3] = 1.0
    return proj


def proj2quat(proj: np.ndarray) -> np.ndarray:
    """4x4 [R|t] -> Euler angles (degrees) + translation (camera.cpp:199-239)."""
    q = np.zeros(6, dtype=np.float64)
    q[3:6] = proj[0:3, 3]
    if proj[2, 0] == 1.0:
        q[1] = -math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(-proj[0, 1], proj[1, 1])
    elif proj[2, 0] == -1.0:
        q[1] = math.pi / 2.0
        q[2] = 0.0
        q[0] = math.atan2(proj[0, 1], proj[1, 1])
    else:
        q[1] = math.asin(-proj[2, 0])
        s = 1.0 if math.cos(q[1]) > 0.0 else -1.0
        q[0] = math.atan2(proj[2, 1] * s, proj[2, 2] * s)
        q[2] = math.atan2(proj[1, 0] * s, proj[0, 0] * s)
    q[0:3] = np.degrees(q[0:3])
    for i in range(3):
        if abs(q[i]) > 180.0:
            q[i] = q[i] - 360.0 if q[i] > 0 else q[i] + 360.0
    return q


def projection_from_params(
    intrinsics: Sequence[float], extrinsics: Sequence[float], txt_type: int
) -> np.ndarray:
    """Build the level-0 3x4 projection (reference camera.cpp:102-141)."""
    if txt_type == 0:  # CONTOUR: 12 raw entries, row-major
        params = list(intrinsics) + list(extrinsics)
        return np.array(params, dtype=np.float64).reshape(3, 4)
    if txt_type == 2:  # CONTOUR2: K(fx, fy, skew, cx, cy) * [R|t]
        fx, fy, skew, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], \
            intrinsics[3], intrinsics[4]
        K = np.array(
            [
                [fx, skew, cx, 0.0],
                [0.0, fy, cy, 0.0],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )
        Rt = quat2proj(extrinsics)
        return (K @ Rt)[0:3, 0:4]
    raise ValueError(f"Unsupported camera txt type: {txt_type}")


def parse_camera_file(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Read a CONTOUR/CONTOUR2 camera text file (camera.cpp:27-55)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    header = tokens[0]
    if header == "CONTOUR":
        txt_type = 0
    elif header == "CONTOUR2":
        txt_type = 2
    elif header == "CONTOUR3":
        txt_type = 3
    else:
        raise ValueError(f"Unrecognizable camera text format: {header}")
    vals = [float(t) for t in tokens[1:13]]
    return np.array(vals[:6]), np.array(vals[6:12]), txt_type


def write_camera_file(path: str, intrinsics, extrinsics, txt_type: int) -> None:
    """Write a camera file (reference camera.cpp:263-292)."""
    with open(path, "w") as f:
        if txt_type == 0:
            f.write("CONTOUR\n")
        elif txt_type == 2:
            f.write("CONTOUR2\n")
        else:
            raise ValueError(f"Incorrect txt type {txt_type}")
        f.write(" ".join(repr(float(v)) for v in intrinsics) + "\n")
        f.write(" ".join(repr(float(v)) for v in extrinsics) + "\n")


def make_camera_set(projections: np.ndarray, dtype=jnp.float32) -> CameraSet:
    """Derive all per-camera quantities from level-0 P matrices.

    Mirrors Camera::updateCamera (camera.cpp:65-89) + Optim::setAxesScales
    (optim.cpp:43-65).
    """
    P = np.asarray(projections, dtype=np.float64)
    assert P.ndim == 3 and P.shape[1:] == (3, 4), P.shape
    n = P.shape[0]

    M = P[:, :, :3]
    q = P[:, :, 3]
    Minv = np.linalg.inv(M)
    center3 = -np.einsum("nij,nj->ni", Minv, q)
    center = np.concatenate([center3, np.ones((n, 1))], axis=1)

    oaxis = P[:, 2, :].copy()
    oaxis /= np.linalg.norm(oaxis[:, :3], axis=1, keepdims=True)

    zaxis = oaxis[:, :3].copy()
    xaxis = P[:, 0, :3].copy()
    yaxis = np.cross(zaxis, xaxis)
    yaxis /= np.linalg.norm(yaxis, axis=1, keepdims=True)
    xaxis = np.cross(yaxis, zaxis)

    # Optim ipscale: fx + fy (optim.cpp:57-64)
    fx = np.einsum("ni,ni->n", P[:, 0, :3], xaxis)
    fy = np.einsum("ni,ni->n", P[:, 1, :3], yaxis)
    ipscale = fx + fy

    # Camera ipscale: mean row norm (camera.cpp:80-88)
    n0 = np.linalg.norm(P[:, 0, :3], axis=1)
    n1 = np.linalg.norm(P[:, 1, :3], axis=1)
    ipscale_cam = (n0 + n1) / 2.0
    ipscale_cam = np.where(ipscale_cam == 0.0, 1.0, ipscale_cam)

    conv = lambda a: jnp.asarray(a, dtype=dtype)
    return CameraSet(
        P=conv(P),
        Minv=conv(Minv),
        center=conv(center),
        oaxis=conv(oaxis),
        xaxis=conv(xaxis),
        yaxis=conv(yaxis),
        zaxis=conv(zaxis),
        ipscale=conv(ipscale),
        ipscale_cam=conv(ipscale_cam),
    )


def load_camera_set(paths: Sequence[str], dtype=jnp.float32) -> CameraSet:
    projs = []
    for p in paths:
        intr, extr, txt_type = parse_camera_file(p)
        projs.append(projection_from_params(intr, extr, txt_type))
    return make_camera_set(np.stack(projs), dtype=dtype)


# ----------------------------------------------------------------------
# Device-side geometry ops (jnp; `index` may be a traced integer array,
# `coord` homogeneous with w=1; everything broadcasts over leading dims)
# ----------------------------------------------------------------------

def level_scale(level) -> jnp.ndarray:
    """2^level as float; `level` may be traced."""
    return jnp.exp2(jnp.asarray(level, dtype=jnp.float32))


def project(cams: CameraSet, index, coord, level=0):
    """Project homogeneous points into view `index` at pyramid `level`.

    Returns (xy[..., 2], depth_denominator[...], valid[...]).
    Mirrors Camera::project (camera.cpp:310-326): behind-camera points get
    the BEHIND sentinel and valid=False.
    """
    Pm = cams.P[index]  # [..., 3, 4]
    ic = jnp.einsum(
        "...ij,...j->...i", Pm, coord, precision=jax.lax.Precision.HIGHEST
    )
    z = ic[..., 2]
    valid = z > 0.0
    safe_z = jnp.where(valid, z, 1.0)
    s = level_scale(level)
    xy = ic[..., :2] / (safe_z * s)[..., None]
    xy = jnp.clip(xy, -1e9, 1e9)
    xy = jnp.where(valid[..., None], xy, BEHIND)
    return xy, z, valid


def project_xy_lists(cams: CameraSet, index, coord, level=0):
    """Camera::project for a [N] coord batch against a [N, M] view-index
    list, WITHOUT the per-pair P gather of `project`.

    `project(cams, idx, coord[:, None], level)` materializes
    P[idx] = f32[N, M, 3, 4], a large temporary at full table capacity
    (whether it is cheaper on the GPU is ROADMAP C4). Projection is
    linear, so instead ONE [N, 4] @ [4, 3V]
    f32-HIGHEST matmul projects every point into every view and a
    static one-hot sweep picks each list entry's view; every
    intermediate stays [N, M]-shaped (no trailing 3/4 axis to pad).
    Same semantics as `project` (camera.cpp:310-326): behind-camera
    pairs get BEHIND and valid=False.

    Returns (x[N, M], y[N, M], valid[N, M])."""
    V = cams.P.shape[0]
    prec = jax.lax.Precision.HIGHEST
    Pcat = cams.P.reshape(V * 3, 4).T.astype(jnp.float32)  # [4, 3V]
    q = jnp.dot(coord.astype(jnp.float32), Pcat, precision=prec)
    ix = jnp.zeros(index.shape, jnp.float32)
    iy = jnp.zeros(index.shape, jnp.float32)
    iz = jnp.zeros(index.shape, jnp.float32)
    for v in range(V):
        m = index == v
        ix = jnp.where(m, q[:, None, 3 * v + 0], ix)
        iy = jnp.where(m, q[:, None, 3 * v + 1], iy)
        iz = jnp.where(m, q[:, None, 3 * v + 2], iz)
    valid = iz > 0.0
    safe_z = jnp.where(valid, iz, 1.0) * level_scale(level)
    x = jnp.clip(ix / safe_z, -1e9, 1e9)
    y = jnp.clip(iy / safe_z, -1e9, 1e9)
    x = jnp.where(valid, x, BEHIND)
    y = jnp.where(valid, y, BEHIND)
    return x, y, valid


def unproject(cams: CameraSet, index, xy, pz, level=0):
    """Inverse of projection (reference camera.cpp:329-337).

    `xy` is the pixel coordinate at `level`; `pz` is the projective depth
    denominator (third coordinate of P@X). Returns homogeneous [..., 4].
    """
    s = level_scale(level)
    b = jnp.stack(
        [xy[..., 0] * s * pz, xy[..., 1] * s * pz, pz], axis=-1
    ) - cams.P[index][..., :, 3]
    pt3 = jnp.einsum(
        "...ij,...j->...i", cams.Minv[index], b,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jnp.concatenate([pt3, jnp.ones_like(pt3[..., :1])], axis=-1)


def compute_depth(cams: CameraSet, index, coord):
    """Optical-axis depth (reference camera.cpp:339-346)."""
    return jnp.einsum(
        "...i,...i->...", cams.oaxis[index], coord,
        precision=jax.lax.Precision.HIGHEST,
    )


def get_unit(cams: CameraSet, index, coord, level):
    """Pixel footprint in scene units (reference optim.cpp:34-41):
    2 * ||coord - center|| * 2^level / (fx + fy)."""
    fz = jnp.linalg.norm(coord - cams.center[index], axis=-1)
    ips = cams.ipscale[index]
    unit = 2.0 * fz * level_scale(level) / jnp.where(ips == 0.0, 1.0, ips)
    return jnp.where(ips == 0.0, 1.0, unit)


def get_paxes(cams: CameraSet, index, coord, normal, level):
    """Patch-plane axes scaled to ~1 pixel in view `index`.

    Mirrors Optim::getPAxes (optim.cpp:67-84): build an orthonormal frame
    on the patch plane from the camera x-axis, scale by the pixel
    footprint, then normalize by the actual projected displacement.
    Returns (pxaxis[...,4], pyaxis[...,4]).
    """
    pscale = get_unit(cams, index, coord, level)
    normal3 = normal[..., :3]
    yaxis3 = jnp.cross(normal3, cams.xaxis[index])
    yaxis3 = yaxis3 / _safe_norm(yaxis3)
    xaxis3 = jnp.cross(yaxis3, normal3)

    zeros = jnp.zeros_like(xaxis3[..., :1])
    pxaxis = jnp.concatenate([xaxis3, zeros], axis=-1) * pscale[..., None]
    pyaxis = jnp.concatenate([yaxis3, zeros], axis=-1) * pscale[..., None]

    c_xy, _, _ = project(cams, index, coord, level)
    px_xy, _, _ = project(cams, index, coord + pxaxis, level)
    py_xy, _, _ = project(cams, index, coord + pyaxis, level)
    xdis = _safe_norm(px_xy - c_xy)[..., 0]
    ydis = _safe_norm(py_xy - c_xy)[..., 0]
    pxaxis = pxaxis / xdis[..., None]
    pyaxis = pyaxis / ydis[..., None]
    return pxaxis, pyaxis


def get_scale_cam(cams: CameraSet, index, coord, level):
    """Camera::getScale variant using the mean-row-norm ipscale
    (reference camera.cpp:349-364)."""
    ray = coord - cams.center[index]
    return (
        jnp.linalg.norm(ray, axis=-1)
        * level_scale(level)
        / cams.ipscale_cam[index]
    )


def _safe_norm(v, eps=1e-20):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))
