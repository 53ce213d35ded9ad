"""Every f32 contraction on the geometry path asks for full precision.

A GPU may run a default-precision f32 dot or einsum in TF32, whose
10-bit mantissa keeps about three decimal digits. A projection of a
640-pixel-wide view then moves by ~0.3 px, which on its own exceeds the
2e-4 NCC-cost bound of the golden parity tests. These are 3x4 and 4x4
products, so `Precision.HIGHEST` costs nothing. The CPU ignores the
setting, so the test reads it from the lowered program: every
`dot_general` must carry `precision = [HIGHEST, HIGHEST]`.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvskit_tpu.core import grid as gridmod
from mvskit_tpu.geometry import camera as cam
from mvskit_tpu.ops import ncc as nccops
from mvskit_tpu.pipeline import filters as fl
from mvskit_tpu.pipeline import views as vw
from mvskit_tpu.utils import synthetic

from test_grid import make_seeded_table

LEVEL = 1


@pytest.fixture(scope="module")
def sp():
    Ps, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120)
    coord, normal = synthetic.plane_points(Ps, 16, extent=0.6)
    coord = jnp.asarray(coord, jnp.float32)
    normal = jnp.asarray(normal, jnp.float32)
    table = make_seeded_table(scene, coord, normal, capacity=64)
    views = jnp.tile(jnp.arange(6, dtype=jnp.int32), (16, 1))
    return scene, table, coord, normal, views


CASES = {
    "project": lambda s, t, c, n, v: cam.project(
        s.cams, v[:, 0], c, LEVEL),
    "unproject": lambda s, t, c, n, v: cam.unproject(
        s.cams, v[:, 0], c[:, :2], c[:, 2] + 1.0, LEVEL),
    "compute_depth": lambda s, t, c, n, v: cam.compute_depth(
        s.cams, v[:, 0], c),
    "check_angles": lambda s, t, c, n, v: vw.check_angles(
        s, c, v, 0.1, 0.5),
    "build_depth_maps": lambda s, t, c, n, v: gridmod.build_depth_maps(
        s, t, LEVEL, 2),
    "quad_residuals": lambda s, t, c, n, v: fl.quad_residuals_batch(
        s, t, c, n, v, jnp.tile(jnp.arange(8, dtype=jnp.int32), (16, 1)),
        LEVEL, 6),
    "gain_batch": lambda s, t, c, n, v: fl.gain_batch(
        s, gridmod.build_grid(s, t, LEVEL, 2, 4), t, c, n,
        jnp.ones((16,)), jnp.full((16,), 0.8), t.images[:16],
        t.vimages[:16], jnp.arange(16), LEVEL, 2, 0.6, 1.0),
    "window_geometry_views": lambda s, t, c, n, v: (
        nccops.window_geometry_views(
            s, v.T, c, c * 0.01, c * 0.01, n, LEVEL, 7, math.radians(60))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_contractions_ask_for_highest(sp, name):
    text = jax.jit(CASES[name]).lower(*sp).as_text()
    dots = [l for l in text.splitlines() if "dot_general" in l]
    assert dots, f"{name}: no contraction lowered"
    loose = [l.strip() for l in dots if "precision = [HIGHEST, HIGHEST]" not in l]
    assert not loose, f"{name}: default-precision contraction: {loose[0]}"


def test_project_matches_float64_at_full_width():
    """f32 projection at 640x480 agrees with a float64 NumPy projection
    to 1e-3 px: what f32 arithmetic itself allows at these magnitudes,
    and ~300x tighter than a TF32 contraction would land."""
    Ps = synthetic.ring_cameras(16, 640, 480)
    cs = cam.make_camera_set(Ps)
    coord, _ = synthetic.plane_points(Ps, 256, extent=1.2, seed=7)
    for v in (0, 5, 11):
        xy, _, valid = cam.project(
            cs, jnp.full((256,), v, jnp.int32),
            jnp.asarray(coord, jnp.float32), 0,
        )
        q = coord @ np.asarray(Ps[v], np.float64).T
        want = q[:, :2] / q[:, 2:3]
        assert bool(jnp.all(valid))
        np.testing.assert_allclose(np.asarray(xy), want, atol=1e-3)
