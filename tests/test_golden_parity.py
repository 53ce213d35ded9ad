"""Golden-parity harness against the C++ reference (BASELINE.md item:
"measure on C++ reference" fallback — the reference is unbuildable in
this image: no Eigen/CImg/NLopt headers exist anywhere on the system).

The oracle is tests/golden_oracle.py: an *independent*, scalar-per-
patch NumPy transliteration of the reference's NCC objective path
(pyramid, camera, getTex, bilinear fetch, normalize, cost_func).

The engine (`ops/ncc.texs_for_views` + `incc_cost`, XLA gather path)
must reproduce the oracle's cost per (patch, view-list) to float
tolerance, and `image/scene.build_pyramid` must match the oracle
pyramid bit-for-bit. This is the strongest parity evidence available
without a buildable reference binary.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from golden_oracle import (
    compare_costs,
    oracle_costs,
    oracle_downsample,
    planes_by_view,
)
from mvskit_tpu.image import scene as scenemod
from mvskit_tpu.ops import ncc as nccops
from mvskit_tpu.utils import synthetic
from mvskit_tpu.utils.synthetic import plane_points, plane_scene

# ----------------------------------------------------------------------
# fixtures
# ----------------------------------------------------------------------

N_VIEWS, W, H, LEVEL, WSIZE, TAU, MIN_NUM = 6, 160, 120, 1, 7, 6, 3
A1 = math.radians(60.0)


@pytest.fixture(scope="module")
def setup():
    Ps, imgs, scene = plane_scene(
        n_views=N_VIEWS, width=W, height=H, max_level=LEVEL + 3,
    )
    coord, normal = plane_points(Ps, 48, extent=1.15, seed=3)
    return Ps, imgs, scene, np.asarray(coord, np.float64), np.asarray(normal, np.float64)


# ----------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------


def test_pyramid_matches_reference_semantics(setup):
    """scene.build_pyramid == the oracle transliteration, bit for bit,
    including the border bands (image.cpp:245-315)."""
    _, imgs, _, _, _ = setup
    img0 = np.asarray(imgs[0], np.float64)
    got = scenemod.build_pyramid(imgs[0].astype(np.float32), 3)
    lvl = img0
    for l in range(1, 3):
        lvl = oracle_downsample(lvl)
        np.testing.assert_array_equal(
            np.asarray(got[l]), lvl.astype(np.float32),
            err_msg=f"pyramid level {l} diverges from reference semantics",
        )


def test_cost_func_golden_parity(setup):
    """Engine cost (texs_for_views + incc_cost, XLA gather path) ==
    the reference cost_func oracle on identical inputs."""
    Ps, _, scene, coord, normal = setup
    assert scene.planes_packed is not None  # the packed-gather sampler

    B = coord.shape[0]
    # fixed padded view lists: ref view rotates over patches, others in
    # ascending order (mirrors a post-sortImages state)
    views = np.full((B, TAU), -1, np.int32)
    for b in range(B):
        ref = b % N_VIEWS
        rest = [v for v in range(N_VIEWS) if v != ref]
        views[b] = ([ref] + rest)[:TAU]

    tex, valid = nccops.texs_for_views(
        scene,
        jnp.asarray(views),
        jnp.asarray(coord, jnp.float32),
        jnp.asarray(normal, jnp.float32),
        LEVEL,
        WSIZE,
        A1,
    )
    engine_cost = nccops.incc_cost(tex, valid, min(MIN_NUM, TAU))
    oracle = oracle_costs(
        Ps, planes_by_view(scene), coord, normal, views, LEVEL, WSIZE,
        TAU, MIN_NUM, A1,
    )
    worst, n_two, mismatch = compare_costs(engine_cost, oracle)
    assert mismatch == 0, f"{mismatch} patches disagree on validity"
    assert worst < 2e-4, f"max cost deviation {worst}"
    # the fixture must actually exercise the live path
    assert n_two < B // 2, f"{n_two}/{B} patches degenerate"


def test_incc_matches_compute_patch_ncc(setup):
    """compute_patch_ncc's 1 - unrobust(cost) convention agrees with the
    oracle's raw INCC on a spot-check patch (optim.cpp:625-628)."""
    _, _, scene, coord, normal = setup
    r = 0.3
    assert abs(nccops.unrobustincc(nccops.robustincc(r)) - r) < 1e-6


@pytest.fixture(scope="module")
def two_illum_setup():
    """A 2-illumination plane scene carrying level+3 pyramid levels for
    every scored level up to 2."""
    w, h = 320, 240
    Ps = synthetic.ring_cameras(N_VIEWS, w, h)
    imgs = synthetic.render_views(Ps, w, h, geometry="plane", nillums=2)
    scene = scenemod.scene_from_arrays(Ps, list(imgs), max_level=5)
    coord, normal = plane_points(Ps, 32, extent=1.0, seed=5)
    return Ps, scene, coord, normal


@pytest.mark.parametrize("illum", [0, 1])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_packed_gather_golden_parity(two_illum_setup, level, illum):
    """The packed-gather sampler (4 int32 fetches per bilinear RGB
    sample) reproduces the oracle's cost_func at every scoring level and
    under each illumination; same 2e-4 bound and validity agreement as
    test_cost_func_golden_parity."""
    Ps, scene, coord, normal = two_illum_setup
    B = coord.shape[0]
    views = np.array(
        [[(b + k) % N_VIEWS for k in range(TAU)] for b in range(B)],
        np.int32,
    )
    tex, valid = nccops.texs_for_views(
        scene, jnp.asarray(views), jnp.asarray(coord, jnp.float32),
        jnp.asarray(normal, jnp.float32), level, WSIZE, A1, illum=illum,
    )
    engine = nccops.incc_cost(tex, valid, min(MIN_NUM, TAU))
    oracle = oracle_costs(
        Ps, planes_by_view(scene, illum), coord, normal, views, level,
        WSIZE, TAU, MIN_NUM, A1,
    )
    worst, n_two, mismatch = compare_costs(engine, oracle)
    assert mismatch == 0, f"{mismatch} rows disagree on validity"
    assert worst < 2e-4, f"max cost deviation {worst}"
    assert n_two < B // 2, f"{n_two}/{B} patches degenerate"
