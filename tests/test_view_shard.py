"""View-sharded sampling (scene.view_mesh) equals the unsharded path
through every consumer: texs_for_views, compute_patch_ncc, refine_batch,
a full propagation round, and the PMMVS driver."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvskit_tpu.geometry import camera as cam
from mvskit_tpu.ops import ncc as nccops
from mvskit_tpu.parallel import shard as sh
from mvskit_tpu.pipeline import propagate as pr
from mvskit_tpu.pipeline import refine as rf
from mvskit_tpu.pipeline import views as vw
from mvskit_tpu.utils import synthetic

from test_grid import make_seeded_table
from test_propagate import make_params

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple devices"
)

LEVEL, WSIZE, TAU = 1, 7, 6
A1 = np.deg2rad(60.0)


@pytest.fixture(scope="module")
def sp():
    Ps, imgs, scene = synthetic.plane_scene(n_views=8, width=160, height=120)
    coord, normal = synthetic.plane_points(Ps, 32, extent=0.6)
    views = np.tile(np.arange(8, dtype=np.int32), (32, 1))
    return scene, jnp.asarray(coord, jnp.float32), jnp.asarray(
        normal, jnp.float32), jnp.asarray(views)


@pytest.mark.parametrize("k", [2, 8])
def test_view_sharded_texs_match(sp, k):
    scene, coord, normal, views = sp
    mesh = sh.make_mesh(k, axis="view")
    vscene = sh.enable_view_sharding(scene, mesh)
    assert vscene.view_mesh is mesh

    tex0, valid0 = nccops.texs_for_views(
        scene, views[:, :TAU], coord, normal, LEVEL, WSIZE, A1
    )
    tex1, valid1 = nccops.texs_for_views(
        vscene, views[:, :TAU], coord, normal, LEVEL, WSIZE, A1
    )
    np.testing.assert_array_equal(np.asarray(valid1), np.asarray(valid0))
    np.testing.assert_allclose(
        np.asarray(tex1), np.asarray(tex0), atol=1e-5
    )


def test_view_sharded_patch_ncc_matches(sp):
    scene, coord, normal, views = sp
    mesh = sh.make_mesh(8, axis="view")
    vscene = sh.enable_view_sharding(scene, mesh)
    want = np.asarray(nccops.compute_patch_ncc(
        scene, views, coord, normal, LEVEL, WSIZE, TAU, A1
    ))
    got = np.asarray(nccops.compute_patch_ncc(
        vscene, views, coord, normal, LEVEL, WSIZE, TAU, A1
    ))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_view_sharded_refine_matches(sp):
    scene, coord, normal, views = sp
    mesh = sh.make_mesh(8, axis="view")
    vscene = sh.enable_view_sharding(scene, mesh)
    images = vw.sort_images(scene, coord, normal, views, LEVEL,
                            is_fixed=False)
    dscale, _ = vw.set_scales(scene, coord, images, LEVEL, TAU, WSIZE)
    kw = dict(
        level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=3,
        angle_threshold1=A1, ascale=math.pi / 48.0,
        rounds=3, n_cands=4, shrink=0.8,
        init_depth_radius=4.0, init_angle_radius=8.0,
    )
    key = jax.random.PRNGKey(5)
    want = rf.refine_batch(scene, coord, normal, images, dscale, key, **kw)
    got = rf.refine_batch(vscene, coord, normal, images, dscale, key, **kw)
    np.testing.assert_allclose(
        np.asarray(got.coord), np.asarray(want.coord), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(got.ncc), np.asarray(want.ncc), atol=1e-5
    )


def test_view_sharded_propagate_round_matches(sp):
    scene, coord, normal, views = sp
    mesh = sh.make_mesh(8, axis="view")
    vscene = sh.enable_view_sharding(scene, mesh)
    table = make_seeded_table(scene, coord, normal, capacity=1024)
    p = make_params(donor_budget=64, chunk=32, refine_rounds=2,
                    refine_cands=2)
    key = jax.random.PRNGKey(11)
    kw = dict(
        ncc_threshold=jnp.float32(0.7),
        ncc_threshold_before=jnp.float32(0.4),
    )
    step = jax.jit(
        pr.propagate_round, static_argnames=("p", "direction"),
    )
    want, wstats = step(scene, table, key, p=p, direction=1, **kw)
    got, gstats = step(vscene, table, key, p=p, direction=1, **kw)
    np.testing.assert_array_equal(
        np.asarray(got.alive), np.asarray(want.alive)
    )
    alive = np.asarray(want.alive)
    np.testing.assert_allclose(
        np.asarray(got.coord)[alive], np.asarray(want.coord)[alive],
        atol=1e-5,
    )
    for gs, ws in zip(gstats, wstats):
        assert int(np.asarray(gs)) == int(np.asarray(ws))
    assert int(np.asarray(wstats.passed)) > 0


def test_driver_accepts_view_mesh(sp):
    """PMMVS(cfg, scene, view_mesh=...) runs its gauntlet view-sharded."""
    import dataclasses

    from mvskit_tpu.config import MVSConfig
    from mvskit_tpu.pipeline.driver import PMMVS

    scene, coord, normal, _ = sp
    cfg = MVSConfig(
        prefix=".", images=list(range(8)), level=LEVEL, csize=2,
        wsize=WSIZE, min_image_num=3, max_patches=1024,
        donor_budget=64, gauntlet_chunk=32, refine_rounds=2,
        refine_cands=2, prop_rounds=1, n_iterations=1,
    )
    mesh = sh.make_mesh(8, axis="view")
    eng = PMMVS(cfg, scene=scene, log=lambda *a: None, view_mesh=mesh)
    assert eng.scene.view_mesh is mesh
    eng.table = make_seeded_table(eng.scene, coord, normal, capacity=1024)
    eng.propagate(0)
    assert int(np.asarray(eng.table.n_alive())) > 0


@pytest.mark.parametrize("k", [2, 4])
def test_view_sharded_gather_sampler_checks_vma(sp, k):
    """The view-sharded gather sampler runs shard_map with its
    varying-axes check ON and returns exactly the unsharded raw windows:
    each view's samples come from one device and the psum adds zeros."""
    scene, coord, normal, views = sp
    vscene = sh.enable_view_sharding(scene, sh.make_mesh(k, axis="view"))
    views_t = views[:, :TAU].T
    pxaxis, pyaxis = cam.get_paxes(
        scene.cams, views_t[0], coord, normal, LEVEL
    )
    geom = nccops.window_geometry_views(
        scene, views_t, coord, pxaxis, pyaxis, normal, LEVEL, WSIZE, A1
    )
    tl, dx2, dy2, new_level, _ = geom
    args = (views_t, tl, dx2, dy2, new_level, WSIZE, 0, False)

    def sharded(*a):
        return nccops._sample_windows_view_sharded(vscene, *a)[0]

    jaxpr = jax.make_jaxpr(sharded, static_argnums=(5, 6, 7))(*args)
    smaps = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "shard_map"]
    assert smaps and all(e.params["check_vma"] for e in smaps)
    want, c0 = nccops.sample_windows_raw(scene, *args)
    got, c1 = nccops._sample_windows_view_sharded(vscene, *args)
    assert c0 == c1 == 3
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
