"""chip_smoke.py's own logic on the CPU: the device check (bench.py's)
refuses to run anywhere but on a GPU, and the parity, quality and mesh-comparison
gates pass good results and fail bad ones (called directly on tiny
scenes; the phases' timings need the card)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke as cs
from mvskit_tpu.utils import synthetic


def test_device_check_refuses_cpu():
    with pytest.raises(bench.NoGPU, match="no GPU present"):
        cs.check_device()


def test_main_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU present" in out.err
    assert '"ok"' not in out.out


@pytest.fixture(scope="module")
def tiny():
    Ps, _, scene = synthetic.plane_scene(n_views=6, width=160, height=120)
    return Ps, scene


def test_parity_phase_passes_engine(tiny):
    Ps, scene = tiny
    r = cs.parity_phase(scene, Ps, n_patches=32)
    assert r["worst"] < cs.COST_TOL
    assert r["invalid"] < 16


def test_parity_phase_catches_wrong_pixels(tiny):
    """One-pixel shift of every packed plane: the oracle (reading the
    unshifted f32 planes) must see the engine's windows as wrong."""
    Ps, scene = tiny
    bad = dataclasses.replace(
        scene, planes_packed=jnp.roll(scene.planes_packed, 1, axis=-1)
    )
    with pytest.raises(cs.SmokeFailure):
        cs.parity_phase(bad, Ps, n_patches=32)


def _plane_cloud(n=4000, z=0.0, noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-0.9, 0.9, size=(n, 2))
    zs = z + noise * rng.standard_normal(n)
    return np.concatenate([xy, zs[:, None]], axis=1)


@pytest.mark.parametrize(
    "cloud_kw, ok",
    [
        (dict(), True),
        (dict(noise=0.005), True),
        (dict(z=0.1), False),        # off the plane: accuracy fails
        (dict(noise=0.03), False),   # too rough: plane_rms fails
    ],
)
def test_quality_gate(cloud_kw, ok):
    cloud = _plane_cloud(**cloud_kw)
    if ok:
        m = cs.quality_gate(cloud)
        assert m["acc_frac"] >= cs.ACC_FRAC_MIN
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.quality_gate(cloud)


def test_compare_clouds():
    rng = np.random.RandomState(1)
    want = {
        "coord": rng.rand(50, 4).astype(np.float32),
        "normal": rng.rand(50, 4).astype(np.float32),
        "ncc": rng.rand(50).astype(np.float32),
        "images": rng.randint(0, 8, (50, 8)).astype(np.int32),
    }
    assert cs.compare_clouds(dict(want), want, exact=True) == "bit-equal"
    nudged = dict(want, coord=want["coord"] + np.float32(1e-6))
    with pytest.raises(cs.SmokeFailure):
        cs.compare_clouds(nudged, want, exact=True)
    assert "same count" in cs.compare_clouds(nudged, want, exact=False)
    permuted = {k: v[::-1] for k, v in want.items()}
    with pytest.raises(cs.SmokeFailure, match="50 points match"):
        cs.compare_clouds(permuted, want, exact=False)
    fewer = {k: v[:40] for k, v in want.items()}
    with pytest.raises(cs.SmokeFailure):
        cs.compare_clouds(fewer, want, exact=False)


def test_ring_view_lists_are_nearest_neighbours():
    v = cs.ring_view_lists(4, 16, 6)
    assert v.shape == (4, 6)
    assert list(v[0]) == [0, 1, 15, 2, 14, 3]


def test_compile_clock_counts_nested_spans_once():
    """Tracing an inner jitted function happens inside the outer trace;
    the clock must count that time once, and never exceed the wall time
    of the compiling call."""
    import time

    import jax

    clock = cs._CompileClock()
    try:
        inner = jax.jit(lambda x: jnp.sin(x) * 2.0)
        outer = jax.jit(lambda x: inner(x) + inner(x + 1.0))
        t0 = time.time()
        jax.block_until_ready(outer(jnp.arange(7.0)))
        wall = time.time() - t0
    finally:
        clock.close()
    assert 0.0 < clock.total <= wall
    assert len(clock._spans) >= 3
