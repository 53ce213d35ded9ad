"""Benchmark: NCC + PatchMatch refinement throughput on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N}
and the device, the card and the timing spread on stderr.

A "sample" is one bilinear RGB texture fetch inside the NCC objective —
the unit of work that dominates the reference's runtime (SURVEY.md
§3.3: one refinement is up to 500 evals x tau views x wsize^2 fetches).
The benchmark times the jitted refine_batch (the batched replacement
for Optim::refinePatch, reference pmmvps/optim.cpp:470-547) with the
shipped defaults — RGB candidate search, refine_rounds x refine_cands
evaluations per patch — on a dinoSparseRing-scale synthetic scene
(16 views, 640x480, level 1, wsize 7, tau 6, 8192 patches at truth).
It compiles once, warms up, then times repeats that each end in
jax.block_until_ready. It refuses to run without a GPU.

vs_baseline compares against the single-threaded C++ hot-loop
microbenchmark (native/ref_hotloop.cpp) measured on this host, per
BASELINE.md ("measure on C++ reference (CPU)"). The baseline number is
cached in native/baseline_cpu.json (git-ignored).

    python bench.py
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the refine workload (chip_smoke.py's sampler phase runs it too)
N_VIEWS, WIDTH, HEIGHT = 16, 640, 480
LEVEL, WSIZE, TAU, MIN_IMAGE_NUM = 1, 7, 6, 3
BATCH = 8192
ANGLE_THRESHOLD1 = math.radians(60.0)


class NoGPU(RuntimeError):
    """JAX found no GPU backend."""


def check_device() -> dict:
    """The device JAX runs on, as {platform, kind, count}. Raises
    NoGPU unless the backend is a GPU: a run on the CPU would report
    nothing about the card."""
    import jax

    backend = jax.default_backend()
    devs = jax.devices()
    if backend != "gpu" or not devs:
        raise NoGPU(
            f"no GPU present: JAX backend is {backend!r} "
            f"({len(devs)} device(s))"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def cpu_baseline_msps() -> float:
    cache = os.path.join(REPO, "native", "baseline_cpu.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["msamples_per_s"]
    src = os.path.join(REPO, "native", "ref_hotloop.cpp")
    exe = os.path.join(REPO, "native", "ref_hotloop")
    subprocess.run(
        ["g++", "-O3", "-march=native", "-o", exe, src],
        check=True, capture_output=True,
    )
    out = subprocess.run(
        [exe, "100000"], check=True, capture_output=True, text=True,
        timeout=600,
    )
    val = float(out.stdout.strip())
    with open(cache, "w") as f:
        json.dump({"msamples_per_s": val}, f)
    return val


def refine_workload(scene, Ps, batch=BATCH, rounds=None, cands=None):
    """The refine microbenchmark on `scene`: `batch` patches at truth
    on the z=0 plane, view lists from the engine's own selection.
    Returns (step, args, samples): step(*args) -> refined ncc [batch];
    `samples` counts the bilinear RGB fetches one call makes (the
    rounds x cands search plus the final re-score)."""
    import jax
    import jax.numpy as jnp

    from mvskit_tpu.config import MVSConfig
    from mvskit_tpu.pipeline import refine as rf
    from mvskit_tpu.pipeline import views as vw
    from mvskit_tpu.utils.synthetic import plane_points

    d = MVSConfig()
    rounds = d.refine_rounds if rounds is None else rounds
    cands = d.refine_cands if cands is None else cands
    n_views = scene.n_images
    coord, normal = plane_points(Ps, batch, extent=1.2)
    coord = jnp.asarray(coord, jnp.float32)
    normal = jnp.asarray(normal, jnp.float32)

    @jax.jit
    def prep(scene, coord, normal):
        images = jnp.full((batch, n_views), -1, jnp.int32).at[:, 0].set(0)
        images = vw.add_images(
            scene, coord, normal, images, LEVEL, ANGLE_THRESHOLD1
        )
        images = vw.sort_images(scene, coord, normal, images, LEVEL)
        dscale, _ = vw.set_scales(scene, coord, images, LEVEL, TAU, WSIZE)
        return images, dscale

    images, dscale = jax.block_until_ready(prep(scene, coord, normal))

    def step(scene, coord, normal, images, dscale, key):
        return rf.refine_batch(
            scene, coord, normal, images, dscale, key,
            level=LEVEL, wsize=WSIZE, tau=TAU, min_image_num=MIN_IMAGE_NUM,
            angle_threshold1=ANGLE_THRESHOLD1, ascale=d.ascale,
            rounds=rounds, n_cands=cands, shrink=d.refine_shrink,
            init_depth_radius=d.refine_init_depth_radius,
            init_angle_radius=d.refine_init_angle_radius,
            luma=d.luma_refine,
        ).ncc

    args = (scene, coord, normal, images, dscale, jax.random.PRNGKey(0))
    samples = batch * (rounds * cands + 1) * TAU * WSIZE * WSIZE
    return step, args, samples


def time_compiled(step, args, repeats=5):
    """Compile `step` for `args`, warm it up, then time `repeats` calls
    that each end in block_until_ready. Returns (compiled, compile_s,
    run_seconds list, last output)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))  # warm-up
    runs = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return compiled, compile_s, runs, out


def main() -> None:
    dev = check_device()
    print(f"device: {dev}", file=sys.stderr)
    print(f"card: {card_line()}", file=sys.stderr)

    import jax

    from mvskit_tpu.utils.compile_cache import enable_compile_cache
    from mvskit_tpu.utils.synthetic import plane_scene

    enable_compile_cache()
    print(f"building scene {N_VIEWS}x{WIDTH}x{HEIGHT}...", file=sys.stderr)
    Ps, _, scene = plane_scene(
        n_views=N_VIEWS, width=WIDTH, height=HEIGHT, max_level=LEVEL + 3
    )
    # pass the scene as a traced argument — closing over it would bake
    # the pyramid planes into the graph as a giant constant
    scene = jax.device_put(scene)
    step, args, samples = refine_workload(scene, Ps)
    _, compile_s, runs, out = time_compiled(step, args)
    q1, med, q3 = np.percentile(runs, [25, 50, 75])
    msps = samples / med / 1e6
    print(
        f"compile {compile_s:.2f} s; run median {med * 1e3:.2f} ms "
        f"(q1 {q1 * 1e3:.2f}, q3 {q3 * 1e3:.2f}) -> {msps:.1f} Msamples/s "
        f"(median ncc {float(np.median(np.asarray(out))):.4f})",
        file=sys.stderr,
    )

    try:
        base = cpu_baseline_msps()
    except Exception as e:  # baseline failure must not kill the bench
        print(f"baseline failed: {e}", file=sys.stderr)
        base = None

    print(json.dumps({
        "metric": "ncc_refine_throughput",
        "value": round(msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / base, 2) if base else None,
    }))


if __name__ == "__main__":
    main()
