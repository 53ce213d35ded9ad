"""On-card micro-benchmark of the cell-grid build (core/grid.build_grid).

The grid rebuild (slots + vslots segmented top-K, z-buffer depth maps;
reference patch_manager.cpp:223-239 + filter.cpp:580-626) runs twice
per propagation round (ROADMAP A4). Sort cost is set by the STATIC table capacity x list width,
so a synthetic table at production capacity (2^18 rows, 16-view lists)
reproduces production sort sizes exactly.

    python tools/bench_grid.py --prefix /tmp/mvskit_e2e

Timing: jit once, warm up, then the minimum over reps of calls that
end in a host pull of a reduced scalar.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="/tmp/mvskit_e2e")
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--alive", type=int, default=57850)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from mvskit_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from mvskit_tpu.config import MVSConfig
    from mvskit_tpu.core import grid as gridmod
    from mvskit_tpu.core import patches as pt
    from mvskit_tpu.image.scene import load_scene

    cfg = MVSConfig.from_option_file(args.prefix, "option")
    cfg.max_patches = args.max_patches
    scene = load_scene(cfg.prefix, cfg.images, cfg.nillums, cfg.max_level)
    n_img = scene.n_images

    # synthetic production-shaped table: alive plane patches with
    # random 4-10 view lists (covers slots, vslots and depth maps)
    rng = np.random.default_rng(0)
    A = args.alive
    coord = np.concatenate(
        [
            rng.uniform(-1, 1, (A, 2)),
            rng.normal(0, 0.01, (A, 1)),
            np.ones((A, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    normal = np.tile(
        np.asarray([0, 0, 1, 0], np.float32), (A, 1)
    )
    images = np.full((A, n_img), -1, np.int32)
    for i in range(A):
        k = rng.integers(4, 11)
        images[i, :k] = rng.choice(n_img, size=k, replace=False)
    table = pt.from_numpy(
        coord, normal, images, cfg.max_patches, n_img,
        ncc=rng.uniform(0.4, 1.0, (A,)).astype(np.float32),
        vimages=images,
    )

    jf = jax.jit(
        gridmod.build_grid,
        static_argnames=("level", "csize", "capacity"),
    )

    def run():
        g = jf(scene, table, cfg.level, cfg.csize, cfg.max_patches_per_cell)
        # checksum: count occupied slots (a raw int32 index sum can wrap
        # int32 at production capacity and print garbage)
        return np.asarray(jnp.sum(g.slots >= 0))

    t0 = time.time()
    chk = run()
    print(f"compile+first {time.time() - t0:.1f}s  chk={chk}", file=sys.stderr)

    def _t(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    ts = [_t(run) for _ in range(args.reps)]
    dt = min(ts)
    out = {
        "metric": "grid_build_ms",
        "value": round(dt * 1e3, 1),
        "capacity_rows": cfg.max_patches,
        "alive": A,
        "cell_capacity": cfg.max_patches_per_cell,
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
