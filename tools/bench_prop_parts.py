"""Decompose one production-scale propagation round on the card.

This tool finds where a propagation round's wall-clock goes: grid build, donor
selection, hypothesis generation, each gauntlet phase (preProcess,
refine, postProcess, vimages, depth2 check), insertion, and the whole
fused round, each timed as its own jitted program at the exact shapes
the driver uses (compiled and warmed up first; each timed call ends in
jax.block_until_ready).

Uses the E2E dataset's final checkpoint for a realistic table:

    python tools/bench_prop_parts.py \
        --prefix /tmp/mvskit_e2e --resume final_patches
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
    ap.add_argument("--resume", default="final_patches")
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--reps", type=int, default=2)
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
    from mvskit_tpu.pipeline import propagate as pr
    from mvskit_tpu.pipeline import refine as rf
    from mvskit_tpu.pipeline import seed as sd
    from mvskit_tpu.pipeline import views as vw
    from mvskit_tpu.pipeline.driver import PMMVS

    cfg = MVSConfig.from_option_file(args.prefix, "option")
    cfg.max_patches = args.max_patches
    engine = PMMVS(cfg, log=lambda *a: print(*a, file=sys.stderr))
    scene = engine.scene
    engine.table = sd.seed_from_patch_file(
        scene, cfg,
        os.path.join(args.prefix, "ply", args.resume + ".patch"),
    )
    table = engine.table
    p = engine.prop_params
    n_alive = int(np.asarray(table.n_alive()))
    print(f"table: {n_alive} alive / {cfg.max_patches}", file=sys.stderr)

    key = jax.random.PRNGKey(0)
    thr = jnp.float32(engine.ncc_threshold)
    thr_b = jnp.float32(engine.ncc_threshold_before)

    # ---- staged inputs (computed once, on device) ----
    grid = jax.jit(
        gridmod.build_grid, static_argnames=("level", "csize", "capacity")
    )(scene, table, p.level, p.csize, p.cell_capacity)
    donors = jax.jit(
        pr.select_donors, static_argnames=("budget", "policy")
    )(scene, grid, table, p.donor_budget, p.donor_policy)
    hyp = jax.jit(
        pr.generate_hypotheses,
        static_argnames=("axis", "direction", "p"),
    )(scene, table, grid, *donors, 0, 1, key, p)
    coord, normal, images, ncc0, ok = hyp
    C = p.chunk
    cc, cn, ci, cok = coord[:C], normal[:C], images[:C], ok[:C]

    pre = jax.jit(
        lambda sc, c, n, im: vw.pre_process(
            sc, c, n, im, level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num, ncc_threshold_before=thr_b,
            angle_threshold0=p.angle_threshold0,
            angle_threshold1=p.angle_threshold1,
            max_angle_threshold=p.max_angle_threshold,
        )
    )(scene, cc, cn, ci)

    res = None
    timings = {}

    def timed(name, fn, *a, **kw):
        nonlocal res
        jf = jax.jit(fn, **kw)
        t0 = time.time()
        out = jf(*a)
        leaf = jax.tree_util.tree_leaves(out)[0]
        np.asarray(jnp.sum(leaf) if hasattr(leaf, "shape") else leaf)
        print(f"{name}: compile+first {time.time()-t0:.1f}s",
              file=sys.stderr)
        ts = []
        for _ in range(args.reps):
            ts.append(_t(lambda: jax.block_until_ready(jf(*a))))
        dt = min(ts)
        timings[name] = round(dt * 1e3, 1)
        print(f"  {name}: {dt*1e3:.1f} ms", file=sys.stderr)
        res = out
        return out

    def _t(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    # ---- pieces ----
    timed(
        "build_grid",
        lambda sc, t: gridmod.build_grid(
            sc, t, p.level, p.csize, p.cell_capacity
        ),
        scene, table,
    )
    timed(
        "select_donors",
        lambda sc, g, t: pr.select_donors(
            sc, g, t, p.donor_budget, p.donor_policy
        ),
        scene, grid, table,
    )
    timed(
        "generate_hypotheses(16k)",
        lambda sc, t, g, k: pr.generate_hypotheses(
            sc, t, g, *donors, 0, 1, k, p
        ),
        scene, table, grid, key,
    )
    timed(
        "pre_process(4k)",
        lambda sc, c, n, im: vw.pre_process(
            sc, c, n, im, level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num, ncc_threshold_before=thr_b,
            angle_threshold0=p.angle_threshold0,
            angle_threshold1=p.angle_threshold1,
            max_angle_threshold=p.max_angle_threshold,
        ),
        scene, cc, cn, ci,
    )
    refined = timed(
        "refine(4k)",
        lambda sc, c, n, im, ds, k: rf.refine_batch(
            sc, c, n, im, ds, k, level=p.level, wsize=p.wsize,
            tau=p.tau, min_image_num=p.min_image_num,
            angle_threshold1=p.angle_threshold1, ascale=p.ascale,
            rounds=p.refine_rounds, n_cands=p.refine_cands,
            shrink=p.refine_shrink,
            init_depth_radius=p.refine_depth_radius,
            init_angle_radius=p.refine_angle_radius,
            luma=p.luma_refine,
            n_illums=p.n_illums,
        ),
        scene, cc, cn, pre.images, pre.dscale, key,
    )
    timed(
        "post_process(4k)",
        lambda sc, c, n, im: vw.post_process_core(
            sc, c, n, im, level=p.level, wsize=p.wsize, tau=p.tau,
            min_image_num=p.min_image_num, ncc_threshold=thr,
            angle_threshold0=p.angle_threshold0,
            angle_threshold1=p.angle_threshold1,
        ),
        scene, refined.coord, refined.normal, pre.images,
    )
    timed(
        "vimages(4k)",
        lambda sc, g, t, c, n, im: gridmod.visible_extra_views(
            sc, g, t, c, n, im, jnp.full_like(im, -1),
            jnp.ones(c.shape[0], bool), p.level, p.csize,
            p.neighbor_threshold, True,
        ),
        scene, grid, table, refined.coord, refined.normal, pre.images,
    )
    # depth>=2 in-gauntlet check pieces (the measured 4.3x round cost)
    from mvskit_tpu.pipeline import filters as fl

    no_rows = jnp.full((C,), -1, jnp.int32)
    vimg = jnp.full_like(ci, -1)
    timed(
        "check:gain(4k)",
        lambda sc, g, t, c, n: fl.gain_batch(
            sc, g, t, c, n, pre.dscale, refined.ncc, pre.images, vimg,
            no_rows, p.level, p.csize, thr, p.neighbor_threshold1,
        ),
        scene, grid, table, refined.coord, refined.normal,
    )
    nbrs = timed(
        "check:neighbors(4k)",
        lambda sc, g, t, c, n: fl.gather_neighbors_batch(
            sc, g, t, c, n, pre.dscale, pre.images, no_rows,
            p.level, p.csize, margin=2, scale=4.0,
            neighbor_threshold=p.neighbor_threshold,
            max_neighbors=p.neighbor_capacity,
            cand_cap=p.neighbor_cand_cap,
        )[0],
        scene, grid, table, refined.coord, refined.normal,
    )
    timed(
        "check:quad(4k)",
        lambda sc, t, c, n, nb: fl.quad_residuals_batch(
            sc, t, c, n, pre.images, nb, p.level, p.tau
        ),
        scene, table, refined.coord, refined.normal, nbrs,
    )
    timed(
        "check:total(4k)",
        lambda sc, g, t, c, n: fl.check_batch(
            sc, g, t, c, n, pre.dscale, refined.ncc, pre.images, vimg,
            level=p.level, csize=p.csize, tau=p.tau,
            ncc_threshold=thr, quad_threshold=jnp.float32(2.5),
            neighbor_threshold=p.neighbor_threshold,
            neighbor_threshold1=p.neighbor_threshold1,
            max_neighbors=p.neighbor_capacity,
            cand_cap=p.neighbor_cand_cap,
        ),
        scene, grid, table, refined.coord, refined.normal,
    )
    timed(
        "gauntlet(4k,total)",
        lambda sc, g, t, c, n, im, o, k: pr.run_gauntlet(
            sc, g, t, c, n, im, o, k, p, thr, thr_b, True,
        ),
        scene, grid, table, cc, cn, ci, cok, key,
    )
    timed(
        "propagate_round(full)",
        lambda sc, t, k: pr.propagate_round(
            sc, t, k, p, 1, thr, thr_b, use_depth=True,
        )[0],
        scene, table, key,
    )

    out = {
        "alive": n_alive,
        "max_patches": cfg.max_patches,
        "donor_budget": p.donor_budget,
        "chunk": C,
        "timings_ms": timings,
    }
    print(json.dumps(out, indent=1))
    with open(os.path.join(REPO, "PROP_PARTS.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
