"""End-to-end pipeline run on the card, recorded as a JSON artifact.

Runs the FULL reconstruction (seed -> N x {propagate; snapshot; filter;
anneal; snapshot} -> final cloud; reference pmmvps/pmmvps.cpp:76-114)
on a dinoSparseRing-scale synthetic dataset (16 views, 640x480; the
shape of BASELINE.json config 1) through the real driver (PMMVS), and
records per-stage wall-clock, hypotheses/s, alive counts, and
accuracy/completeness vs the analytic ground-truth plane into
E2E_<tag>.json at the repo root.

Usage (the default platform is whatever JAX picks — the GPU where one
is present):

    python tools/e2e_run.py --tag r03
    python tools/e2e_run.py --platform cpu --views 6 --width 160 \
        --height 120 --seeds 256 --max-patches 16384 --tag smoke

Every stage boundary pulls a scalar to host (the driver's filter
already does; propagate's stats pull does too), so each stage's
wall-clock covers its device work, compilation included. Compiles go
through the persistent cache (utils/compile_cache).
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
    ap.add_argument("--tag", default="run")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seeds", type=int, default=4096)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--prop-rounds", type=int, default=None)
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--donor-budget", type=int, default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--fresh-dataset", action="store_true")
    ap.add_argument("--geometry", default="plane",
                    choices=("plane", "sphere"))
    ap.add_argument("--nillums", type=int, default=1)
    ap.add_argument("--strategy", default=None,
                    choices=("pm_image", "pmvs"))
    ap.add_argument("--luma-refine", type=int, default=None,
                    help="override config.luma_refine (1/0) for the "
                         "luma-vs-RGB search A/B")
    ap.add_argument("--mesh", default=None, metavar="DP,VIEW,TILE",
                    help="device mesh shape (see cli.py --mesh)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from mvskit_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from mvskit_tpu.config import MVSConfig
    from mvskit_tpu.pipeline.driver import PMMVS
    from mvskit_tpu.utils import metrics, synthetic

    # ---- dataset (reference directory contract, SURVEY.md §1) ----
    marker = os.path.join(
        args.prefix,
        f"dataset_{args.geometry}{args.nillums}_"
        f"{args.views}x{args.width}x{args.height}x{args.seeds}.ok",
    )
    if args.fresh_dataset or not os.path.exists(marker):
        print(f"writing dataset at {args.prefix}...", file=sys.stderr)
        t0 = time.time()
        synthetic.write_dataset(
            args.prefix, n_views=args.views, width=args.width,
            height=args.height, n_seeds=args.seeds,
            geometry=args.geometry, nillums=args.nillums,
        )
        open(marker, "w").write("ok\n")
        print(f"dataset written in {time.time() - t0:.1f}s", file=sys.stderr)

    cfg = MVSConfig.from_option_file(args.prefix, "option")
    cfg.n_iterations = args.iterations
    cfg.max_patches = args.max_patches
    if args.prop_rounds is not None:
        cfg.prop_rounds = args.prop_rounds
    if args.donor_budget is not None:
        cfg.donor_budget = args.donor_budget
    if args.strategy is not None:
        cfg.strategy = args.strategy
    if args.luma_refine is not None:
        cfg.luma_refine = bool(args.luma_refine)
    if args.mesh is not None:
        from mvskit_tpu.cli import parse_mesh

        cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile = parse_mesh(args.mesh)
    print(cfg.summary(), file=sys.stderr)

    stages = []  # (name, seconds, extra-dict)

    def stage(name, fn, **extra):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        rec = {"stage": name, "seconds": round(dt, 2), **extra}
        stages.append(rec)
        print(f"[stage] {name}: {dt:.1f}s {extra}", file=sys.stderr)
        return out

    t_all = time.time()
    engine = stage(
        "init(scene load + pyramids)",
        lambda: PMMVS(cfg, log=lambda *a: print(*a, file=sys.stderr)),
        backend=jax.default_backend(),
    )
    stage("seed", lambda: engine.seed())
    n_seeded = int(np.asarray(engine.table.n_alive()))

    alive_per_iter = []
    for it in range(cfg.n_iterations):
        st = stage(f"propagate[{it}]", lambda it=it: engine.propagate(it))
        total = int(np.asarray(st.total))
        sec = stages[-1]["seconds"]
        stages[-1]["hypotheses"] = total
        stages[-1]["hypotheses_per_s"] = round(total / max(sec, 1e-9), 1)
        stages[-1]["accepted"] = int(np.asarray(st.passed))
        stage(
            f"snapshot[{it}] before filter",
            lambda it=it: engine.write_patches(
                os.path.join(
                    args.prefix, "ply",
                    f"refined_patches_before_refine_{it}",
                )
            ),
        )
        fs = stage(f"filter[{it}]", lambda: engine.filter())
        stages[-1]["removed"] = {
            "outside": int(np.asarray(fs.outside)),
            "exact": int(np.asarray(fs.exact)),
            "neighbor": int(np.asarray(fs.neighbor)),
            "groups": int(np.asarray(fs.groups)),
        }
        engine.update_threshold()
        engine.depth += 1
        stage(
            f"snapshot[{it}] after filter",
            lambda it=it: engine.write_patches(
                os.path.join(args.prefix, "ply", f"refined_patches_{it}")
            ),
        )
        alive_per_iter.append(int(np.asarray(engine.table.n_alive())))

    out_prefix = os.path.join(args.prefix, "ply", "final_patches")
    stage(
        "final write (.ply + .patch)",
        lambda: engine.write_patches(
            out_prefix, export_ply=True, export_patch=True
        ),
    )
    total_s = time.time() - t_all

    # ---- quality vs analytic ground truth ----
    data = engine.collect()
    cloud = data["coord"][:, :3]
    if args.geometry == "sphere":
        Ps = synthetic.sphere_cameras(args.views, args.width, args.height)
        gt, _ = synthetic.visible_surface_points(
            Ps, 40000, geometry="sphere", seed=97,
            width=args.width, height=args.height,
        )
        gt = gt[:, :3]
        m = metrics.accuracy_completeness(cloud, gt, threshold=0.05)
        dist = synthetic.surface_distance(cloud, "sphere")
        m["surface_dist_median"] = float(np.median(dist))
        m["surface_frac@0.05"] = float((dist < 0.05).mean())
        m["n_off_surface@0.2"] = int((dist > 0.2).sum())
        m["n_on_sphere"] = int(
            ((np.abs(cloud[:, 2]) > 0.05) & (dist < 0.05)).sum()
        )
    else:
        g = np.linspace(-1.0, 1.0, 200)
        xs, ys = np.meshgrid(g, g)
        gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
        m = metrics.accuracy_completeness(
            cloud, gt, threshold=0.05, crop_to_gt_bbox=True
        )
        m["plane_rms"] = metrics.plane_rms(cloud)

    prop_secs = sum(s["seconds"] for s in stages if s["stage"].startswith("propagate"))
    hyp_total = sum(s.get("hypotheses", 0) for s in stages)
    artifact = {
        "tag": args.tag,
        "backend": jax.default_backend(),
        "dataset": {
            "views": args.views, "width": args.width,
            "height": args.height, "seeds": args.seeds,
            "geometry": args.geometry, "nillums": args.nillums,
        },
        "config": {
            "iterations": cfg.n_iterations,
            "prop_rounds": cfg.prop_rounds,
            "donor_budget": cfg.donor_budget,
            "max_patches": cfg.max_patches,
            "level": cfg.level, "csize": cfg.csize, "wsize": cfg.wsize,
            "refine_rounds": cfg.refine_rounds,
            "refine_cands": cfg.refine_cands,
            "strategy": cfg.strategy,
            "luma_refine": cfg.luma_refine,
            "mesh": [cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile],
        },
        "total_seconds": round(total_s, 1),
        "seeded": n_seeded,
        "alive_per_iter": alive_per_iter,
        "final_alive": int(cloud.shape[0]),
        "hypotheses_total": hyp_total,
        "hypotheses_per_s_overall": round(hyp_total / max(prop_secs, 1e-9), 1),
        f"quality_vs_analytic_{args.geometry}@0.05": m,
        "stages": stages,
    }
    path = os.path.join(REPO, f"E2E_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {path}", file=sys.stderr)
    print(json.dumps({k: artifact[k] for k in (
        "tag", "backend", "total_seconds", "final_alive",
        "hypotheses_per_s_overall")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
