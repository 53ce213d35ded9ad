"""Propagation-coverage validation sweep (VERDICT round-1 item 7).

The reference propagates EVERY ref-view patch in EVERY cell per
serpentine sweep (reference propagate.cpp:88-121); the engine
instead selects a global NCC-descending top-`donor_budget` donor set
per checkerboard round (pipeline/propagate.select_donors). This sweep
measures what that approximation costs: run the pipeline at production
table capacity for a grid of donor_budget x prop_rounds and record
cloud size and accuracy/completeness vs the analytic plane.

Writes COVERAGE.json at the repo root.

Usage (on the card; each config re-jits only when donor_budget changes):
    python tools/coverage_sweep.py --budgets 4096,16384,65536 --rounds 4,8
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
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--seeds", type=int, default=4096)
    ap.add_argument("--max-patches", type=int, default=1 << 18)
    ap.add_argument("--budgets", default="4096,16384,65536")
    ap.add_argument("--rounds", default="4,8")
    ap.add_argument("--policies", default="cell_first,ncc")
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--platform", default=None)
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

    marker = os.path.join(
        args.prefix,
        f"dataset_{args.views}x{args.width}x{args.height}x{args.seeds}.ok",
    )
    if not os.path.exists(marker):
        print(f"writing dataset at {args.prefix}...", file=sys.stderr)
        synthetic.write_dataset(
            args.prefix, n_views=args.views, width=args.width,
            height=args.height, n_seeds=args.seeds,
        )
        open(marker, "w").write("ok\n")

    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)

    scene = None
    runs = []
    for policy in args.policies.split(","):
      for budget in [int(b) for b in args.budgets.split(",")]:
        for rounds in [int(r) for r in args.rounds.split(",")]:
            cfg = MVSConfig.from_option_file(args.prefix, "option")
            cfg.n_iterations = args.iterations
            cfg.max_patches = args.max_patches
            cfg.donor_budget = budget
            cfg.prop_rounds = rounds
            cfg.donor_policy = policy
            t0 = time.time()
            engine = PMMVS(
                cfg, scene=scene,
                log=lambda *a: print(*a, file=sys.stderr),
            )
            scene = engine.scene  # reuse pyramids across configs
            engine.seed()
            engine.run(write_snapshots=False)
            dt = time.time() - t0
            cloud = engine.collect()["coord"][:, :3]
            m = metrics.accuracy_completeness(
                cloud, gt, threshold=0.05, crop_to_gt_bbox=True
            )
            rec = {
                "donor_policy": policy,
                "donor_budget": budget,
                "prop_rounds": rounds,
                "iterations": args.iterations,
                "seconds": round(dt, 1),
                "final_alive": int(cloud.shape[0]),
                "acc_median": m["acc_median"],
                "comp_frac@0.05": m["comp_frac"],
                "comp_median": m["comp_median"],
            }
            runs.append(rec)
            print(json.dumps(rec), file=sys.stderr)

    artifact = {
        "dataset": {
            "views": args.views, "width": args.width,
            "height": args.height, "seeds": args.seeds,
        },
        "max_patches": args.max_patches,
        "backend": __import__("jax").default_backend(),
        "note": (
            "reference baseline = exhaustive per-cell donation "
            "(propagate.cpp:88-121); the engine's global top-budget "
            "donor selection matches it when completeness saturates "
            "as budget grows"
        ),
        "runs": runs,
    }
    path = os.path.join(REPO, "COVERAGE.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"wrote": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
