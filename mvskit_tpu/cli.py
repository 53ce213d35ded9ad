"""Command-line entry points.

Replaces the reference's hardcoded mains (reference test/test.cpp:155-163
full pipeline, test/test_filter.cpp:7-18 filter-only resume) with a real
CLI over the same dataset directory contract:

    python -m mvskit_tpu <prefix> [--option option]
    python -m mvskit_tpu <prefix> --filter-only --resume-iter 1
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mvskit_tpu",
        description="PatchMatch multi-view stereo",
    )
    p.add_argument("prefix", help="dataset root (contains option, image/, txt/, ply/)")
    p.add_argument("--option", default="option", help="option file name")
    p.add_argument(
        "--filter-only", action="store_true",
        help="resume from a .patch checkpoint and run only the filter "
             "stage (reference test_filter.cpp)",
    )
    p.add_argument(
        "--resume-iter", type=int, default=0,
        help="checkpoint index ply/%%08d.patch to seed/resume from",
    )
    p.add_argument("--iterations", type=int, default=None,
                   help="override number of outer iterations")
    p.add_argument("--prop-rounds", type=int, default=None,
                   help="override checkerboard rounds per iteration")
    p.add_argument("--no-snapshots", action="store_true",
                   help="skip intermediate PLY dumps")
    p.add_argument("--export-patch", action="store_true",
                   help="also write a final .patch checkpoint")
    p.add_argument("--out", default=None,
                   help="final output path prefix (default "
                        "<prefix>/ply/final_patches)")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu)")
    p.add_argument("--max-patches", type=int, default=None,
                   help="patch table capacity")
    p.add_argument("--donor-budget", type=int, default=None,
                   help="max donors per propagation phase")
    p.add_argument("--chunk", type=int, default=None,
                   help="gauntlet chunk size")
    p.add_argument("--refine-rounds", type=int, default=None,
                   help="random-search rounds per refinement")
    p.add_argument("--refine-cands", type=int, default=None,
                   help="candidates per refinement round")
    p.add_argument("--strategy", default=None,
                   choices=("pm_image", "pmvs"),
                   help="propagation strategy (reference live path "
                        "pm_image, or the PMVS-style expansion)")
    p.add_argument("--mesh", default=None, metavar="DP,VIEW,TILE",
                   help="device mesh shape, e.g. 1,2,4: dp shards "
                        "patch rows, view shards pyramid planes "
                        "(psum NCC combine), tile shards cell-grid "
                        "rows (ppermute halo propagation)")
    return p


def parse_mesh(spec: str):
    parts = [int(x) for x in spec.split(",")]
    if len(parts) != 3 or any(x < 1 for x in parts):
        raise ValueError(f"--mesh wants DP,VIEW,TILE >= 1, got {spec!r}")
    return parts


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from .config import MVSConfig
    from .pipeline.driver import PMMVS

    cfg = MVSConfig.from_option_file(args.prefix, args.option)
    if args.iterations is not None:
        cfg.n_iterations = args.iterations
    if args.prop_rounds is not None:
        cfg.prop_rounds = args.prop_rounds
    if args.max_patches is not None:
        cfg.max_patches = args.max_patches
    if args.donor_budget is not None:
        cfg.donor_budget = args.donor_budget
    if args.chunk is not None:
        cfg.gauntlet_chunk = args.chunk
    if args.refine_rounds is not None:
        cfg.refine_rounds = args.refine_rounds
    if args.refine_cands is not None:
        cfg.refine_cands = args.refine_cands
    if args.strategy is not None:
        cfg.strategy = args.strategy
    if args.mesh is not None:
        cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile = parse_mesh(args.mesh)
    print(cfg.summary(), file=sys.stderr)

    engine = PMMVS(cfg, log=lambda *a: print(*a, file=sys.stderr))
    import os

    out = args.out or os.path.join(args.prefix, "ply", "final_patches")

    if args.filter_only:
        # reference test_filter.cpp: restore checkpoint, depth=1, filter
        engine.seed(resume_iter=args.resume_iter)
        engine.filter()
    else:
        engine.seed(resume_iter=args.resume_iter)
        engine.run(write_snapshots=not args.no_snapshots)

    with engine.stage("final write"):
        engine.write_patches(
            out, export_ply=True, export_patch=args.export_patch
        )
    print(f"wrote {out}.ply", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
