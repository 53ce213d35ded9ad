"""Multi-device scaling measurement for the DP-sharded propagation step
and the view-sharded NCC op (VERDICT round-1 item 10; BASELINE.md row 2
"depthmaps/s at N hosts" / >=80% scaling-efficiency target).

This tool runs the REAL sharded programs
(GSPMD DP over the patch-table rows; shard_map + psum over views) on an
N-virtual-device CPU mesh and records:

  * correctness — the sharded step's outputs match the 1-device run;
  * communication overhead — wall-clock per step vs device count. The
    host has only `nproc` physical cores, so CPU wall-clock is an UPPER
    BOUND on per-device efficiency, not a hardware scaling claim; the
    artifact records nproc alongside. Scaling on real cards is
    ROADMAP A7 (chip_smoke.py --cards 4 checks the mesh paths).

Writes SCALING.json at the repo root.

Usage:  python tools/bench_scaling.py [--rows 4096] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--donor-budget", type=int, default=1024)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from mvskit_tpu.core import patches as pt
    from mvskit_tpu.ops import ncc as nccops
    from mvskit_tpu.parallel import shard as sh
    from mvskit_tpu.pipeline import propagate as pr
    from mvskit_tpu.pipeline import views as vw
    from mvskit_tpu.utils.synthetic import plane_points, plane_scene

    n_views = args.views
    a1 = math.radians(60.0)
    Ps, _, scene = plane_scene(
        n_views=n_views, width=320, height=240, max_level=4
    )
    n_seed = min(args.rows // 2, 2048)
    coord, normal = plane_points(Ps, n_seed, extent=0.8)
    views = np.tile(np.arange(n_views, dtype=np.int32), (n_seed, 1))
    coord = jnp.asarray(coord, jnp.float32)
    normal = jnp.asarray(normal, jnp.float32)
    images = vw.sort_images(
        scene, coord, normal, jnp.asarray(views), 1, is_fixed=False
    )
    dscale, ascale = vw.set_scales(
        scene, coord, images, 1, min(6, n_views), 7
    )
    ncc0 = nccops.compute_patch_ncc(
        scene, images, coord, normal, 1, 7, min(6, n_views), a1
    )

    p = pr.PropagateParams(
        level=1, csize=2, wsize=7, tau=min(6, n_views),
        min_image_num=3, cell_capacity=8,
        angle_threshold0=a1, angle_threshold1=a1,
        max_angle_threshold=math.radians(10.0), ascale=math.pi / 48.0,
        refine_rounds=4, refine_cands=4, refine_shrink=0.8,
        refine_depth_radius=4.0, refine_angle_radius=8.0,
        neighbor_threshold=0.5, donor_budget=args.donor_budget,
        chunk=args.donor_budget,
    )

    def fresh_table():
        return pt.from_numpy(
            np.asarray(coord), np.asarray(normal), np.asarray(images),
            args.rows, n_views,
            ncc=np.asarray(ncc0), dscale=np.asarray(dscale),
            ascale=np.asarray(ascale),
        )

    step = jax.jit(
        pr.propagate_round, static_argnames=("p", "direction", "use_depth")
    )
    key = jax.random.PRNGKey(0)

    def run_once(table):
        out, stats = step(
            scene, table, key, p=p, direction=1,
            ncc_threshold=jnp.float32(0.7),
            ncc_threshold_before=jnp.float32(0.4),
        )
        jax.block_until_ready(out)
        return out, stats

    results = {"dp_propagate": [], "view_ncc": []}
    ref_alive = None
    max_dev = len(jax.devices())
    for n_dev in (1, 2, 4, 8):
        if n_dev > max_dev:
            break
        mesh = sh.make_mesh(n_dev, axis="dp")
        table = sh.shard_table(fresh_table(), mesh, axis="dp")
        out, stats = run_once(table)  # warmup/compile (per sharding)
        alive = int(np.asarray(out.n_alive()))
        if n_dev == 1:
            ref_alive = (alive, int(np.asarray(stats.total)))
        times = []
        for _ in range(args.reps):
            table = sh.shard_table(fresh_table(), mesh, axis="dp")
            t0 = time.time()
            run_once(table)
            times.append(time.time() - t0)
        hyp = int(np.asarray(stats.total))
        sec = min(times)
        results["dp_propagate"].append(
            {
                "devices": n_dev,
                "seconds_per_round": round(sec, 3),
                "hypotheses": hyp,
                "hypotheses_per_s": round(hyp / sec, 1),
                "alive_after": alive,
                "matches_1dev": bool(
                    ref_alive is None or (alive, hyp) == ref_alive
                ),
            }
        )
        print(f"dp {n_dev} dev: {sec:.3f}s/round, alive {alive}",
              file=sys.stderr)

    # view-sharded NCC
    B = 4096
    vc, vn = plane_points(Ps, B, extent=0.8)
    vc = jnp.asarray(vc, jnp.float32)
    vn = jnp.asarray(vn, jnp.float32)
    vv = jnp.asarray(np.tile(np.arange(n_views, dtype=np.int32), (B, 1)))

    def score(scn):
        return nccops.compute_patch_ncc(
            scn, vv, vc, vn, 1, 7, min(6, n_views), a1
        )

    jscore = jax.jit(score)
    ref = None
    for n_dev in (1, 2, 4, 8):
        if n_dev > max_dev or n_views % n_dev:
            break
        if n_dev == 1:
            scn = scene
        else:
            scn = sh.enable_view_sharding(
                scene, sh.make_mesh(n_dev, axis="view")
            )
        got = np.asarray(jscore(scn))  # warmup/compile
        if ref is None:
            ref = got
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            np.asarray(jscore(scn))
            times.append(time.time() - t0)
        sec = min(times)
        results["view_ncc"].append(
            {
                "devices": n_dev,
                "seconds": round(sec, 3),
                "pairs_per_s": round(B * n_views / sec, 1),
                "max_abs_diff_vs_1dev": float(np.max(np.abs(got - ref))),
            }
        )
        print(f"view {n_dev} dev: {sec:.3f}s", file=sys.stderr)

    artifact = {
        "note": (
            "virtual CPU mesh measurement: validates the sharded "
            "programs and their communication overhead; NOT a hardware "
            "scaling claim (BASELINE.md row 2 needs real cards)."
        ),
        "physical_cores": os.cpu_count(),
        "rows": args.rows,
        "donor_budget": args.donor_budget,
        "results": results,
    }
    path = os.path.join(REPO, "SCALING.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"wrote": path}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
