#!/usr/bin/env python3
"""On-card smoke test of the PatchMatch MVS engine (one NVIDIA GPU).

    python chip_smoke.py             # phases 1-4 on one card
    python chip_smoke.py --cards 4   # the four-card mesh phase only

Phases, in order; each prints its findings, and any failure exits
non-zero before the last line is printed:

 1. device   — JAX must report a GPU backend (never falls back to the
               CPU); prints the device kind and the card's name and
               power limit (nvidia-smi).
 2. parity   — the engine's window sampler + cost (ops/ncc
               texs_for_views + incc_cost) on the 16-view 640x480 scene
               against the independent NumPy oracle of
               tests/golden_oracle.py: |dcost| < 2e-4, same validity.
 3. sampler  — bench.py's refine workload (8192 patches, refine_rounds
               x refine_cands RGB candidates, tau 6, wsize 7, level 1):
               compile time apart from run time, run-time quartiles,
               Msamples/s, the bytes the gathers fetch (from shapes)
               against the card's measured copy bandwidth, the compiled
               program's memory analysis, and the median refined NCC at
               truth (>= 0.99).
 4. main     — `python -m mvskit_tpu <prefix> --iterations 1` (cli.main)
               on the synthetic dinoSparseRing-shape dataset (16 views
               at 640x480, 4096 seeds, default capacity; one of the
               CLI's three iterations, see MAIN_ITERATIONS):
               per-stage seconds with compilation apart, hypotheses/s,
               the final cloud's size, and its accuracy against the
               analytic plane (acc_frac >= 0.95, plane_rms <= 0.02).

--cards 4 runs only the mesh phase: one process over four cards runs
the same dataset on one card and with each of the (dp, view, tile)
meshes 1,1,4 / 1,4,1 / 4,1,1, for one iteration of one propagation
round each (MESH_ITERATIONS, MESH_PROP_ROUNDS). The tile cloud must equal the one-card
cloud bit for bit; view and dp must agree within the tolerance of
tests/test_driver_mesh.py.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np

import bench
from bench import NoGPU, card_line, check_device

REPO = os.path.dirname(os.path.abspath(__file__))

# the scene every phase uses: the dinoSparseRing shape (BASELINE.json
# config 1) as the synthetic plane of utils/synthetic
N_VIEWS, WIDTH, HEIGHT, SEEDS = 16, 640, 480, 4096
LEVEL, WSIZE, TAU, MIN_IMAGE_NUM = 1, 7, 6, 3
PARITY_PATCHES = 256
COST_TOL = 2e-4             # as tests/test_golden_parity.py
NCC_AT_TRUTH_MIN = 0.99
ACC_FRAC_MIN = 0.95         # loose bounds around the quality recorded
PLANE_RMS_MAX = 0.02        # for this scene (PERF.md)
MESHES = ("1,1,4", "1,4,1", "4,1,1")
# A cold run of the main phase at the CLI's 3 iterations took 627 s on
# one H100, mostly compiling (each iteration and each row-limit bucket
# compiles its own propagation program; PERF.md), so the smoke runs one
# iteration. The mesh phase compiles every program once per mesh, hence
# its smaller cut.
MAIN_ITERATIONS = 1
MESH_ITERATIONS, MESH_PROP_ROUNDS = 1, 1


class SmokeFailure(RuntimeError):
    """A phase found a wrong result."""


def say(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# 1. device
# ----------------------------------------------------------------------


# check_device and card_line live in bench.py


# ----------------------------------------------------------------------
# 2. parity against the NumPy oracle
# ----------------------------------------------------------------------


def ring_view_lists(n_patches: int, n_views: int, tau: int) -> np.ndarray:
    """[n_patches, tau] view lists: the reference view rotates over the
    patches, the others are its nearest ring neighbours."""
    rows = []
    for b in range(n_patches):
        ref = b % n_views
        rest = sorted(
            (v for v in range(n_views) if v != ref),
            key=lambda v: min((v - ref) % n_views, (ref - v) % n_views),
        )
        rows.append([ref] + rest[: tau - 1])
    return np.asarray(rows, np.int32)


def parity_phase(scene, Ps, n_patches=PARITY_PATCHES, level=LEVEL,
                 wsize=WSIZE, tau=TAU, illum=0) -> dict:
    """Engine cost (texs_for_views + incc_cost, jitted) against the
    oracle's cost_func on the same patches and view lists."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from golden_oracle import compare_costs, oracle_costs, planes_by_view

    from mvskit_tpu.ops import ncc as nccops
    from mvskit_tpu.utils.synthetic import plane_points

    a1 = math.radians(60.0)
    minimum = min(MIN_IMAGE_NUM, tau)
    coord, normal = plane_points(Ps, n_patches, extent=1.15, seed=3)
    views = ring_view_lists(n_patches, scene.n_images, tau)

    @jax.jit
    def engine_cost(scene, views, coord, normal):
        tex, valid = nccops.texs_for_views(
            scene, views, coord, normal, level, wsize, a1, illum=illum
        )
        return nccops.incc_cost(tex, valid, minimum)

    ec = np.asarray(engine_cost(
        scene, jnp.asarray(views), jnp.asarray(coord, jnp.float32),
        jnp.asarray(normal, jnp.float32),
    ))
    oc = oracle_costs(
        Ps, planes_by_view(scene, illum), coord, normal, views, level,
        wsize, tau, MIN_IMAGE_NUM, a1,
    )
    worst, n_two, mismatch = compare_costs(ec, oc)
    say(f"[parity] {n_patches} patches, level {level}, wsize {wsize}, "
        f"tau {tau}: worst |dcost| {worst:.3e} (bound {COST_TOL:g}), "
        f"{n_two} invalid on both sides, {mismatch} validity mismatches")
    if mismatch:
        raise SmokeFailure(f"{mismatch} patches disagree on validity")
    if not worst < COST_TOL:
        raise SmokeFailure(f"worst cost deviation {worst} >= {COST_TOL}")
    if not n_two < n_patches // 2:
        raise SmokeFailure(f"{n_two}/{n_patches} patches degenerate")
    return {"worst": worst, "invalid": n_two}


# ----------------------------------------------------------------------
# 3. sampler throughput
# ----------------------------------------------------------------------


def copy_bandwidth(n_bytes=1 << 30, repeats=5) -> float:
    """Measured device copy rate (read + write bytes / s) of an
    elementwise pass over an n_bytes float32 array."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((n_bytes // 4,), jnp.float32)
    f = jax.jit(lambda x: x * 1.0001).lower(x).compile()
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    return 2 * n_bytes / float(np.median(ts))


def sampler_phase(scene, Ps, batch=None, repeats=5) -> dict:
    step, args, samples = bench.refine_workload(
        scene, Ps, **({} if batch is None else {"batch": batch})
    )
    compiled, compile_s, runs, ncc = bench.time_compiled(
        step, args, repeats=repeats
    )
    q1, med, q3 = (float(v) for v in np.percentile(runs, [25, 50, 75]))
    msps = samples / med / 1e6
    # 4 int32 fetches per bilinear RGB sample (ops/sampling
    # sample_color_ch_packed): logical bytes, mostly L2 hits
    fetch_bytes = 16 * samples
    bw = copy_bandwidth()
    med_ncc = float(np.median(np.asarray(ncc)))
    say(f"[sampler] compile {compile_s:.2f} s; run over {repeats} repeats: "
        f"median {med * 1e3:.2f} ms, q1 {q1 * 1e3:.2f} ms, "
        f"q3 {q3 * 1e3:.2f} ms")
    say(f"[sampler] {samples} samples/call -> {msps:.1f} Msamples/s; "
        f"gather fetches {fetch_bytes / 1e9:.2f} GB/call = "
        f"{fetch_bytes / med / 1e9:.1f} GB/s, "
        f"{fetch_bytes / med / bw:.3f} of the measured copy rate "
        f"{bw / 1e9:.1f} GB/s")
    say(f"[sampler] memory_analysis: {compiled.memory_analysis()}")
    say(f"[sampler] median refined ncc at truth {med_ncc:.4f} "
        f"(bound {NCC_AT_TRUTH_MIN})")
    if not med_ncc >= NCC_AT_TRUTH_MIN:
        raise SmokeFailure(f"median refined ncc {med_ncc} < {NCC_AT_TRUTH_MIN}")
    return {"msps": msps, "median_s": med, "compile_s": compile_s,
            "copy_Bps": bw, "median_ncc": med_ncc}


# ----------------------------------------------------------------------
# 4. main path through the CLI
# ----------------------------------------------------------------------


def quality_gate(cloud: np.ndarray) -> dict:
    """Accuracy of a final cloud against the analytic z=0 plane, as
    tools/e2e_run.py measures it (crop to the ground-truth extent)."""
    from mvskit_tpu.utils import metrics

    g = np.linspace(-1.0, 1.0, 200)
    xs, ys = np.meshgrid(g, g)
    gt = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)], axis=1)
    m = metrics.accuracy_completeness(
        cloud, gt, threshold=0.05, crop_to_gt_bbox=True
    )
    m["plane_rms"] = metrics.plane_rms(cloud)
    say(f"[main] quality vs analytic plane: acc_frac {m['acc_frac']:.4f} "
        f"(bound {ACC_FRAC_MIN}), plane_rms {m['plane_rms']:.5f} "
        f"(bound {PLANE_RMS_MAX}), acc_median {m['acc_median']:.5f}, "
        f"comp_frac {m['comp_frac']:.4f}, {m['n_cloud']} points")
    if not m["acc_frac"] >= ACC_FRAC_MIN:
        raise SmokeFailure(f"acc_frac {m['acc_frac']} < {ACC_FRAC_MIN}")
    if not m["plane_rms"] <= PLANE_RMS_MAX:
        raise SmokeFailure(f"plane_rms {m['plane_rms']} > {PLANE_RMS_MAX}")
    return m


class _CompileClock:
    """Wall seconds JAX spent tracing, lowering and compiling (or loading
    from the persistent cache), from its monitoring time spans. Spans
    nest (a jitted function traced inside another), so the clock counts
    their union."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        import jax

        self._spans = []
        self._jax = jax
        jax.monitoring.register_event_time_span_listener(self._on)

    def _on(self, event, start, end, **_):
        if event in self.EVENTS:
            self._spans.append((start, end))

    @property
    def total(self) -> float:
        covered, reach = 0.0, float("-inf")
        for start, end in sorted(self._spans):
            if end > reach:
                covered += end - max(start, reach)
                reach = end
        return covered

    def close(self):
        self._jax.monitoring.unregister_event_time_span_listener(self._on)


class _StageTee(io.TextIOBase):
    """stderr pass-through that records the driver's `stage <name>: <s>
    s` lines with the compile seconds accrued since the previous one."""

    PAT = re.compile(r"^stage (.+): ([0-9.]+) s$")

    def __init__(self, out, clock):
        self.out, self.clock, self.buf = out, clock, ""
        self.stages, self.lines, self._mark = [], [], clock.total

    def write(self, s):
        self.out.write(s)
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append(line)
            m = self.PAT.match(line.strip())
            if m:
                now = self.clock.total
                self.stages.append(
                    (m.group(1), float(m.group(2)), now - self._mark)
                )
                self._mark = now
        return len(s)

    def flush(self):
        self.out.flush()


def main_path_phase(workdir, views=N_VIEWS, width=WIDTH, height=HEIGHT,
                    seeds=SEEDS, extra_args=()) -> dict:
    """Write the synthetic dataset, run cli.main on it, and gate the
    written cloud's quality."""
    from mvskit_tpu import cli
    from mvskit_tpu.io import ply
    from mvskit_tpu.utils import synthetic

    prefix = os.path.join(workdir, "dataset")
    t0 = time.perf_counter()
    synthetic.write_dataset(prefix, n_views=views, width=width,
                            height=height, n_seeds=seeds)
    say(f"[main] dataset {views}x{width}x{height}, {seeds} seeds written "
        f"in {time.perf_counter() - t0:.1f} s")
    argv = [prefix, *extra_args]
    clock = _CompileClock()
    tee = _StageTee(sys.stderr, clock)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(tee):
            rc = cli.main(argv)
    finally:
        clock.close()
    total = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"cli.main returned {rc}")
    say(f"[main] python -m mvskit_tpu {' '.join(argv)}: {total:.2f} s, "
        f"of which compile {clock.total:.2f} s")
    for name, sec, comp in tee.stages:
        say(f"[main] stage {name}: {sec:.3f} s (compile {comp:.3f} s)")
    hyps = [int(m.group(1)) for m in (
        re.search(r"^iter \d+: total (\d+) ", l) for l in tee.lines) if m]
    prop = [(s, c) for n, s, c in tee.stages if n.startswith("propagate")]
    if not hyps or len(hyps) != len(prop):
        raise SmokeFailure("the driver logged no propagation stages")
    prop_s = sum(s for s, _ in prop)
    prop_run = sum(s - c for s, c in prop)
    cloud = ply.read_ply(
        os.path.join(prefix, "ply", "final_patches.ply"))["xyz"]
    say(f"[main] {sum(hyps)} hypotheses in {prop_s:.2f} s of propagation: "
        f"{sum(hyps) / prop_s:.1f} hyp/s ({sum(hyps) / max(prop_run, 1e-9):.1f}"
        f" hyp/s without compile); final alive {cloud.shape[0]}")
    if cloud.shape[0] == 0:
        raise SmokeFailure("empty final cloud")
    m = quality_gate(np.asarray(cloud, np.float64))
    return {"seconds": total, "compile_s": clock.total,
            "hypotheses": sum(hyps), "alive": int(cloud.shape[0]), **m}


# ----------------------------------------------------------------------
# --cards 4: the mesh paths against one card
# ----------------------------------------------------------------------


def _run_driver(prefix, mesh, iterations, **overrides):
    from mvskit_tpu.cli import parse_mesh
    from mvskit_tpu.config import MVSConfig
    from mvskit_tpu.pipeline.driver import PMMVS

    cfg = MVSConfig.from_option_file(prefix)
    cfg.n_iterations = iterations
    for k, v in overrides.items():
        setattr(cfg, k, v)
    if mesh is not None:
        cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile = parse_mesh(mesh)
    eng = PMMVS(cfg, log=lambda *a: None)
    t0 = time.perf_counter()
    eng.seed()
    eng.run(write_snapshots=False)
    return eng.collect(), time.perf_counter() - t0


def compare_clouds(got, want, exact: bool) -> str:
    """The test_driver_mesh.py criteria: `exact` demands bit equality of
    coord, normal, ncc and images; otherwise equal counts must agree to
    1e-5 in coord, and unequal counts may differ by max(4, n / 10)."""
    if exact:
        for k in ("coord", "normal", "ncc", "images"):
            if got[k].shape != want[k].shape or not np.array_equal(
                    got[k], want[k]):
                raise SmokeFailure(f"{k} differs from the one-card cloud")
        return "bit-equal"
    n, m = got["coord"].shape[0], want["coord"].shape[0]
    if n == 0:
        raise SmokeFailure("empty cloud")
    if n == m:
        dev = np.max(np.abs(got["coord"] - want["coord"]), axis=1)
        if not dev.max() <= 1e-5:
            from mvskit_tpu.utils.metrics import _nn_dist

            d = _nn_dist(got["coord"][:, :3], want["coord"][:, :3])
            raise SmokeFailure(
                f"coord deviates by {dev.max()} > 1e-5 in "
                f"{int((dev > 1e-5).sum())} of {n} rows; as point sets "
                f"{int((d <= 1e-5).sum())} points match within 1e-5, the "
                f"farthest is {d.max():.3e} away"
            )
        return f"same count, max |dcoord| {dev.max():.2e}"
    if abs(n - m) > max(4, m // 10):
        raise SmokeFailure(f"{n} points against {m} on one card")
    return f"{n} points against {m} (within max(4, n/10))"


def mesh_phase(workdir, iterations, views=N_VIEWS, width=WIDTH,
               height=HEIGHT, seeds=SEEDS, **overrides) -> None:
    """`overrides` set MVSConfig fields of every run."""
    from mvskit_tpu.utils import synthetic

    prefix = os.path.join(workdir, "dataset")
    synthetic.write_dataset(prefix, n_views=views, width=width,
                            height=height, n_seeds=seeds)
    want, sec = _run_driver(prefix, None, iterations, **overrides)
    say(f"[mesh] one card: {want['coord'].shape[0]} points, {sec:.2f} s")
    for mesh in MESHES:
        got, sec = _run_driver(prefix, mesh, iterations, **overrides)
        verdict = compare_clouds(got, want, exact=mesh == "1,1,4")
        say(f"[mesh] --mesh {mesh}: {got['coord'].shape[0]} points, "
            f"{sec:.2f} s: {verdict}")


# ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh phase")
    args = ap.parse_args(argv)

    try:
        dev = check_device()
    except NoGPU as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    say(f"[device] {dev['platform']} {dev['kind']} x{dev['count']}")
    say(f"[device] card (name, power limit): {card_line()}")
    if dev["count"] < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} "
              f"devices, have {dev['count']}", file=sys.stderr)
        return 2

    from mvskit_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            if args.cards == 4:
                say(f"[mesh] cut to {MESH_ITERATIONS} iteration(s) of "
                    f"{MESH_PROP_ROUNDS} propagation round(s) per run")
                mesh_phase(work, MESH_ITERATIONS,
                           prop_rounds=MESH_PROP_ROUNDS)
            else:
                import jax

                from mvskit_tpu.utils.synthetic import plane_scene

                Ps, _, scene = plane_scene(
                    n_views=N_VIEWS, width=WIDTH, height=HEIGHT,
                    max_level=LEVEL + 3,
                )
                scene = jax.device_put(scene)
                parity_phase(scene, Ps)
                sampler_phase(scene, Ps)
                del scene
                say(f"[main] {MAIN_ITERATIONS} outer iteration(s) (the CLI "
                    "default is 3; a cold 3-iteration run is mostly "
                    "compile)")
                main_path_phase(
                    work, extra_args=("--iterations", str(MAIN_ITERATIONS))
                )
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
