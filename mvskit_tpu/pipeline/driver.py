"""Pipeline driver (the reference's PmMvps class).

Owns the scene, the patch table, the threshold schedule, and the
iteration loop (reference pmmvps/pmmvps.cpp:18-114): seed ->
[propagate -> snapshot -> filter -> anneal -> snapshot] x 3. The
annealed thresholds are passed into the jitted stages as traced scalars
so the schedule never retriggers compilation.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MVSConfig
from ..core import patches as pt
from ..core.grid import _pow2_limit
from ..image.scene import Scene, load_scene
from ..io import patch_io, ply
from ..ops import sampling
from . import filters as fl
from . import propagate as pr
from . import seed as seedmod


def _encode_and_write(
    path_prefix: str,
    data: Dict[str, np.ndarray],
    rgb: Optional[np.ndarray],
    image_ids: np.ndarray,
    export_ply: bool,
    export_patch: bool,
    binary_ply: bool,
) -> None:
    """Host-only snapshot encode + disk write (runs in the snapshot
    writer thread when write_patches(wait=False))."""
    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    if export_ply:
        ply.write_ply(
            path_prefix + ".ply",
            data["coord"][:, :3],
            normal=data["normal"][:, :3],
            rgb=rgb,
            binary=binary_ply,
        )
    if export_patch:
        def translate(padded):
            return [
                [int(image_ids[v]) for v in row[row >= 0]] for row in padded
            ]

        patch_io.write_patch_file(
            path_prefix + ".patch",
            data["coord"],
            data["normal"],
            data["ncc"],
            data["dscale"],
            data["ascale"],
            translate(data["images"]),
            translate(data["vimages"]),
        )


class PMMVS:
    def __init__(self, cfg: MVSConfig, scene: Optional[Scene] = None,
                 log=print, view_mesh=None):
        self.cfg = cfg
        self.log = log
        with self.stage("init"):
            self.scene = scene if scene is not None else load_scene(
                cfg.prefix, cfg.images, cfg.nillums, cfg.max_level,
                use_vis_data=bool(cfg.use_vis_data),
            )
        # device mesh (cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile): the
        # driver builds one mesh carrying all three greenfield parallel
        # axes (SURVEY.md §2) and routes each stage accordingly —
        #   dp:   patch-table rows sharded, the filters partition via
        #         GSPMD, propagation runs on a replicated copy
        #         (propagate);
        #   view: pyramid planes sharded, every NCC window fetch runs
        #         under shard_map with a psum cross-view combine
        #         (parallel/shard.enable_view_sharding) — each device
        #         samples its own shard;
        #   tile: propagation runs parallel/tiles.tiled_propagate_round
        #         (tile-local grid build, merged donor top-k, ppermute
        #         halo full-cell gate).
        self.mesh = None
        n_mesh = cfg.mesh_dp * cfg.mesh_view * cfg.mesh_tile
        if n_mesh > 1:
            from jax.sharding import Mesh

            devs = jax.devices()
            if len(devs) < n_mesh:
                raise ValueError(
                    f"mesh ({cfg.mesh_dp},{cfg.mesh_view},"
                    f"{cfg.mesh_tile}) needs {n_mesh} devices, have "
                    f"{len(devs)}"
                )
            self.mesh = Mesh(
                np.asarray(devs[:n_mesh]).reshape(
                    cfg.mesh_dp, cfg.mesh_view, cfg.mesh_tile
                ),
                ("dp", "view", "tile"),
            )
            if cfg.mesh_view > 1:
                from ..parallel import shard as _sh

                self.scene = _sh.enable_view_sharding(
                    self.scene, self.mesh, axis="view"
                )
        # legacy single-axis view mesh (kept for direct callers/tests)
        if view_mesh is not None:
            from ..parallel import shard as _sh

            self.scene = _sh.enable_view_sharding(self.scene, view_mesh)
        self.table: Optional[pt.PatchTable] = None
        # mutable threshold state (annealed; reference pmmvps.cpp:70-74)
        self.ncc_threshold = cfg.ncc_threshold
        self.ncc_threshold_before = cfg.ncc_threshold_before
        self.count_threshold1 = cfg.count_threshold1
        self.depth = 0
        self._key = jax.random.PRNGKey(0)

        self._prop_step = jax.jit(
            pr.propagate_round,
            static_argnames=("p", "direction", "use_depth", "row_limit"),
        )
        # tile axis > 1: propagation goes through the row-sharded round
        # (observationally identical to propagate_round under the same
        # key — tests/test_tiles.py, tests/test_driver_mesh.py)
        self._tiled_step = None
        if self.mesh is not None and cfg.mesh_tile > 1:
            from ..parallel import tiles as _tiles

            self._tiled_step = jax.jit(
                functools.partial(
                    _tiles.tiled_propagate_round, self.mesh
                ),
                static_argnames=("p", "direction", "use_depth"),
            )
        # compaction keeps alive rows in a prefix so every row loop and
        # grid-build sort bounds itself to the live prefix (row_limit
        # static args, quantized to powers of two to bound jit variants)
        self._compact = jax.jit(pt.compact_table)
        self._row_bound: Optional[int] = None
        from . import expand as ex

        self._expand_step = jax.jit(
            ex.expand_round,
            static_argnames=("p", "depth", "use_depth"),
        )
        # the filter suite runs as SEPARATE jitted phases with a host
        # count pull after each, which gives phase-level progress and
        # timing (whether fusing them pays is ROADMAP A5)
        self._f_rebuild = jax.jit(
            functools.partial(
                fl.rebuild,
                level=cfg.level,
                csize=cfg.csize,
                capacity=cfg.filter_cell_capacity,
                neighbor_threshold=cfg.neighbor_threshold,
            ),
            static_argnames=("additive", "row_limit"),
        )
        self._f_outside = jax.jit(
            functools.partial(
                fl.filter_outside,
                level=cfg.level,
                csize=cfg.csize,
                neighbor_threshold1=cfg.neighbor_threshold1,
            ),
            static_argnames=("row_limit",),
        )
        self._f_exact = jax.jit(
            functools.partial(
                fl.filter_exact,
                level=cfg.level,
                csize=cfg.csize,
                wsize=cfg.wsize,
                min_image_num=cfg.min_image_num,
                neighbor_threshold1=cfg.neighbor_threshold1,
                angle_threshold1=cfg.angle_threshold1,
            ),
            static_argnames=("row_limit",),
        )
        self._f_neighbor = jax.jit(
            functools.partial(
                fl.filter_neighbor_rows,
                level=cfg.level,
                csize=cfg.csize,
                tau=cfg.tau,
                neighbor_threshold=cfg.neighbor_threshold,
                max_neighbors=cfg.neighbor_capacity,
                cand_cap=cfg.neighbor_cand_cap,
            ),
            static_argnames=("row_count",),
        )
        self._f_groups = jax.jit(
            functools.partial(
                fl.filter_small_groups,
                level=cfg.level,
                csize=cfg.csize,
                neighbor_threshold2=cfg.neighbor_threshold2,
                iters=cfg.small_group_iters,
            ),
            static_argnames=("row_limit",),
        )
        self._hwm = jax.jit(
            lambda alive: jnp.max(
                jnp.where(
                    alive,
                    jnp.arange(alive.shape[0], dtype=jnp.int32),
                    -1,
                )
            )
        )
        # snapshot color pass over the FULL (static-shape) table: one
        # jitted dispatch instead of many eager ops
        self._colors_full = jax.jit(self._mean_colors)
        # stage pipelining (PP analog, SURVEY.md §2): snapshot encode +
        # disk write overlap the next device stage in a writer thread —
        # the device arrays are functional so the filter running
        # concurrently never mutates a snapshot's table
        import concurrent.futures as _cf

        self._snap_pool = _cf.ThreadPoolExecutor(max_workers=1)
        self._snap_futures = []

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str):
        """Time a pipeline stage on the host clock and log it as
        `stage <name>: <seconds> s`. Every stage ends in a host pull of
        its results, so the time covers the device work it enqueued,
        compilation included."""
        t0 = time.perf_counter()
        yield
        self.log(f"stage {name}: {time.perf_counter() - t0:.3f} s")

    @property
    def prop_params(self) -> pr.PropagateParams:
        cfg = self.cfg
        return pr.PropagateParams(
            level=cfg.level,
            csize=cfg.csize,
            wsize=cfg.wsize,
            tau=cfg.tau,
            min_image_num=cfg.min_image_num,
            cell_capacity=cfg.max_patches_per_cell,
            angle_threshold0=cfg.angle_threshold0,
            angle_threshold1=cfg.angle_threshold1,
            max_angle_threshold=cfg.max_angle_threshold,
            ascale=cfg.ascale,
            refine_rounds=cfg.refine_rounds,
            refine_cands=cfg.refine_cands,
            refine_shrink=cfg.refine_shrink,
            refine_depth_radius=cfg.refine_init_depth_radius,
            refine_angle_radius=cfg.refine_init_angle_radius,
            neighbor_threshold=cfg.neighbor_threshold,
            donor_budget=cfg.donor_budget,
            chunk=cfg.gauntlet_chunk,
            neighbor_threshold1=cfg.neighbor_threshold1,
            depth2_check=self.depth >= 2,
            grad_steps=cfg.refine_grad_steps,
            grad_lr=cfg.refine_grad_lr,
            luma_refine=cfg.luma_refine,
            neighbor_capacity=cfg.neighbor_capacity,
            neighbor_cand_cap=cfg.neighbor_cand_cap,
            donor_policy=cfg.donor_policy,
            rgb_tail=cfg.refine_rgb_tail,
            n_illums=self.scene.n_illums if cfg.use_illums else 1,
        )

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    # ------------------------------------------------------------------
    def seed(self, resume_iter: int = 0) -> None:
        """DepthNormInit::createPatches + depth counter bump
        (reference pmmvps.cpp:84-85)."""
        with self.stage("seed"):
            self.table = seedmod.seed(
                self.scene, self.cfg, self.cfg.prefix, resume_iter
            )
            if self.mesh is not None and self.cfg.mesh_dp > 1:
                # DP: table rows sharded across the mesh; the filters
                # are array programs that GSPMD partitions from the
                # input shardings (propagation: see propagate)
                from ..parallel import shard as _sh

                self.table = _sh.shard_table(
                    self.table, self.mesh, axis="dp"
                )
            n = int(np.asarray(self.table.n_alive()))
        self.depth = 1
        # seeds fill a prefix (from_numpy), so the live-row bound is n
        self._row_bound = n
        self.log(f"seeded {n} patches")

    def propagate(self, iteration: int) -> pr.RoundStats:
        """One outer expansion phase: cfg.prop_rounds rounds of the
        selected strategy — "pm_image" checkerboard propagation (the
        reference's live path, sweep direction from the iteration
        parity, propagate.cpp:80-85) or "pmvs" scene-space expansion
        (the reference's alternative, propagate.cpp:384-691). Effort
        counters reset per phase (clearCounts, propagate.cpp:36).

        With a dp axis the rounds run on a replicated copy of the
        table, re-sharded afterwards. GSPMD keeps the gauntlet
        replicated either way, but from a row-sharded table it splits
        the round's table reads into partial gathers and all-reduces.
        On the GPU that moves the hypotheses' coordinates by a few ulps,
        and the random search turns those into different poses, so the
        cloud drifts from the one-card result (PERF.md). From a
        replicated table the round compiles to the one-card program."""
        dp = self.mesh is not None and self.cfg.mesh_dp > 1
        if dp:
            from ..parallel import shard as _sh

            self.table = _sh.replicate(self.table, self.mesh)
        stats = self._propagate_rounds(iteration)
        if dp:
            self.table = _sh.shard_table(self.table, self.mesh, axis="dp")
        return stats

    def _propagate_rounds(self, iteration: int) -> pr.RoundStats:
        direction = 1 if iteration % 2 == 0 else -1
        total = None
        if self.cfg.strategy == "pmvs":
            from . import expand as ex

            state = ex.init_state(self.scene, self.cfg.level, self.cfg.csize)
            for _ in range(self.cfg.prop_rounds):
                self.table, state, stats = self._expand_step(
                    self.scene,
                    self.table,
                    state,
                    self._next_key(),
                    p=self.prop_params,
                    ncc_threshold=jnp.float32(self.ncc_threshold),
                    ncc_threshold_before=jnp.float32(self.ncc_threshold_before),
                    count_threshold=jnp.int32(self.count_threshold1),
                    depth=self.depth,
                    use_depth=self.depth > 0,
                    quad_threshold=jnp.float32(self.cfg.quad_threshold),
                )
                total = stats if total is None else pr.RoundStats(
                    *(a + b for a, b in zip(total, stats))
                )
            t, f0, f1, p_ = (int(np.asarray(v)) for v in total)
            self.log(
                f"iter {iteration}: total {t} pass {p_} fail0 {f0} "
                f"fail1 {f1} alive {int(np.asarray(self.table.n_alive()))}"
            )
            return total
        N = self.table.capacity
        for _ in range(self.cfg.prop_rounds):
            if self._tiled_step is not None:
                # row-sharded round (SP/CP): same key stream and
                # params, identical output (parallel/tiles.py)
                self.table, stats = self._tiled_step(
                    self.scene,
                    self.table,
                    self._next_key(),
                    p=self.prop_params,
                    direction=direction,
                    ncc_threshold=jnp.float32(self.ncc_threshold),
                    ncc_threshold_before=jnp.float32(
                        self.ncc_threshold_before
                    ),
                    use_depth=self.depth > 0,
                    quad_threshold=jnp.float32(self.cfg.quad_threshold),
                )
                total = stats if total is None else pr.RoundStats(
                    *(a + b for a, b in zip(total, stats))
                )
                continue
            # live-row bound: grows at most by the accepted hypotheses
            # of a round (insertions fill the lowest dead rows first),
            # so bumping by the hypothesis count is a sound no-sync
            # over-estimate; the filter stage re-compacts and re-syncs
            rl = _pow2_limit(max(self._row_bound or N, 1), N)
            self.table, stats = self._prop_step(
                self.scene,
                self.table,
                self._next_key(),
                p=self.prop_params,
                direction=direction,
                ncc_threshold=jnp.float32(self.ncc_threshold),
                ncc_threshold_before=jnp.float32(self.ncc_threshold_before),
                use_depth=self.depth > 0,
                quad_threshold=jnp.float32(self.cfg.quad_threshold),
                row_limit=rl,
            )
            if self._row_bound is not None:
                self._row_bound = min(
                    N, self._row_bound + 2 * self.cfg.donor_budget
                )
            total = stats if total is None else pr.RoundStats(
                *(a + b for a, b in zip(total, stats))
            )
        t, f0, f1, p_ = (int(np.asarray(v)) for v in total)
        self.log(
            f"iter {iteration}: total {t} pass {p_} fail0 {f0} fail1 {f1} "
            f"alive {int(np.asarray(self.table.n_alive()))}"
        )
        return total

    def filter(self) -> fl.FilterStats:
        # Filter::run (reference filter.cpp:25-49) as separate short
        # device programs: rebuild -> outside -> rebuild -> exact ->
        # rebuild -> neighbor -> rebuild -> groups -> rebuild
        ncc_thr = jnp.float32(self.ncc_threshold)
        quad_thr = jnp.float32(self.cfg.quad_threshold)
        # compact alive rows to a prefix and sync the exact live bound:
        # every phase below then scans only the live prefix (row_limit)
        t = self._compact(self.table)
        N = t.capacity
        hwm = int(np.asarray(self._hwm(t.alive)))
        self._row_bound = hwm + 1
        R = _pow2_limit(max(hwm + 1, 1), N)
        t_phase = time.time()

        def sync(x, what):
            # pulling the count to host ends the phase before the next
            # enqueues, which gives phase-level progress + timing
            nonlocal t_phase
            v = int(np.asarray(x))
            now = time.time()
            self.log(f"  filter phase {what}: {v} ({now - t_phase:.1f}s)")
            t_phase = now
            return v

        t, grid = self._f_rebuild(self.scene, t, additive=False, row_limit=R)
        t, n_out = self._f_outside(
            self.scene, grid, t, ncc_threshold=ncc_thr, row_limit=R
        )
        o = sync(n_out, "outside")
        t, grid = self._f_rebuild(self.scene, t, additive=True, row_limit=R)
        t, n_exact = self._f_exact(self.scene, grid, t, row_limit=R)
        e = sync(n_exact, "exact")
        t, grid = self._f_rebuild(self.scene, t, additive=True, row_limit=R)
        # neighbor filter in row segments (bounded per-program
        # temporaries at large capacity). Every segment
        # sees the ROUND-START table (reference filterNeighbor removes
        # at the end of the pass); alive masks merge afterwards. Rows
        # past the live high-water mark are dead by construction, so
        # their segments are skipped entirely.
        seg = min(32768, N)
        n = 0
        merged = t.alive
        for off in range(0, min(hwm + 1, N), seg):
            t_seg, nk = self._f_neighbor(
                self.scene, grid, t, jnp.int32(off), row_count=seg,
                quad_threshold=quad_thr,
            )
            n += sync(nk, f"neighbor[{off}:{off + seg}]")
            merged = merged & t_seg.alive
        t = t._replace(alive=merged)
        n_nb = jnp.int32(n)
        t, grid = self._f_rebuild(self.scene, t, additive=True, row_limit=R)
        t, n_grp = self._f_groups(self.scene, grid, t, row_limit=R)
        g = sync(n_grp, "groups")
        t, _ = self._f_rebuild(self.scene, t, additive=True, row_limit=R)
        self.table = t
        stats = fl.FilterStats(n_out, n_exact, n_nb, n_grp)
        self.log(
            f"filters removed: outside {o} exact {e} neighbor {n} "
            f"groups {g}; alive {int(np.asarray(self.table.n_alive()))}"
        )
        return stats

    def update_threshold(self) -> None:
        """Threshold annealing (reference pmmvps.cpp:70-74)."""
        self.ncc_threshold -= self.cfg.anneal_ncc_step
        self.ncc_threshold_before -= self.cfg.anneal_ncc_step
        self.count_threshold1 = 2

    def run(self, write_snapshots: bool = True) -> None:
        """PmMvps::run (reference pmmvps.cpp:76-114). Snapshot encoding
        and disk writes overlap the following device stage (the PP
        analog — snapshots are the only stage with no forward data
        dependency)."""
        t0 = time.time()
        if self.table is None:
            self.seed()
        for it in range(self.cfg.n_iterations):
            self.log(f"--- iteration {it} ---")
            with self.stage(f"propagate[{it}]"):
                self.propagate(it)
            if write_snapshots:
                with self.stage(f"snapshot[{it}] before filter"):
                    self.write_patches(
                        os.path.join(
                            self.cfg.prefix, "ply",
                            f"refined_patches_before_refine_{it}",
                        ),
                        wait=False,
                    )
            with self.stage(f"filter[{it}]"):
                self.filter()
            self.update_threshold()
            self.depth += 1
            if write_snapshots:
                with self.stage(f"snapshot[{it}] after filter"):
                    self.write_patches(
                        os.path.join(
                            self.cfg.prefix, "ply", f"refined_patches_{it}"
                        ),
                        wait=False,
                    )
        with self.stage("snapshot writes (join)"):
            self.join_snapshots()
        self.log(f"---- Total: {time.time() - t0:.1f} secs ----")

    def _mean_colors(self, scene, coord, images):
        """Mean color over each patch's views for the whole table
        (reference patch_manager.cpp:566-587, mode 0), jitted once at
        the fixed table capacity. Runs in 32k-row chunks, which bounds
        the per-(patch, view) temporaries (ROADMAP C4 re-measures the
        chunking)."""
        N = coord.shape[0]
        C = min(32768, N)
        n_chunks = (N + C - 1) // C
        pad = n_chunks * C - N

        def one(args):
            c, im = args
            idx = jnp.maximum(im, 0)
            cols = sampling.color_at_coord(
                scene, idx, c[:, None, :], self.cfg.level
            )
            valid = (im >= 0)[..., None]
            denom = jnp.maximum(jnp.sum(valid, axis=1), 1)
            mean = jnp.sum(jnp.where(valid, cols, 0.0), axis=1) / denom
            return jnp.clip(jnp.floor(mean + 0.5), 0, 255).astype(
                jnp.uint8
            )

        c = coord.astype(jnp.float32)
        im = images
        if pad:
            c = jnp.concatenate([c, jnp.zeros((pad, 4), jnp.float32)])
            im = jnp.concatenate(
                [im, jnp.full((pad, im.shape[1]), -1, im.dtype)]
            )
        out = jax.lax.map(
            one,
            (
                c.reshape(n_chunks, C, 4),
                im.reshape(n_chunks, C, im.shape[1]),
            ),
        )
        return out.reshape(n_chunks * C, 3)[:N]

    # ------------------------------------------------------------------
    def collect(self, table: Optional[pt.PatchTable] = None) -> Dict[str, np.ndarray]:
        """Alive patches on the host."""
        t = self.table if table is None else table
        alive = np.asarray(t.alive)
        idx = np.nonzero(alive)[0]
        return {
            "coord": np.asarray(t.coord)[idx],
            "normal": np.asarray(t.normal)[idx],
            "ncc": np.asarray(t.ncc)[idx],
            "dscale": np.asarray(t.dscale)[idx],
            "ascale": np.asarray(t.ascale)[idx],
            "images": np.asarray(t.images)[idx],
            "vimages": np.asarray(t.vimages)[idx],
        }

    def patch_colors(self, coord: np.ndarray, images: np.ndarray) -> np.ndarray:
        """Mean color over a patch's views (reference
        patch_manager.cpp:566-587, mode 0)."""
        pad = self.table.capacity if self.table is not None else coord.shape[0]
        n = coord.shape[0]
        if n == pad:
            c = jnp.asarray(coord, jnp.float32)
            i = jnp.asarray(images)
            return np.asarray(self._colors_full(self.scene, c, i))
        cfull = np.zeros((pad, coord.shape[1]), np.float32)
        cfull[:n] = coord
        ifull = np.full((pad, images.shape[1]), -1, np.int32)
        ifull[:n] = images
        out = np.asarray(
            self._colors_full(
                self.scene, jnp.asarray(cfull), jnp.asarray(ifull)
            )
        )
        return out[:n]

    def join_snapshots(self) -> None:
        """Barrier for the snapshot writer thread (PP overlap); also
        re-raises any snapshot I/O error."""
        futs, self._snap_futures = self._snap_futures, []
        for f in futs:
            f.result()

    def write_patches(
        self,
        path_prefix: str,
        export_ply: bool = True,
        export_patch: bool = False,
        binary_ply: bool = False,
        wait: bool = True,
    ) -> None:
        """PatchManager::writePatches (reference
        patch_manager.cpp:499-540).

        Device work (host pull + the jitted color pass) happens here;
        with wait=False the PLY/patch encoding and disk write run in
        the writer thread, overlapping the next pipeline stage."""
        data = self.collect()
        rgb = (
            self.patch_colors(data["coord"], data["images"])
            if export_ply
            else None
        )
        image_ids = np.asarray(self.cfg.images, dtype=np.int64)
        job = functools.partial(
            _encode_and_write, path_prefix, data, rgb, image_ids,
            export_ply, export_patch, binary_ply,
        )
        if wait:
            job()
        else:
            self._snap_futures.append(self._snap_pool.submit(job))
