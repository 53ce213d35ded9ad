"""Multi-chip sharding for the PM-MVS engine.

The reference is strictly single-threaded (SURVEY.md §2: no threads, no
MPI/NCCL); every parallel axis here is greenfield design:

  * patch/batch sharding (DP analog) — the patch table's row axis is
    sharded across the mesh; grid builds, the gauntlet, and filters
    are array programs, so GSPMD partitions them and inserts the
    all-to-alls/reduces for the scatter/sort phases automatically;
  * view sharding (TP analog) — enable_view_sharding marks the scene
    and shards every plane representation over the view axis; from then
    on EVERY NCC window fetch in the engine (gauntlet, filters, driver)
    runs under shard_map with a psum cross-view combine
    (ops/ncc._sample_windows_view_sharded) — the collective replacing
    the reference's all-views loop in optim.cpp:420-425;
  * tile sharding (SP/CP analog) — cell-grid rows are sharded; the
    propagation halo (one cell row) moves by ppermute
    (parallel/tiles.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.patches import PatchTable
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import ncc as nccops


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


# ----------------------------------------------------------------------
# patch-row (DP) sharding
# ----------------------------------------------------------------------

def table_sharding(mesh: Mesh, axis: str = "dp"):
    """Per-leaf NamedShardings for a PatchTable row-sharded over `axis`."""
    def spec(leaf):
        return NamedSharding(
            mesh, P(axis, *([None] * (leaf.ndim - 1)))
        )
    return PatchTable(
        coord=spec(jnp.zeros((1, 4))),
        normal=spec(jnp.zeros((1, 4))),
        ncc=spec(jnp.zeros((1,))),
        dscale=spec(jnp.zeros((1,))),
        ascale=spec(jnp.zeros((1,))),
        images=spec(jnp.zeros((1, 1))),
        vimages=spec(jnp.zeros((1, 1))),
        alive=spec(jnp.zeros((1,))),
    )


def shard_table(table: PatchTable, mesh: Mesh, axis: str = "dp") -> PatchTable:
    """Place the patch table row-sharded across the mesh."""
    shardings = table_sharding(mesh, axis)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), table, shardings
    )


def replicate(tree, mesh: Mesh):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )


# ----------------------------------------------------------------------
# view-sharded NCC (psum over the view axis)
# ----------------------------------------------------------------------

def enable_view_sharding(
    scene: Scene, mesh: Mesh, axis: str = "view"
) -> Scene:
    """Place every plane representation of the scene sharded over the
    mesh's view axis and mark the scene so ops.ncc.texs_for_views runs
    its sampling under shard_map with a psum cross-view combine (the TP
    analog, SURVEY.md §2 — each device stores and samples only its
    views' pyramids).

    Cameras, level metadata and masks stay replicated (geometry and
    mask gates are per-patch, not per-plane). Requires
    n_images % mesh.shape[axis] == 0."""
    import dataclasses

    k = mesh.shape[axis]
    if scene.n_images % k != 0:
        raise ValueError(
            f"n_images={scene.n_images} not divisible by mesh axis "
            f"{axis}={k}"
        )
    sh_v = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    put_v = lambda x: None if x is None else jax.device_put(x, sh_v)
    return dataclasses.replace(
        scene,
        planes=put_v(scene.planes),
        planes_packed=put_v(scene.planes_packed),
        planes_luma_quad=put_v(scene.planes_luma_quad),
        masks=None if scene.masks is None else jax.device_put(scene.masks, rep),
        cams=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, rep), scene.cams
        ),
        lvl_offsets=jax.device_put(scene.lvl_offsets, rep),
        lvl_widths=jax.device_put(scene.lvl_widths, rep),
        lvl_heights=jax.device_put(scene.lvl_heights, rep),
        covis=None if scene.covis is None else jax.device_put(scene.covis, rep),
        view_mesh=mesh,
        view_axis=axis,
    )

# compute_patch_ncc / texs_for_views run view-sharded automatically on
# a scene marked by enable_view_sharding above (ops/ncc.py routes every
# window fetch through shard_map + psum) — no separate sharded op.


# ----------------------------------------------------------------------
# tile sharding (SP/CP analog): the real row-sharded propagation —
# tile-local grid build, merged donor top-k, 1-cell ppermute halo for
# the full-cell gate — lives in parallel/tiles.py
# (tiles.tiled_propagate_round).
# ----------------------------------------------------------------------
