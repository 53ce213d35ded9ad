"""Multi-host (multi-process) execution: the DCN tier of the mesh.

The reference is a single process on one workstation (SURVEY.md §2:
no threads, no MPI/NCCL); this module is the greenfield N>=2-host tier
of the engine's parallelism stack. Within a host the collectives ride
the device interconnect (parallel/shard.py, parallel/tiles.py); across
hosts JAX's single-controller-per-process runtime carries the same
`psum` / `ppermute` programs over the network. The program is IDENTICAL — shard_map
over a global mesh — only array construction changes, because each
process can only materialize the shards its own devices hold.

Entry points:
  * init_distributed()     — jax.distributed.initialize wrapper (DCN
                             rendezvous; gloo collectives on CPU so the
                             path is testable on one machine).
  * global_view_mesh()     — a Mesh over ALL processes' devices.
  * enable_view_sharding_global(scene, mesh)
                           — multi-process analog of
                             shard.enable_view_sharding: plane pyramids
                             view-sharded across hosts, cameras and
                             level metadata replicated; every NCC window
                             fetch then runs under shard_map with a
                             cross-host psum (ops/ncc.texs_for_views).
  * shard_table_global()   — patch-table rows DP-sharded across all
                             hosts' devices.
  * to_host_replicated()   — pull a (replicated) result to local numpy.

Tested for real in tests/test_multihost.py: two OS processes, gloo
collectives, view-sharded NCC equal to the single-process value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.patches import PatchTable
from ..image.scene import Scene


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """Join the multi-process runtime.

    Pass coordinator/num_processes/process_id explicitly: nothing in a
    single machine's environment describes a cluster;
    `local_device_count` forces N virtual CPU devices per process and
    selects gloo collectives so cross-process psum works on CPU.
    """
    if local_device_count is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.config.update(
            "jax_num_cpu_devices", int(local_device_count)
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_view_mesh(axis: str = "view", n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over every device of every process (DCN-spanning)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _make_global(x, mesh: Mesh, spec: P):
    """Build a global array from this process's full host copy.

    Uses make_array_from_callback so each process materializes ONLY the
    shards its own devices hold — the host copy can come from loading
    just this host's slice of the dataset (the callback indexes into
    whatever the host has)."""
    if x is None:
        return None
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def _replicate_tree(tree, mesh: Mesh):
    return jax.tree_util.tree_map(
        lambda x: _make_global(x, mesh, P()), tree
    )


def enable_view_sharding_global(
    scene: Scene, mesh: Mesh, axis: str = "view"
) -> Scene:
    """Multi-process analog of shard.enable_view_sharding (same
    semantics, same downstream shard_map path in ops/ncc.py): pyramid
    plane arrays sharded over the mesh's view axis ACROSS HOSTS,
    cameras / level metadata / masks replicated. Requires
    n_images % mesh.shape[axis] == 0."""
    k = mesh.shape[axis]
    if scene.n_images % k != 0:
        raise ValueError(
            f"n_images={scene.n_images} not divisible by mesh axis "
            f"{axis}={k}"
        )
    sh_v = P(axis)
    put_v = lambda x: _make_global(x, mesh, sh_v)
    return dataclasses.replace(
        scene,
        planes=put_v(scene.planes),
        planes_packed=put_v(scene.planes_packed),
        planes_luma_quad=put_v(scene.planes_luma_quad),
        masks=_make_global(scene.masks, mesh, P()),
        cams=_replicate_tree(scene.cams, mesh),
        lvl_offsets=_make_global(scene.lvl_offsets, mesh, P()),
        lvl_widths=_make_global(scene.lvl_widths, mesh, P()),
        lvl_heights=_make_global(scene.lvl_heights, mesh, P()),
        covis=_make_global(scene.covis, mesh, P()),
        view_mesh=mesh,
        view_axis=axis,
    )


def shard_table_global(
    table: PatchTable, mesh: Mesh, axis: str = "dp"
) -> PatchTable:
    """Patch-table rows DP-sharded over all processes' devices
    (multi-process analog of shard.shard_table)."""
    return jax.tree_util.tree_map(
        lambda x: _make_global(
            x, mesh, P(axis, *([None] * (np.ndim(x) - 1)))
        ),
        table,
    )


def to_host_replicated(x) -> np.ndarray:
    """A replicated (out_specs=P()) result as local numpy — every
    process holds a full replica on its first addressable device."""
    return np.asarray(x.addressable_data(0))
