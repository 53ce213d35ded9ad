"""Test configuration: force the CPU backend with 8 virtual devices.

Tests run on the CPU (JAX_PLATFORMS=cpu) and never need a GPU; the
mesh and sharding paths are validated on host-platform virtual devices
(SURVEY.md §4). The device count must be in XLA_FLAGS before JAX
starts, and the platform is also pinned through jax.config so a GPU
machine runs the tests on its CPU too. The card itself is exercised by
chip_smoke.py."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
