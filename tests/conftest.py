"""Test configuration.

Force JAX onto a virtual 8-device CPU mesh BEFORE any jax import so the
multi-device sharding paths are exercised without an accelerator.
Tests that need the GPU carry the `gpu` marker and skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # also forced via jax.config below,
# in case a platform plugin registered itself before this ran
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
