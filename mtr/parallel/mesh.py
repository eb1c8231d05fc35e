"""Device mesh + sharding layer.

The per-read pipeline is embarrassingly parallel over reads/queries, so
the primary axis is data parallelism: DP query batches shard their batch
dim across a 1-D 'dp' mesh over jax.devices() (SURVEY.md 2.13).  Every
device reaches every other at the same rate, so the mesh shape follows
the algorithm alone.

The counts engine itself is single-device; shard_map runs one instance
per device on its local shard of the query batch, which is the right
granularity (queries are independent; no cross-query reduction).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mtr.ops.wrap_dp_counts import local_counts_fn


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        # a silent truncation here would let multichip checks pass
        # vacuously on a 1-device machine
        assert len(devs) >= n_devices, (
            f"requested a {n_devices}-device mesh but only "
            f"{len(devs)} devices are visible"
        )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.lru_cache(maxsize=128)
def sharded_counts_fn(mesh: Mesh, engine: str, b: int, u_pad: int,
                      r_pad: int, axis: str = "dp"):
    """Counts-mode wrap-DP chunk under shard_map: the flat read array is
    replicated, per-job (starts, scal, units) shard their batch dim over
    the mesh, and each device runs the single-device engine
    (ops/wrap_dp_counts.py) on its local shard."""
    n = int(mesh.devices.size)
    assert b % n == 0, f"chunk batch {b} must divide the {n}-way dp axis"
    local = local_counts_fn(engine, b // n, u_pad, r_pad)
    spec = P(axis)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None), spec, spec, spec),
        out_specs=spec,
        check_vma=False,  # the CUDA engine's ffi_call carries no vma info
    )
    return jax.jit(fn)


def device_count() -> int:
    return jax.device_count()
