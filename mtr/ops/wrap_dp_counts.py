"""The counts-mode wrap-DP engine the pipeline dispatches to.

One entry point, fn(flat, starts, scal, unit) -> (B, 15) int32, with
the batch's reads resident on the device as one flat int8 array and
each job addressed by its start offset (the reference fills each DP
from `orgInputString + query_start`, wrap_around_DP.c:237-244, so
every rep stream is a segment of a read already uploaded).

The engine follows the platform of the devices it runs on:
  * "cuda" on the GPU: native/wrap_dp_counts.cu, one warp per job,
    each job running only its own rows, so chunks need no row bucket;
  * "xla" elsewhere: ops/wrap_dp_xla.py, whose row loop runs to the
    chunk's longest job over (B, r_pad) segments gathered on device.

Both return identical rows; u_pad buckets the unit width (<= 512).
"""

from __future__ import annotations

import functools

import jax

U_BUCKETS = (8, 32, 64, 128, 256, 512)
# rep_len buckets of the XLA engine's gathered (B, r_pad) segments
R_BUCKETS = (4096, 32768, 65536, 262144, 1048576)


def bucket(v: int, buckets) -> int:
    for b in buckets:
        if v <= b:
            return b
    return buckets[-1]


def engine_for(platform: str) -> str:
    return "cuda" if platform == "gpu" else "xla"


def default_engine() -> str:
    return engine_for(jax.default_backend())


def row_bucket(engine: str, rep_len: int) -> int:
    """r_pad of a job: 0 for the CUDA kernel, which needs none."""
    return 0 if engine == "cuda" else bucket(rep_len, R_BUCKETS)


def gather_segments(flat, starts, r_pad: int):
    """(B,) starts -> (B, r_pad) int8 segments of the 1-D flat array.
    A segment may run past its read into the next one: harmless, the
    engine masks rows beyond rep_len.  The flat array carries >= r_pad
    trailing slack, so dynamic_slice never clamps (a clamp would shift
    the segment)."""
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(flat, (s,), (r_pad,))
    )(starts)


def local_counts_fn(engine: str, b: int, u_pad: int, r_pad: int):
    """Un-jitted per-device fn(flat, starts, scal, unit)."""
    if engine == "cuda":
        from mtr.ops.wrap_dp_cuda import counts_cuda

        return counts_cuda
    from mtr.ops.wrap_dp_xla import make_wrap_dp_counts_xla

    inner = make_wrap_dp_counts_xla(b, u_pad, r_pad)

    def fn(flat, starts, scal, unit):
        return inner(scal, gather_segments(flat, starts, r_pad), unit)

    return fn


@functools.lru_cache(maxsize=64)
def counts_fn(engine: str, b: int, u_pad: int, r_pad: int):
    return jax.jit(local_counts_fn(engine, b, u_pad, r_pad))
