"""Sharded DI stencil wired INTO the pipeline (VERDICT r2 missing #2 /
next-step #6): on a multi-device mesh, a device-backend read past the DI
threshold must route its Manhattan sweep through the position-sharded
halo-exchange stencil and still byte-match the host pipeline."""

import dataclasses
import io
import tempfile

import pytest

jax = pytest.importorskip("jax")

import mtr.ops.directional_index as di_ops  # noqa: E402
import mtr.pipeline as P  # noqa: E402
from mtr.config import MTRConfig  # noqa: E402
from mtr.testutil.rand_seq import write_fasta  # noqa: E402


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8-device mesh")
def test_pipeline_uses_sharded_di_and_matches_host():
    calls = []
    orig = di_ops.sliding_l1_sharded

    def spy(*a, **kw):
        calls.append(a[1])  # w
        return orig(*a, **kw)

    # ~12 kb read (unit 10 x 400 + flanks) crosses a tiny DI threshold
    with tempfile.TemporaryDirectory() as td:
        fa = td + "/long.fasta"
        write_fasta(fa, td + "/long.units", 10, 400, 2.0, 2.0, 2.0,
                    4000, 4000, 1, seed=11)
        host_out = io.StringIO()
        P.run_file(fa, MTRConfig(backend="host"), host_out)

        cfg = dataclasses.replace(
            MTRConfig(backend="device", use_native=False),
            device_di_threshold=8192,
        )
        P._device_di_compute_cached.cache_clear()
        di_ops.sliding_l1_sharded = spy
        # the pipeline resolves di_manhattan_sharded via the module-level
        # name captured in make_di_manhattan_sharded's closure
        try:
            dev_out = io.StringIO()
            P.run_file(fa, cfg, dev_out)
        finally:
            di_ops.sliding_l1_sharded = orig
            P._device_di_compute_cached.cache_clear()

    assert host_out.getvalue() == dev_out.getvalue()
    assert host_out.getvalue().strip(), "no records produced"
    assert calls, "sharded DI stencil never engaged"
