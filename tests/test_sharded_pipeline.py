"""Full-pipeline data parallelism over the 8-device CPU mesh.

VERDICT r2 #4: the whole read pipeline (DI + walks + DP + polish +
chaining) must run with its device work sharded over a mesh and
byte-match the single-device run — not just the isolated DP step.
ShardedWrapDPBatcher shard_maps every resident chunk over the 'dp' axis
(reads/queries are the embarrassingly parallel axis, SURVEY.md 2.13;
reference processes reads sequentially, handle_one_file.c:281-287).
"""

import io
import os
import tempfile

import pytest

jax = pytest.importorskip("jax")

import mtr.pipeline as P  # noqa: E402
from mtr.config import MTRConfig  # noqa: E402
from mtr.parallel.mesh import make_mesh  # noqa: E402
from mtr.testutil.rand_seq import write_fasta  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _run_with(batcher, fasta, cfg):
    buf = io.StringIO()
    orig = P.make_batcher
    P.make_batcher = lambda _cfg: batcher
    try:
        P.run_file(fasta, cfg, buf)
    finally:
        P.make_batcher = orig
    return buf.getvalue()


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8-device mesh")
def test_sharded_pipeline_matches_single_device_and_golden():
    # native walks: the device DBG engine is not what this test shards
    cfg = MTRConfig(backend="device", reads_per_batch=8,
                    use_device_walks=False)
    fasta = os.path.join(GOLDEN, "multi20_100x10.fasta")
    single = _run_with(P.WrapDPBatcher(), fasta, cfg)
    sharded = _run_with(P.ShardedWrapDPBatcher(make_mesh(8)), fasta, cfg)
    assert single == sharded
    assert single == open(os.path.join(GOLDEN, "multi20_100x10.out")).read()


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8-device mesh")
def test_sharded_pipeline_polish_path():
    """Unit 20 x 10 copies => coverage in [5,20] and period > 5: the
    polish/revision rounds run.  Their consensus-mode jobs take the host
    engine, and every counts chunk runs sharded over the mesh."""
    counts_chunks = []
    host_cons_jobs = []
    orig_dispatch = P.WrapDPBatcher._dispatch
    orig_host = P.HostDPBatcher._run

    def spy_dispatch(self, engine, jobs, chunk, *a):
        if isinstance(self, P.ShardedWrapDPBatcher):
            assert all(jobs[i].mode == "counts" for i in chunk)
            counts_chunks.append(len(chunk))
        return orig_dispatch(self, engine, jobs, chunk, *a)

    def spy_host(self, jobs):
        host_cons_jobs.extend(j for j in jobs if j.mode == "consensus")
        return orig_host(self, jobs)

    cfg = MTRConfig(backend="device", reads_per_batch=4, use_native=False)
    with tempfile.TemporaryDirectory() as td:
        fa = td + "/dry.fasta"
        write_fasta(fa, td + "/dry.units", 20, 10, 2.0, 2.0, 2.0,
                    200, 200, 3, seed=7)
        single = _run_with(P.WrapDPBatcher(), fa, cfg)
        P.WrapDPBatcher._dispatch = spy_dispatch
        P.HostDPBatcher._run = spy_host
        try:
            sharded = _run_with(
                P.ShardedWrapDPBatcher(make_mesh(8)), fa, cfg)
        finally:
            P.WrapDPBatcher._dispatch = orig_dispatch
            P.HostDPBatcher._run = orig_host
    assert single
    assert single == sharded
    assert counts_chunks, "no counts chunk ran on the sharded path"
    assert host_cons_jobs, "polish never reached the host engine"


def test_make_mesh_rejects_oversubscription():
    n = jax.device_count()
    with pytest.raises(AssertionError):
        make_mesh(n + 1)
