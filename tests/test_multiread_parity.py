"""Multi-read byte parity vs the reference binary.

The golden was produced by the reference mTR built unmodified, run with
GLIBC_TUNABLES=glibc.malloc.tcache_count=0 — a deterministic-allocator
configuration.  Default-glibc reference runs break ties between
identical-coordinate alignments by malloc address order (see PARITY.md);
this golden pins the allocator-independent semantics.  20 reads exercise
every cross-read persistent-buffer quirk (stale input_w_rand tail, arena
reuse) that single-read fixtures cannot.
"""

import io

import pytest
import os

from mtr.config import MTRConfig
from mtr.pipeline import run_file

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _run(backend: str) -> str:
    out = io.StringIO()
    run_file(
        f"{GOLDEN}/multi20_100x10.fasta",
        MTRConfig(backend=backend, reads_per_batch=16),  # forces 2 batches
        out,
    )
    return out.getvalue()


def test_multiread_host_parity():
    with open(f"{GOLDEN}/multi20_100x10.out") as f:
        assert _run("host") == f.read()


def test_multiread_hybrid_parity():
    """Hybrid split (big jobs -> device path, small -> host) must not
    change output; on the CPU test mesh the device leg runs the XLA
    counts engine."""
    with open(f"{GOLDEN}/multi20_100x10.out") as f:
        assert _run("hybrid") == f.read()


def test_multiread_batch_boundary_invariance():
    """Batching must not change output: 20 reads as 2 batches vs 20."""
    out = io.StringIO()
    run_file(
        f"{GOLDEN}/multi20_100x10.fasta",
        MTRConfig(backend="host", reads_per_batch=128),
        out,
    )
    assert out.getvalue() == _run("host")


def test_alignment_print_parity():
    """-a pretty-printed alignments byte-match the reference
    (wrap_around_DP.c:57-213: 50-column blocks in reverse chunk order)."""
    out = io.StringIO()
    run_file(
        "/root/reference/test_multiple_TRs/data/3_5.fasta",
        MTRConfig(backend="host", print_alignment=True),
        out,
    )
    with open(f"{GOLDEN}/3_5_alignment.out") as f:
        assert out.getvalue() == f.read()


@pytest.mark.parametrize("name", ["worm_chrI", "worm_chrII_1", "worm_chrII_2"])
def test_real_nanopore_host_parity(name):
    """Real C. elegans Nanopore reads (92-140 kbp) through the batched
    host pipeline must byte-match the reference binary's goldens."""
    out = io.StringIO()
    run_file(
        f"/root/reference/test_multiple_TRs/data/{name}.fasta",
        MTRConfig(backend="host"),
        out,
    )
    with open(f"{GOLDEN}/{name}.out") as f:
        assert out.getvalue() == f.read()
