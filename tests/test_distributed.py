"""Multi-host sharded run (simulated in-process): per-host shards plus
the deterministic merge must reproduce the single-process output."""

import io

import pytest

from mtr.config import MTRConfig
from mtr.pipeline import run_file
from mtr.parallel.distributed import run_file_sharded, merge_outputs

FASTA = "/root/reference/test_multiple_TRs/data/2_5_10_20_set.fasta"


@pytest.mark.slow
def test_sharded_merge_matches_single(tmp_path):
    cfg = MTRConfig()
    single = io.StringIO()
    run_file(FASTA, cfg, single)

    prefix = str(tmp_path / "shard")
    for pid in range(2):
        run_file_sharded(FASTA, prefix, cfg, process_index=pid, process_count=2)
    merged = io.StringIO()
    merge_outputs(prefix, 2, merged)
    assert merged.getvalue() == single.getvalue()
