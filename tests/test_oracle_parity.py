"""End-to-end oracle parity: stdout must byte-match the reference binary.

Golden files were produced by the reference rebuilt unmodified from
/root/reference (tests/golden/*.out).  Small fixtures run in CI; larger
ones are marked slow.
"""

import io
import os

import pytest

from mtr.config import MTRConfig
from mtr.oracle.pipeline import run_file_oracle

DATA = "/root/reference/test_multiple_TRs/data"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

FAST = ["3_5", "3_10", "5_10"]
SLOW = ["3_20", "5_20", "10_20", "2_5_10_20_set", "3_50", "5_50", "10_50", "20_50"]


def run_oracle(name: str) -> str:
    out = io.StringIO()
    cfg = MTRConfig()
    for _read, records in run_file_oracle(f"{DATA}/{name}.fasta", cfg):
        for rec in records:
            out.write(rec.format_record() + "\n")
    return out.getvalue()


def golden(name: str) -> str:
    with open(f"{GOLDEN}/{name}.out") as f:
        return f.read()


@pytest.mark.parametrize("name", FAST)
def test_parity_fast(name):
    assert run_oracle(name) == golden(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_parity_slow(name):
    assert run_oracle(name) == golden(name)
