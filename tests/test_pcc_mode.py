"""Pearson-correlation DI mode (-p) parity vs reference goldens."""

import io
import os

import pytest

from mtr.config import MTRConfig
from mtr.oracle.pipeline import run_file_oracle

DATA = "/root/reference/test_multiple_TRs/data"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name", ["3_5", "3_10", "5_10"])
def test_pcc_parity(name):
    cfg = MTRConfig(manhattan_distance=False)
    out = io.StringIO()
    for _read, records in run_file_oracle(f"{DATA}/{name}.fasta", cfg):
        for rec in records:
            out.write(rec.format_record() + "\n")
    with open(f"{GOLDEN}/{name}_pcc.out") as f:
        assert out.getvalue() == f.read()
