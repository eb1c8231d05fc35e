"""Device pipeline end-to-end on the CPU mesh (XLA counts engine):
must byte-match the golden reference output, and resume must be exact."""

import io
import os

import pytest

from mtr.config import MTRConfig
from mtr.pipeline import run_file

DATA = "/root/reference/test_multiple_TRs/data"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    with open(f"{GOLDEN}/{name}.out") as f:
        return f.read()


@pytest.mark.slow
def test_device_pipeline_parity_3_5():
    out = io.StringIO()
    run_file(f"{DATA}/3_5.fasta", MTRConfig(), out)
    assert out.getvalue() == _golden("3_5")


@pytest.mark.slow
def test_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck")
    full = io.StringIO()
    run_file(f"{DATA}/3_5.fasta", MTRConfig(), full)

    # simulate: first run processed everything; resume emits nothing new
    out1 = io.StringIO()
    run_file(f"{DATA}/3_5.fasta", MTRConfig(), out1, checkpoint=ck)
    assert out1.getvalue() == full.getvalue()
    out2 = io.StringIO()
    run_file(f"{DATA}/3_5.fasta", MTRConfig(), out2, checkpoint=ck)
    assert out2.getvalue() == ""
