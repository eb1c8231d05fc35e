"""REAL two-process jax.distributed run.

Two OS processes initialize jax.distributed against a local coordinator,
each runs run_file_sharded on its round-robin read shard, and each
all-gathers the per-process record counts over the collective backend.
The parent merges the part files and byte-compares against the
single-process run.
"""

import io
import os
import socket
import subprocess
import sys

import pytest

FASTA = "/root/reference/test_multiple_TRs/data/2_5_10_20_set.fasta"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_jax_distributed(tmp_path):
    if not os.path.exists(FASTA):
        pytest.skip("reference fixtures unavailable")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prefix = str(tmp_path / "dist")
    worker = os.path.join(REPO, "tests", "_dist_worker.py")
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("XLA_FLAGS", None)  # one device per process
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), prefix, FASTA],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]

    from mtr.config import MTRConfig
    from mtr.parallel.distributed import merge_outputs
    from mtr.pipeline import run_file

    merged = io.StringIO()
    merge_outputs(prefix, 2, merged)
    single = io.StringIO()
    run_file(FASTA, MTRConfig(backend="host"), single)
    assert merged.getvalue() == single.getvalue()

    import numpy as np

    g0 = np.load(prefix + ".gather0.npy")
    g1 = np.load(prefix + ".gather1.npy")
    assert (g0 == g1).all(), "all-gather disagreed across processes"
    assert int(g0.sum()) == len(merged.getvalue().splitlines())
