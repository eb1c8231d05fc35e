"""Scaling floors: the embarrassingly-parallel
read axis must actually scale.  Floors are deliberately loose — this
2-core container time-shares everything — the published numbers live in
SCALING.md (scripts/scaling_bench.py)."""

import json
import subprocess
import sys
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
@pytest.mark.bench  # measurement harness, >300 s: the verification
# tier is `-m "slow and not bench"` (completes < 5 min on a 2-core box)
def test_two_process_scaling_floor():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "scaling_bench.py"),
         "--json"],
        capture_output=True, timeout=1500, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    res = json.loads(r.stdout.decode().splitlines()[-1])
    eff = res["procs"]["efficiency"]
    # measured ~1.0 pinned-core on a quiet box; floor absorbs CI noise
    assert eff >= 0.5, f"2-process efficiency {eff}"
    weak2 = res["vdev_weak"]["2"]["efficiency"]
    assert weak2 >= 0.3, f"2-device weak efficiency {weak2}"
