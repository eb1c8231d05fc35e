"""Wave-based suppression pruning: opt-in scheduling
that skips walks/DP for ranges the acceptance replay will suppress
(handle_one_read.c:178-188).  Output must be byte-identical to full
speculation, and the pruning must actually engage (counters).
"""

import io
import os

import pytest

from mtr.config import MTRConfig
from mtr.pipeline import run_file
from mtr.utils.timers import TIMERS

FIXTURE = "/root/reference/test_multiple_TRs/data/2_5_10_20_set.fasta"


@pytest.fixture
def waves_env():
    os.environ["MTR_WAVES"] = "1"
    yield
    os.environ.pop("MTR_WAVES", None)


def test_wave_pruning_byte_identical(waves_env):
    if not os.path.exists(FIXTURE):
        pytest.skip("reference fixture unavailable")
    cfg = MTRConfig(backend="host")
    os.environ.pop("MTR_WAVES", None)
    full = io.StringIO()
    run_file(FIXTURE, cfg, full)
    os.environ["MTR_WAVES"] = "1"
    TIMERS.counters.clear()
    waved = io.StringIO()
    run_file(FIXTURE, cfg, waved)
    assert waved.getvalue() == full.getvalue()
    c = TIMERS.counters
    # pruning engaged: some ranges were never computed, and the live
    # query count matches the reference's replay exactly either way
    assert c["computed_ranges"] < c["ranges_total"]
    assert c["computed_ranges"] + c["pruned_ranges"] >= c["queries"]


def test_wave_counters_account_for_all_ranges(waves_env):
    if not os.path.exists(FIXTURE):
        pytest.skip("reference fixture unavailable")
    TIMERS.counters.clear()
    run_file(FIXTURE, MTRConfig(backend="host"), io.StringIO())
    c = TIMERS.counters
    # every collection-time range is either computed or pruned-dead
    assert c["computed_ranges"] + c["pruned_ranges"] == c["ranges_total"]


def test_waves_policy():
    from mtr.pipeline import waves_policy

    # walk-bound regime (many-core host feeding one chip): waves on
    assert waves_policy(3.0, 0.1)
    # device-wait-bound regime (this 2-core box): waves off
    assert not waves_policy(0.5, 2.0)
    # no measurements yet: off
    assert not waves_policy(None, None)
    assert not waves_policy(1.0, None)


def test_waves_self_enable_when_walk_bound(monkeypatch, tmp_path):
    """Adaptive policy: a batcher reporting zero
    device-idle wait (walk-bound regime) must flip wave pruning on by
    itself — counters show pruning engaged, output stays identical."""
    from mtr.pipeline import HostDPBatcher
    from mtr.testutil.rand_seq import write_fasta

    fasta = str(tmp_path / "multi.fasta")
    write_fasta(fasta, str(tmp_path / "u.txt"),
                100, 10, 1.6, 9.0, 3.8, 1000, 1000, 6, seed=606)
    cfg = MTRConfig(backend="host", reads_per_batch=2)
    base = io.StringIO()
    run_file(fasta, cfg, base)

    # walk-bound signal: device never makes the host wait
    monkeypatch.setattr(HostDPBatcher, "pop_dev_idle",
                        lambda self: 0.0, raising=False)
    # make the measured walk time register as > the policy's floor
    import mtr.pipeline as P
    monkeypatch.setattr(
        P, "waves_policy",
        lambda walk_s, idle: walk_s is not None and idle == 0.0)
    TIMERS.counters.clear()
    waved = io.StringIO()
    run_file(fasta, cfg, waved)
    assert waved.getvalue() == base.getvalue()
    assert TIMERS.counters.get("pruned_ranges", 0) > 0, (
        "adaptive waves never engaged")
