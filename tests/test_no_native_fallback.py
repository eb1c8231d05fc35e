"""Degrade path for checkouts whose native build is unavailable
(VERDICT r3 #5): the host DP leg must fall back to the pure-Python
oracle engine with byte-identical results, and `auto`/`hybrid` must
still complete a file instead of raising.

Reference behavior being preserved: the CLI "just works" (main.c:48).
"""

import io
import os

import numpy as np
import pytest

from mtr import native
from mtr.config import MTRConfig
from mtr.pipeline import DPJob, HostDPBatcher, make_batcher
from mtr.utils.encoding import encode_bases


FIXTURE = "/root/reference/test_multiple_TRs/data/2_5_10_20_set.fasta"


def _mk_jobs(rng, n=6, mode="counts"):
    jobs = []
    for _ in range(n):
        L = int(rng.integers(200, 600))
        org = rng.integers(0, 4, L + 2).astype(np.int64)
        unit = encode_bases("ACGTG"[: int(rng.integers(2, 6))])
        qs = int(rng.integers(0, 20))
        qe = qs + int(rng.integers(50, L - 30 - qs))
        scheme = (1, 1, 3) if rng.integers(2) else (1, 3, 1)
        if mode == "consensus":
            scheme = (5, 1, 1)
        jobs.append(DPJob(org, qs, qe, unit, scheme, mode=mode))
    return jobs


@pytest.mark.skipif(not native.available(), reason="native lib required")
def test_oracle_fallback_counts_match_native():
    rng = np.random.default_rng(7)
    jobs_n = _mk_jobs(rng)
    jobs_o = [DPJob(j.org, j.qs, j.qe, j.unit, j.scheme) for j in jobs_n]
    b = HostDPBatcher()
    b._run(jobs_n)
    b._run_oracle(jobs_o)
    for jn, jo in zip(jobs_n, jobs_o):
        assert jn.result == jo.result


@pytest.mark.skipif(not native.available(), reason="native lib required")
def test_oracle_fallback_consensus_match_native():
    rng = np.random.default_rng(11)
    jobs_n = _mk_jobs(rng, mode="consensus")
    jobs_o = [
        DPJob(j.org, j.qs, j.qe, j.unit, j.scheme, mode="consensus")
        for j in jobs_n
    ]
    b = HostDPBatcher()
    b._run(jobs_n)
    b._run_oracle(jobs_o)
    for jn, jo in zip(jobs_n, jobs_o):
        ul = len(jn.unit)
        # consumers slice [1 : unit_len + 1] (rebuild_units_batch)
        assert np.array_equal(
            np.asarray(jn.result[0])[1 : ul + 1, :5],
            np.asarray(jo.result[0])[1 : ul + 1, :5],
        )
        assert np.array_equal(
            np.asarray(jn.result[1])[1 : ul + 1, :4],
            np.asarray(jo.result[1])[1 : ul + 1, :4],
        )


def test_run_file_without_native(monkeypatch):
    """End-to-end on a real fixture with the native library masked off:
    `auto` must pick a working engine and produce the same output."""
    if not os.path.exists(FIXTURE):
        pytest.skip("reference fixture unavailable")
    from mtr.pipeline import run_file

    cfg = MTRConfig(backend="auto")
    ref = io.StringIO()
    run_file(FIXTURE, cfg, ref)

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "wrap_dp_batch", lambda *a, **k: None)
    got = io.StringIO()
    run_file(FIXTURE, cfg, got)
    assert got.getvalue() == ref.getvalue()
    assert got.getvalue()  # non-empty: records were emitted


def test_auto_engine_without_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    eng = make_batcher(MTRConfig(backend="auto"))
    import jax

    if jax.default_backend() == "cpu":
        from mtr.pipeline import WrapDPBatcher

        assert isinstance(eng, WrapDPBatcher)
    else:
        from mtr.pipeline import HybridDPBatcher

        assert isinstance(eng, HybridDPBatcher)
        assert eng.cell_threshold == 0
