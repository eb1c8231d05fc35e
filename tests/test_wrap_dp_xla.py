"""XLA counts engine (ops/wrap_dp_xla.py): bit-identical to the host
oracle across schemes/shapes up to unit 512, and the engine behind an
end-to-end `--backend device` run on the CPU."""

import os

import numpy as np
import pytest

from mtr.oracle.wrap_dp import wrap_around_dp_sub
from mtr.records import RepeatRecord
from mtr.ops.wrap_dp_xla import make_wrap_dp_counts_xla


@pytest.mark.parametrize("u_pad,unit_lens", [(128, (2, 7, 100)),
                                             (512, (150, 257, 500))])
def test_xla_counts_match_oracle(u_pad, unit_lens):
    rng = np.random.default_rng(3)
    b, r_pad = 8, 512 if u_pad == 128 else 2048
    fn = make_wrap_dp_counts_xla(b, u_pad, r_pad)
    scal = np.zeros((b, 8), np.int32)
    reps = np.full((b, r_pad), -1, np.int8)
    units = np.full((b, u_pad), -2, np.int8)
    jobs = []
    for q in range(b):
        ul = unit_lens[q % len(unit_lens)]
        unit = rng.integers(0, 4, ul)
        rep_len = int(rng.integers(min(ul * 2, r_pad - 1), r_pad))
        rep = np.tile(unit, rep_len // ul + 1)[:rep_len].copy()
        err = rng.random(rep_len) < 0.15
        rep[err] = rng.integers(0, 4, err.sum())
        scheme = (1, 1, 3) if q % 2 else (1, 3, 1)
        scal[q, 0], scal[q, 1] = rep_len, ul
        scal[q, 2:5] = scheme
        reps[q, :rep_len] = rep
        units[q, :ul] = unit
        jobs.append((rep, unit, scheme))
    out = np.asarray(fn(scal, reps, units))
    from mtr.utils.encoding import decode_bases

    for q, (rep, unit, scheme) in enumerate(jobs):
        org = np.concatenate([[0], rep]).astype(np.int64)
        rr = RepeatRecord()
        rr.string = decode_bases(unit.tolist())
        rr.rep_period = len(unit)
        rr.string_score = [0] * len(unit)
        wrap_around_dp_sub(org, 0, len(rep) - 1, rr, *scheme)
        got = tuple(int(v) for v in out[q, :4])
        want = (rr.num_matches, rr.num_mismatches,
                rr.num_insertions, rr.num_deletions)
        assert got == want, (q, got, want)
        assert int(out[q, 5]) + 1 == rr.rep_start, (q,)


def test_pipeline_device_backend_golden(capsys):
    """`--backend device` on the CPU: every counts DP on the XLA engine,
    walks on the device DBG engine; byte-identical to the reference
    binary's output."""
    from mtr import cli

    golden = os.path.join(os.path.dirname(__file__), "golden")
    assert cli.main(["--backend", "device",
                     os.path.join(golden, "multi20_100x10.fasta")]) == 0
    assert capsys.readouterr().out == open(
        os.path.join(golden, "multi20_100x10.out")).read()
