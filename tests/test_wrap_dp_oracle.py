"""Wrap-around DP oracle vs a literal (slow) port of the C fill+traceback."""

import numpy as np
import pytest

from mtr.oracle.wrap_dp import wrap_dp_fill, traceback, wrap_around_dp_sub
from mtr.records import RepeatRecord
from mtr.utils.encoding import decode_bases


def literal_fill(rep, unit, mg, mp, ip):
    """Direct transcription of wrap_around_DP.c:250-285 semantics."""
    rep_len, unit_len = len(rep), len(unit)
    D = np.zeros((rep_len + 1, unit_len + 1), dtype=np.int64)
    max_wrd = max_i = max_j = 0
    for i in range(1, rep_len + 1):
        for j in range(1, unit_len + 1):
            if rep[i - 1] == unit[j - 1]:
                D[i, j] = D[i - 1, j - 1] + mg
            else:
                vals = [0, D[i - 1, j - 1] - mp, D[i - 1, j] - ip]
                if j > 1:
                    vals.append(D[i, j - 1] - ip)
                D[i, j] = max(vals)
            if max_wrd < D[i, j]:
                max_wrd, max_i, max_j = int(D[i, j]), i, j
        D[i, 0] = D[i, unit_len]
    return D, max_wrd, max_i, max_j


@pytest.mark.parametrize("scheme", [(1, 1, 3), (1, 3, 1), (5, 1, 1)])
@pytest.mark.parametrize("seed", range(6))
def test_fill_matches_literal(scheme, seed):
    rng = np.random.default_rng(seed)
    rep_len = int(rng.integers(5, 200))
    unit_len = int(rng.integers(2, 30))
    rep = rng.integers(0, 4, rep_len).astype(np.int64)
    unit = rng.integers(0, 4, unit_len).astype(np.int64)
    mg, mp, ip = scheme
    D0, w0, i0, j0 = literal_fill(rep, unit, mg, mp, ip)
    D1, w1, i1, j1 = wrap_dp_fill(rep, unit, mg, mp, ip)
    assert np.array_equal(D0, D1)
    assert (w0, i0, j0) == (w1, i1, j1)


def test_traceback_counts_planted_repeat():
    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, 7)
    rep = np.concatenate([np.tile(unit, 10)])
    D, w, i, j = wrap_dp_fill(rep, unit, 1, 1, 3)
    path, i_final = traceback(D, w, i, j, rep, unit, 1, 1, 3)
    n_m = sum(1 for mv, _, _ in path if mv == "M")
    assert n_m == 70 and i_final == 0


def test_wrap_around_dp_sub_record_fields():
    rng = np.random.default_rng(1)
    unit = rng.integers(0, 4, 5)
    org = np.concatenate([[0], np.tile(unit, 12), rng.integers(0, 4, 10)])
    rr = RepeatRecord(string=decode_bases(unit), rep_period=5)
    wrap_around_dp_sub(org, 0, len(org) - 2, rr, 1, 1, 3)
    assert rr.num_matches == 60
    assert rr.num_mismatches == rr.num_insertions == rr.num_deletions == 0
    assert rr.num_freq_unit == 12
    assert rr.repeat_len == 60
