"""Device wrap-DP kernel vs the oracle: move-driven traceback must give
bit-identical counts/coordinates for random batched queries."""

import numpy as np
import pytest

from mtr.oracle.wrap_dp import wrap_dp_fill, traceback
from mtr.ops.wrap_dp import (
    get_wrap_dp,
    traceback_from_moves,
)


def oracle_counts(rep, unit, mg, mp, ip):
    D, w, i, j = wrap_dp_fill(rep, unit, mg, mp, ip)
    path, i_final = traceback(D, w, i, j, rep, unit, mg, mp, ip)
    n_m = sum(1 for mv, _, _ in path if mv == "M")
    n_x = sum(1 for mv, _, _ in path if mv == "X")
    n_i = sum(1 for mv, _, _ in path if mv == "I")
    n_d = sum(1 for mv, _, _ in path if mv == "D")
    return (n_m, n_x, n_i, n_d, n_m + n_x + n_d), i_final, (w, i, j)


@pytest.mark.parametrize("scheme", [(1, 1, 3), (1, 3, 1), (5, 1, 1)])
def test_batch_matches_oracle(scheme):
    rng = np.random.default_rng(0)
    U_PAD, R_PAD = 32, 128
    B = 8
    fn = get_wrap_dp(U_PAD, R_PAD)

    reps, rep_lens, units, unit_lens = [], [], [], []
    for b in range(B):
        ul = int(rng.integers(2, U_PAD))
        rl = int(rng.integers(5, R_PAD))
        unit = rng.integers(0, 4, ul)
        if b % 2 == 0:
            # planted repeat with noise
            rep = np.tile(unit, rl // ul + 1)[:rl].copy()
            nse = rng.integers(0, rl, max(1, rl // 10))
            rep[nse] = rng.integers(0, 4, len(nse))
        else:
            rep = rng.integers(0, 4, rl)
        reps.append(np.pad(rep, (0, R_PAD - rl), constant_values=-1))
        rep_lens.append(rl)
        units.append(np.pad(unit, (0, U_PAD - ul), constant_values=-2))
        unit_lens.append(ul)

    mg, mp, ip = scheme
    schemes = np.tile(np.array(scheme, np.int32), (B, 1))
    moves, bv, bi, bj = fn(
        np.array(reps, np.int32),
        np.array(rep_lens, np.int32),
        np.array(units, np.int32),
        np.array(unit_lens, np.int32),
        schemes,
    )
    moves, bv, bi, bj = map(np.asarray, (moves, bv, bi, bj))

    for b in range(B):
        rl, ul = rep_lens[b], unit_lens[b]
        rep = reps[b][:rl]
        unit = units[b][:ul]
        counts0, ifin0, (w0, i0, j0) = oracle_counts(rep, unit, mg, mp, ip)
        assert (w0, i0, j0) == (bv[b], bi[b], bj[b]), f"argmax mismatch b={b}"
        counts1, ifin1 = traceback_from_moves(moves[b], bi[b], bj[b], rep, unit, ul)
        assert counts0 == counts1, f"counts mismatch b={b}"
        assert ifin0 == ifin1


def test_mixed_schemes_in_batch():
    rng = np.random.default_rng(3)
    U_PAD, R_PAD = 16, 64
    fn = get_wrap_dp(U_PAD, R_PAD)
    unit = rng.integers(0, 4, 5)
    rep = np.tile(unit, 10)
    reps = np.tile(np.pad(rep, (0, R_PAD - len(rep)), constant_values=-1), (2, 1))
    units = np.tile(np.pad(unit, (0, U_PAD - 5), constant_values=-2), (2, 1))
    schemes = np.array([[1, 1, 3], [5, 1, 1]], np.int32)
    moves, bv, bi, bj = fn(
        reps.astype(np.int32),
        np.array([50, 50], np.int32),
        units.astype(np.int32),
        np.array([5, 5], np.int32),
        schemes,
    )
    assert int(bv[0]) == 50 and int(bv[1]) == 250
