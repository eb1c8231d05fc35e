"""Seeded wrap-DP job sets and the oracle's counts for them.

Shared by the counts-engine tests and chip_smoke.py: a job is
(rep codes, unit codes, (mg, mp, ip)), and a run packs jobs into the
engines' resident layout (one flat int8 read array + per-job starts).
"""

from __future__ import annotations

import numpy as np

from mtr.oracle.wrap_dp import traceback, wrap_dp_fill

SCHEMES = ((1, 1, 3), (1, 3, 1), (5, 1, 1))


def oracle_counts(rep, unit, mg, mp, ip):
    """(m, x, ins, del, scanned, i_final, max_val, max_i, max_j) of the
    oracle fill + traceback (wrap_around_DP.c:222-354)."""
    D, max_wrd, max_i, max_j = wrap_dp_fill(rep, unit, mg, mp, ip)
    path, i_final = traceback(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip)
    n = {"M": 0, "X": 0, "I": 0, "D": 0}
    for mv, _, _ in path:
        n[mv] += 1
    scanned = n["M"] + n["X"] + n["D"]
    return (n["M"], n["X"], n["I"], n["D"], scanned, i_final,
            max_wrd, max_i, max_j)


def rand_jobs(rng, n, max_rep, max_unit, scheme=None, periodic=True,
              min_unit=2):
    """n random jobs: rep_len in [1, max_rep], unit_len in
    [min_unit, max_unit]; 70% planted repeats with 1/8 errors when
    periodic, else random reads."""
    jobs = []
    for _ in range(n):
        rep_len = int(rng.integers(1, max_rep + 1))
        unit_len = int(rng.integers(min_unit, max_unit + 1))
        unit = rng.integers(0, 4, unit_len).astype(np.int32)
        if periodic and rng.random() < 0.7:
            rep = np.tile(unit, rep_len // unit_len + 1)[:rep_len].copy()
            n_err = max(1, rep_len // 8)
            idx = rng.integers(0, rep_len, n_err)
            rep[idx] = rng.integers(0, 4, n_err)
        else:
            rep = rng.integers(0, 4, rep_len).astype(np.int32)
        sch = scheme or SCHEMES[int(rng.integers(0, len(SCHEMES)))]
        jobs.append((rep.astype(np.int32), unit, sch))
    return jobs


def pack_jobs(jobs, b: int, u_pad: int, slack: int):
    """Resident layout of a job list padded to b rows: (flat int8,
    starts, scal, units).  Padding rows match the pipeline's (rep_len
    0, a 2-base unit of zeros, scheme (1, 1, 1)); slack >= the engine's
    r_pad keeps every segment gather in bounds."""
    total = sum(len(rep) for rep, _, _ in jobs)
    flat = np.zeros(total + slack, np.int8)
    starts = np.zeros(b, np.int32)
    scal = np.zeros((b, 8), np.int32)
    scal[:, 1] = 2
    scal[:, 2:5] = 1
    units = np.full((b, u_pad), -2, np.int8)
    units[:, :2] = 0
    p = 0
    for q, (rep, unit, scheme) in enumerate(jobs):
        flat[p : p + len(rep)] = rep
        starts[q] = p
        p += len(rep)
        units[q, : len(unit)] = unit
        scal[q, 0] = len(rep)
        scal[q, 1] = len(unit)
        scal[q, 2:5] = scheme
    return flat, starts, scal, units


def engine_rows(engine: str, jobs, u_pad: int, r_pad: int, b: int | None = None):
    """Run jobs through the pipeline's counts dispatcher; (b, 15) rows."""
    from mtr.ops.wrap_dp_counts import counts_fn

    if b is None:
        b = max(8, 1 << (len(jobs) - 1).bit_length())
    args = pack_jobs(jobs, b, u_pad, max(r_pad, 128))
    return np.asarray(counts_fn(engine, b, u_pad, r_pad)(*args))


def mismatches(rows, jobs):
    """Jobs whose engine row differs from the oracle, as readable strings
    (empty when every count, position and argmax agrees exactly)."""
    bad = []
    for q, (rep, unit, scheme) in enumerate(jobs):
        want = oracle_counts(rep, unit, *scheme)
        r = rows[q]
        got = (r[0], r[1], r[2], r[3], r[4], r[5], r[8], r[9], r[10])
        if tuple(int(v) for v in got) != tuple(int(v) for v in want) or r[6] != 1:
            bad.append(f"job {q} unit {len(unit)} rep {len(rep)} "
                       f"scheme {scheme}: {tuple(map(int, got))} != {want}")
    return bad
