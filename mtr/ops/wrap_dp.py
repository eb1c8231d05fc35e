"""Batched wrap-around DP with a move tensor, in plain JAX/XLA.

Replaces the reference's 800 MB row-major scalar fill
(wrap_around_DP.c:222-354) with a batched formulation:

  * rows are processed by lax.scan (the i->i+1 dependency is inherent);
  * the in-row deletion chain D[j] = max(m[j], D[j-1]-IP) — which resets
    at match cells and at j==1 — is a (max,+) affine recurrence solved
    with jax.lax.associative_scan in log2(U) steps;
  * queries are vmapped, so one (B, 512) vector op fills B x 512 DP
    cells;
  * the kernel emits 2-bit move codes (0 stop / 1 diag / 2 del / 3 ins)
    chosen with the traceback precedence match > mismatch > deletion >
    insertion evaluated on final neighbor values — including the wrap
    column D[i][0] = D[i][unit_len] that the fill itself never uses at
    j==1 but the traceback does (wrap_around_DP.c:302 vs :269-274).
    The O(path) traceback then runs on host from the move tensor,
    bit-identical to the scalar walk.

No pipeline engine uses it: the counts engines
(ops/wrap_dp_counts.py) carry the traceback counts through the fill and
store no move tensor.  It stays as an independent formulation the tests
check against the oracle.

Scores stay int32: max MG*rep_len = 5e6 << 2^31; the affine-map
composition uses a -2^30 "reset" sentinel instead of segment offsets so
no overflow is possible.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


NEG = jnp.int32(-(2**30))

MOVE_STOP = 0
MOVE_DIAG = 1
MOVE_DEL = 2
MOVE_INS = 3


def make_wrap_dp(u_pad: int, r_pad: int):
    """Build the jitted batched kernel for a (rep<=r_pad, unit<=u_pad)
    bucket.  Returns fn(rep, rep_len, unit, unit_len, scheme) over a
    leading batch dim:
      rep:      (B, r_pad) int32, padded with -1
      rep_len:  (B,) int32
      unit:     (B, u_pad) int32, padded with -2
      unit_len: (B,) int32
      scheme:   (B, 3) int32 rows (MG, MP, IP)
    Output: moves (B, r_pad+1, u_pad) uint8 (row 0 unused),
            max_val/max_i/max_j (B,) int32.
    """

    jidx = jnp.arange(u_pad, dtype=jnp.int32)

    def single(rep, rep_len, unit, unit_len, scheme):
        mg, mp, ip = scheme[0], scheme[1], scheme[2]
        wrap_sel = (jidx == unit_len - 1).astype(jnp.int32)

        def step(carry, inp):
            prev, best_val, best_i, best_j = carry
            rep_i, i = inp
            diag = prev[:u_pad]
            up = prev[1:]
            match = unit == rep_i
            m = jnp.where(
                match, diag + mg, jnp.maximum(0, jnp.maximum(diag - mp, up - ip))
            )
            a = m
            c = jnp.where(match | (jidx == 0), NEG, -ip)

            def combine(left, right):
                a_l, c_l = left
                a_r, c_r = right
                return (
                    jnp.maximum(a_r, a_l + c_r),
                    jnp.maximum(c_l + c_r, NEG),
                )

            a_s, _ = jax.lax.associative_scan(combine, (a, c))
            row = jnp.where(match, m, a_s)
            lane_ok = jidx < unit_len
            valid = i <= rep_len
            row = jnp.where(lane_ok & valid, row, 0)

            wrap_val = jnp.sum(row * wrap_sel)

            # moves with traceback precedence (match/mismatch fold to DIAG)
            left = jnp.concatenate([wrap_val[None], row[:-1]])
            mv = jnp.where(
                match,
                MOVE_DIAG,
                jnp.where(
                    row == diag - mp,
                    MOVE_DIAG,
                    jnp.where(
                        row == left - ip,
                        MOVE_DEL,
                        jnp.where(row == up - ip, MOVE_INS, MOVE_STOP),
                    ),
                ),
            )
            mv = jnp.where((row > 0) & lane_ok & valid, mv, MOVE_STOP).astype(jnp.uint8)

            # running argmax, row-major first-occurrence tie-breaking
            masked = jnp.where(lane_ok & valid, row, -1)
            row_max = jnp.max(masked)
            row_arg = jnp.argmax(masked).astype(jnp.int32)
            better = row_max > best_val
            best_val = jnp.where(better, row_max, best_val)
            best_i = jnp.where(better, i, best_i)
            best_j = jnp.where(better, row_arg + 1, best_j)

            new_prev = jnp.concatenate([wrap_val[None], row])
            return (new_prev, best_val, best_i, best_j), mv

        prev0 = jnp.zeros(u_pad + 1, dtype=jnp.int32)
        init = (prev0, jnp.int32(0), jnp.int32(0), jnp.int32(0))
        ivals = jnp.arange(1, r_pad + 1, dtype=jnp.int32)
        (final_prev, bv, bi, bj), moves = jax.lax.scan(step, init, (rep, ivals))
        moves = jnp.concatenate(
            [jnp.zeros((1, u_pad), dtype=jnp.uint8), moves], axis=0
        )
        return moves, bv, bi, bj

    batched = jax.vmap(single)
    return jax.jit(batched)


@functools.lru_cache(maxsize=64)
def get_wrap_dp(u_pad: int, r_pad: int):
    return make_wrap_dp(u_pad, r_pad)


def traceback_from_moves(moves, max_i, max_j, rep, unit, unit_len):
    """Host traceback over move codes; returns (counts, i_final) with
    counts = (matches, mismatches, insertions, deletions, scanned_unit).
    Bit-identical to wrap_around_DP.c:294-333."""
    i, j = int(max_i), int(max_j)
    if j == 0:
        j = unit_len
    n_m = n_x = n_i = n_d = 0
    mv_arr = np.asarray(moves)
    rep = np.asarray(rep)
    unit = np.asarray(unit)
    while i > 0:
        mv = mv_arr[i, j - 1]
        if mv == MOVE_STOP:
            break
        if mv == MOVE_DIAG:
            if rep[i - 1] == unit[j - 1]:
                n_m += 1
            else:
                n_x += 1
            i -= 1
            j -= 1
        elif mv == MOVE_DEL:
            n_d += 1
            j -= 1
        else:  # MOVE_INS
            n_i += 1
            i -= 1
        if j == 0:
            j = unit_len
    scanned = n_m + n_x + n_d
    return (n_m, n_x, n_i, n_d, scanned), i


def consensus_from_moves(moves, max_i, max_j, rep, unit, unit_len, max_period=500):
    """Traceback accumulating per-column consensus/missing counts
    (consensus.c:931-962) for revise_representative_unit_sub."""
    i, j = int(max_i), int(max_j)
    if j == 0:
        j = unit_len
    consensus = np.zeros((max_period, 5), dtype=np.int64)
    missing = np.zeros((max_period, 4), dtype=np.int64)
    mv_arr = np.asarray(moves)
    rep = np.asarray(rep)
    while i > 0:
        mv = mv_arr[i, j - 1]
        if mv == MOVE_STOP:
            break
        if mv == MOVE_DIAG:
            consensus[j][rep[i - 1]] += 1
            i -= 1
            j -= 1
        elif mv == MOVE_DEL:
            consensus[j][4] += 1
            j -= 1
        else:
            missing[j][rep[i - 1]] += 1
            i -= 1
        if j == 0:
            j = unit_len
    return consensus, missing
