"""Counts-mode wrap-around DP in plain XLA (jnp / lax only).

Fill + traceback counts of wrap_around_DP.c:222-354 in one pass, one
small (B, 15) result per chunk, expressed in jnp ops under a
lax.fori_loop, so it runs on any XLA backend.  It is the counts engine
on the CPU and the plain version the CUDA kernel
(native/wrap_dp_counts.cu) is compared with on the GPU; units up to
512.

Jobs ride the batch dim and the unit the minor dim: a flag-carrying
segmented Kogge-Stone max-scan resolves the in-row deletion chain, an
origin-index scan + gathers copy the aux (m/ins/si) values along
deletions, and a per-(job, column) argmax with row-major-first
resolution picks the traceback start.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

NEG = -(1 << 30)


def _take(plane, idx):
    return jnp.take_along_axis(plane, idx, axis=1)


def make_wrap_dp_counts_xla(b: int, u_pad: int, r_pad: int):
    """fn(scal (B,8) i32, rep (B,r_pad) int8, unit (B,u_pad) int8)
    -> (B, 15) int32 rows [m, x, ins, del, scanned, i_final, done, 0,
    max_val, max_i, max_j, m, ins, i_final, 0].

    The row loop runs to the chunk's longest rep_len (a data-dependent
    trip count); rows past a job's own rep_len are masked."""
    n_lev = int(np.ceil(np.log2(u_pad)))
    assert 1 << n_lev == u_pad

    def fn(scal, rep, unit):
        rep_len = scal[:, 0:1]
        unit_len = scal[:, 1:2]
        mg = scal[:, 2:3]
        mp = scal[:, 3:4]
        ip = scal[:, 4:5]

        jidx = jax.lax.broadcasted_iota(jnp.int32, (b, u_pad), 1)
        zero = jnp.zeros((b, u_pad), jnp.int32)
        ulm1 = jnp.maximum(unit_len - 1, 0) + zero
        ipj = ip * jidx
        sub_ok = jidx < unit_len
        j0 = jidx == 0
        edges = [jidx < (1 << s) for s in range(n_lev)]
        unit32 = unit.astype(jnp.int32)
        rep32 = rep.astype(jnp.int32)
        max_rep_len = jnp.max(rep_len)

        def row_step(r, st):
            prev, auxm, auxi, auxs, bv, bi, bm, bins, bsi = st
            i = r + 1
            rep_c = jax.lax.dynamic_slice(rep32, (0, r), (b, 1))
            mi = unit32 == rep_c
            wrapv = _take(prev, ulm1)
            diag = jnp.where(j0, wrapv, jnp.roll(prev, 1, axis=1))
            m_nm = jnp.maximum(zero, jnp.maximum(diag - mp, prev - ip))
            m = jnp.where(mi, diag + mg, m_nm)

            t = m + ipj
            fi = jnp.logical_or(mi, j0).astype(jnp.int32)
            for s in range(n_lev):
                sh = 1 << s
                t_r = jnp.where(edges[s], NEG, jnp.roll(t, sh, axis=1))
                f_r = jnp.where(edges[s], 1, jnp.roll(fi, sh, axis=1))
                t = jnp.where(fi > 0, t, jnp.maximum(t, t_r))
                fi = fi | f_r
            chain = t - ipj
            row = jnp.where(mi, m, chain)
            ok = jnp.logical_and(sub_ok, i <= rep_len)
            row = jnp.where(ok, row, zero)

            pos = jnp.logical_and(row > 0, ok)
            is_m = jnp.logical_and(mi, pos)
            e2v = row == diag - mp
            not_mi = jnp.logical_not(mi)
            sel_x = jnp.logical_and(jnp.logical_and(not_mi, e2v), pos)
            rem = jnp.logical_and(
                jnp.logical_and(pos, not_mi), jnp.logical_not(e2v)
            )
            left = jnp.where(j0, _take(row, ulm1), jnp.roll(row, 1, axis=1))
            e3v = row == left - ip
            sel_d = jnp.logical_and(rem, e3v)
            sel_diag = jnp.logical_or(is_m, sel_x)

            wa_m = _take(auxm, ulm1)
            wa_i = _take(auxi, ulm1)
            wa_s = _take(auxs, ulm1)
            daux_m = jnp.where(j0, wa_m, jnp.roll(auxm, 1, axis=1))
            daux_i = jnp.where(j0, wa_i, jnp.roll(auxi, 1, axis=1))
            daux_s = jnp.where(j0, wa_s, jnp.roll(auxs, 1, axis=1))
            mi_i = mi.astype(jnp.int32)
            base_m = jnp.where(
                sel_diag, daux_m + mi_i, jnp.where(pos, auxm, zero)
            )
            base_i = jnp.where(
                sel_diag, daux_i, jnp.where(pos, auxi + 1, zero)
            )
            base_s = jnp.where(
                sel_diag, daux_s, jnp.where(pos, auxs, zero + i)
            )

            org = jnp.where(sel_d, -1, jidx)
            for s in range(n_lev):
                sh = 1 << s
                org = jnp.maximum(
                    org, jnp.where(edges[s], -1, jnp.roll(org, sh, axis=1))
                )
            open_ = org < 0
            orgc = jnp.maximum(org, 0)
            pay_m = _take(base_m, orgc)
            pay_i = _take(base_i, orgc)
            pay_s = _take(base_s, orgc)
            org_last = _take(orgc, ulm1)
            fin_m = jnp.where(open_, _take(base_m, org_last), pay_m)
            fin_i = jnp.where(open_, _take(base_i, org_last), pay_i)
            fin_s = jnp.where(open_, _take(base_s, org_last), pay_s)

            better = row > bv
            bv = jnp.where(better, row, bv)
            bi = jnp.where(better, zero + i, bi)
            bm = jnp.where(better, fin_m, bm)
            bins = jnp.where(better, fin_i, bins)
            bsi = jnp.where(better, fin_s, bsi)
            return (row, fin_m, fin_i, fin_s, bv, bi, bm, bins, bsi)

        st0 = (zero,) * 9
        _, _, _, _, bv, bi, bm, bins, bsi = jax.lax.fori_loop(
            0, max_rep_len, row_step, st0
        )

        # row-major-first global argmax resolution (wrap_around_DP.c:
        # 276-281): max value, then smallest row, then smallest lane
        gmax = jnp.max(bv, axis=1, keepdims=True)
        cand = bv == gmax
        big = jnp.int32(1 << 30)
        bi_m = jnp.where(cand, bi, big)
        min_bi = jnp.min(bi_m, axis=1, keepdims=True)
        cand2 = jnp.logical_and(cand, bi == min_bi)
        j_m = jnp.where(cand2, jidx, big)
        jstar = jnp.min(j_m, axis=1, keepdims=True)
        found = gmax > 0
        jstar_p = jstar + zero
        arg_m = _take(bm, jstar_p)[:, 0:1]
        arg_i = _take(bins, jstar_p)[:, 0:1]
        arg_s = _take(bsi, jstar_p)[:, 0:1]
        max_i = jnp.where(found, min_bi, 0)
        max_j = jnp.where(found, jstar + 1, 0)
        zcol = jnp.zeros((b, 1), jnp.int32)
        out = jnp.concatenate(
            [zcol, gmax, max_i, max_j,
             jnp.where(found, arg_m, 0),
             jnp.where(found, arg_i, 0),
             jnp.where(found, arg_s, 0),
             zcol],
            axis=1,
        )

        bvv, bii = out[:, 1], out[:, 2]
        mm, ins, si = out[:, 4], out[:, 5], out[:, 6]
        mgv, mpv, ipv = scal[:, 2], scal[:, 3], scal[:, 4]
        x = bii - si - mm - ins
        dl = (mm * mgv - x * mpv - bvv - ins * ipv) // ipv
        scanned = mm + x + dl
        done = jnp.ones_like(mm)
        tb = jnp.stack([mm, x, ins, dl, scanned, si, done], axis=1)
        return jnp.concatenate([tb, out], axis=1)

    return jax.jit(fn)
