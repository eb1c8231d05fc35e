"""On-device De Bruijn unit inference: batched k-mer counting, max-node
listing and the greedy lookahead walk (consensus.c:37-582) as two jitted
stages, with a per-query host fallback that preserves bit-exactness.

Stage A (tables): for a chunk of (read, range, k) queries, build the
k-mer multiset the reference counts — rolling codes over
[qs, min(qe, L-k+1)) plus RAW base values on the tail up to qe
(consensus.c:42-57 quirk) — as one masked Horner gather, then sort each
row (stable) and derive per-element run counts with cummax/cummin.
The max-node list (first-occurrence order, capped at 100, counts
decremented in the live table — consensus.c:156-164,199-222) comes from
the stable permutation: the first element of each run carries the
smallest original index, so scattering run-leaders back to original
positions and ranking by cumsum reproduces the reference's scan order.

Stage B (walks): one speculative job per (query, direction, start
node) — the reference walks nodes sequentially and stops at the first
loop (consensus.c:534-573), so walking all of them in parallel and
selecting the first found index is equivalent.  The walk is a
lax.while_loop over steps; the tie-break lookahead
(consensus.c:299-335, 384-423) is an inner while_loop with fixed-size
masked tie lists.  The device tie cap is T_DEV (32) versus the
reference's 1024: a tie list that would exceed T_DEV sets an overflow
flag and the affected query falls back to the host oracle (which
implements the full 1024 cap), so output parity is unconditional.

The forward walk's post-loop lookahead quirk (next base uses the value
of m AFTER the loop — always base 0 on natural exit, consensus.c:335)
falls out of the same arithmetic here.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

MAX_PERIOD = 500
MIN_NUM_FREQ_UNIT = 5
MAX_NUM_MAXNODES = 100
T_DEV = 32          # device tie-list cap (host fallback beyond)
V_MAX = 32768       # widest range handled on device
V_BUCKETS = (1024, 4096, 32768)
INT_MAX = np.int32(2**31 - 1)

_POW4 = [4**i for i in range(16)]


# ---------------------------------------------------------------------------
# stage A: tables + max-node lists
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0,))
def _stage_a(v_pad: int, orgs, ridx, qs, km_end, v_len, k):
    qb = ridx.shape[0]
    j = jnp.arange(v_pad, dtype=jnp.int32)[None, :]
    pos = qs[:, None] + j
    valid = j < v_len[:, None]
    in_code = pos < km_end[:, None]
    l_pad = orgs.shape[1]
    posc = jnp.clip(pos, 0, l_pad - 1)
    # rolling k-mer code via masked Horner over t < k (k <= 15)
    code = jnp.zeros((qb, v_pad), jnp.int32)
    raw = orgs[ridx[:, None], posc].astype(jnp.int32)
    for t in range(15):
        g = orgs[ridx[:, None], jnp.clip(pos + t, 0, l_pad - 1)].astype(jnp.int32)
        code = jnp.where(t < k[:, None], code * 4 + g, code)
    vals = jnp.where(in_code, code, raw)
    vals = jnp.where(valid, vals, INT_MAX)

    perm = jnp.argsort(vals, axis=1, stable=True)
    svals = jnp.take_along_axis(vals, perm, axis=1)
    first = jnp.concatenate(
        [jnp.ones((qb, 1), bool), svals[:, 1:] != svals[:, :-1]], axis=1
    )
    last = jnp.concatenate(
        [svals[:, :-1] != svals[:, 1:], jnp.ones((qb, 1), bool)], axis=1
    )
    jj = jnp.broadcast_to(j, (qb, v_pad))
    start = jax.lax.cummax(jnp.where(first, jj, -1), axis=1)
    end = jax.lax.cummin(
        jnp.where(last, jj, v_pad), axis=1, reverse=True
    )
    cnt = end - start + 1
    valids = svals != INT_MAX
    cntv = jnp.where(valids, cnt, 0)
    maxfreq = jnp.max(cntv, axis=1)

    # scatter run leaders (max-frequency runs only) to original positions
    is_max_first = first & valids & (cntv == maxfreq[:, None])
    rows = jnp.arange(qb)[:, None]
    node_at_orig = jnp.full((qb, v_pad), -1, jnp.int32)
    node_at_orig = node_at_orig.at[rows, perm].set(
        jnp.where(is_max_first, svals, -1)
    )
    mask_orig = node_at_orig >= 0
    rank = jnp.cumsum(mask_orig, axis=1) - 1
    listed_orig = mask_orig & (rank < MAX_NUM_MAXNODES)
    n_nodes = jnp.minimum(mask_orig.sum(axis=1), MAX_NUM_MAXNODES)
    nodes = jnp.full((qb, MAX_NUM_MAXNODES), -1, jnp.int32)
    tgt = jnp.where(listed_orig, rank, MAX_NUM_MAXNODES)
    nodes = nodes.at[rows, tgt].set(node_at_orig, mode="drop")

    # decrement listed nodes in the live table (per-element): an element
    # belongs to a listed run iff its run leader's ORIGINAL position is
    # listed
    first_pos = jnp.take_along_axis(perm, start, axis=1)  # run leader origin
    listed_sorted = jnp.take_along_axis(
        listed_orig, jnp.clip(first_pos, 0, v_pad - 1), axis=1
    ) & valids
    adj = cntv - listed_sorted.astype(jnp.int32)
    return svals, adj, maxfreq, nodes, n_nodes


# ---------------------------------------------------------------------------
# stage B: speculative walks
# ---------------------------------------------------------------------------


def _freq_rows(sv, sc, nodes):
    """nodes (J, C) looked up in per-job sorted tables sv/sc (J, V)."""
    idx = jax.vmap(jnp.searchsorted)(sv, nodes)
    idx = jnp.clip(idx, 0, sv.shape[1] - 1)
    hit = jnp.take_along_axis(sv, idx, axis=1) == nodes
    return jnp.where(hit, jnp.take_along_axis(sc, idx, axis=1), 0)


@jax.jit
def _stage_b(sv, sc, node0, is_fwd, k, lmax):
    """sv/sc (J, V_pad) per-job tables; returns found/period/overflow (J,)
    and units/scores (J, 500)."""
    J = node0.shape[0]
    pow4 = jnp.array(_POW4, jnp.int32)
    T = T_DEV
    tj = jnp.arange(4, dtype=jnp.int32)[None, None, :]
    lmax_all = jnp.max(lmax)
    k1 = pow4[k - 1]
    fwd = is_fwd.astype(bool)

    def freq1(nodes):
        return _freq_rows(sv, sc, nodes[:, None])[:, 0]

    def la_body(st):
        m, ties, tcnt, la_done, broke, md, m_out, ovf, node, max_la, active = st
        la_act = ~la_done & (m <= max_la) & active
        km = pow4[jnp.clip(k - m, 0, 15)]        # (J,)
        pm1 = pow4[jnp.clip(m - 1, 0, 15)]       # scalar (m is scalar)
        pm = pow4[jnp.clip(m, 0, 15)]            # scalar
        lsd = 4 * ties[:, :, None] + tj
        tmp_f = (pm * (node % km))[:, None, None] + lsd
        msd = tj * pm1 + ties[:, :, None]
        tmp_b = msd * km[:, None, None] + (node // pm)[:, None, None]
        cand = jnp.where(fwd[:, None, None], lsd, msd).reshape(J, 4 * T)
        tmpn = jnp.where(fwd[:, None, None], tmp_f, tmp_b).reshape(J, 4 * T)
        cnts = _freq_rows(sv, sc, tmpn)
        validc = jnp.repeat(
            jnp.arange(T)[None, :] < tcnt[:, None], 4, axis=1
        )
        cm = jnp.max(jnp.where(validc, cnts, -1), axis=1)
        mask = validc & (cnts == cm[:, None])
        firsti = jnp.argmax(mask, axis=1)
        md_new = jnp.take_along_axis(cand, firsti[:, None], axis=1)[:, 0]
        nt = mask.sum(axis=1)
        ovf = ovf | (la_act & (nt > T))
        rk = jnp.cumsum(mask, axis=1) - 1
        tgt = jnp.where(mask & (rk < T), rk, T)
        new_ties = jnp.zeros((J, T), jnp.int32)
        new_ties = new_ties.at[jnp.arange(J)[:, None], tgt].set(cand, mode="drop")
        brk = jnp.where(fwd, nt == 1, nt <= 1)
        md = jnp.where(la_act, md_new, md)
        m_out = jnp.where(la_act & brk, m, m_out)
        broke = broke | (la_act & brk)
        la_done = la_done | (la_act & brk)
        cont = la_act & ~brk
        ties = jnp.where(cont[:, None], new_ties, ties)
        tcnt = jnp.where(cont, jnp.minimum(nt, T), tcnt)
        return (m + 1, ties, tcnt, la_done, broke, md, m_out, ovf, node,
                max_la, active)

    def body(st):
        l, node, done, found, period, units, scores, ovf = st
        active = ~done & (l < lmax)
        # forward records the CURRENT node's digit/score before stepping
        fdig = node // k1
        fsc = freq1(node)
        max_la = jnp.where(l < 10, 1, k)
        ties0 = jnp.zeros((J, T), jnp.int32)
        tcnt0 = jnp.ones(J, jnp.int32)
        st_la = (jnp.int32(1), ties0, tcnt0, ~active,
                 jnp.zeros(J, bool), jnp.zeros(J, jnp.int32),
                 jnp.zeros(J, jnp.int32), ovf, node, max_la, active)
        # BOUNDED lookahead: every job is inert past its own max_la
        # (la_act masks it), so max over active jobs bounds the loop
        la_bound = jnp.max(jnp.where(active, max_la, 1))
        (_, _, _, _, broke, md, m_out, ovf, _, _, _) = jax.lax.fori_loop(
            0, la_bound, lambda _t, s: la_body(s), st_la
        )
        m_out = jnp.where(active & ~broke, max_la + 1, m_out)
        nf = 4 * (node % k1) + md // pow4[jnp.clip(m_out - 1, 0, 15)]
        nb = (md % 4) * k1 + node // 4
        node = jnp.where(active, jnp.where(fwd, nf, nb), node)
        # backward records the NEW node's digit/score after stepping
        bdig = node // k1
        bsc = freq1(node)
        dig = jnp.where(fwd, fdig, bdig)
        scr = jnp.where(fwd, fsc, bsc)
        units = units.at[:, l].set(jnp.where(active, dig, units[:, l]))
        scores = scores.at[:, l].set(jnp.where(active, scr, scores[:, l]))
        looped = active & (node == node0)
        period = jnp.where(looped, l + 1, period)
        found = found | (looped & (l + 1 < MAX_PERIOD))
        done = done | looped | ((l + 1) >= lmax)
        return (l + 1, node, done, found, period, units, scores, ovf)

    st0 = (
        jnp.int32(0), node0, lmax <= 0, jnp.zeros(J, bool),
        jnp.zeros(J, jnp.int32),
        jnp.zeros((J, MAX_PERIOD), jnp.int32),
        jnp.zeros((J, MAX_PERIOD), jnp.int32),
        jnp.zeros(J, bool),
    )
    # BOUNDED walk: lmax_all (= max range width / 5, <= 500) steps of a
    # fully masked body — no data-dependent while_loop
    _, _, _, found, period, units, scores, ovf = jax.lax.fori_loop(
        0, lmax_all, lambda _t, s: body(s), st0
    )
    return found, period, units, scores, ovf


# ---------------------------------------------------------------------------
# host orchestration + fallback
# ---------------------------------------------------------------------------


def _v_bucket(v: int) -> int:
    for b in V_BUCKETS:
        if v <= b:
            return b
    return V_BUCKETS[-1]


def dbg_walk_device_batch(org_arrays, len_table, read_idx, qss, qes, ks):
    """Device equivalent of native.dbg_walk_batch2: same result dict
    (fwd_row/bwd_row into units/scores rows, fwd/bwd_period, found_last).
    Queries outside the device envelope (range wider than V_MAX) or whose
    tie lists overflow T_DEV fall back to the host oracle per query."""
    n = len(read_idx)
    read_idx = np.asarray(read_idx, np.int64)
    qss = np.asarray(qss, np.int64)
    qes = np.asarray(qes, np.int64)
    ks = np.asarray(ks, np.int64)
    lens = np.asarray(len_table, np.int64)

    fwd_row = np.full(n, -1, np.int32)
    bwd_row = np.full(n, -1, np.int32)
    fwd_period = np.zeros(n, np.int32)
    bwd_period = np.zeros(n, np.int32)
    found_last = np.zeros(n, np.int32)
    unit_rows: list[np.ndarray] = []
    score_rows: list[np.ndarray] = []

    L_pad = max(128, -(-int(max(len(o) for o in org_arrays)) // 128) * 128)
    orgs = np.zeros((len(org_arrays), L_pad), np.int32)
    for i, o in enumerate(org_arrays):
        orgs[i, : len(o)] = o
    orgs_dev = jnp.asarray(orgs)

    V = qes - qss + 1
    km_end = np.minimum(qes, lens[read_idx] - ks + 1)
    lmax = np.minimum(MAX_PERIOD, (qes - qss) // MIN_NUM_FREQ_UNIT)

    fallback: list[int] = []
    order = np.argsort(V, kind="stable")
    pos = 0
    while pos < len(order):
        v_pad = _v_bucket(int(V[order[pos]]))
        take = []
        while pos < len(order) and _v_bucket(int(V[order[pos]])) == v_pad:
            qi = int(order[pos])
            if V[qi] > V_MAX:
                fallback.append(qi)
            else:
                take.append(qi)
            pos += 1
        qb_cap = max(64, (1 << 23) // v_pad)
        for lo in range(0, len(take), qb_cap):
            chunk = np.array(take[lo : lo + qb_cap], np.int64)
            _run_chunk(
                chunk, v_pad, orgs_dev, read_idx, qss, km_end, V, ks, lmax,
                fallback, fwd_row, bwd_row, fwd_period, bwd_period,
                found_last, unit_rows, score_rows,
            )

    for qi in fallback:
        _host_fallback_query(
            qi, org_arrays, lens, read_idx, qss, qes, ks,
            fwd_row, bwd_row, fwd_period, bwd_period, found_last,
            unit_rows, score_rows,
        )

    n_rows = len(unit_rows)
    units = (
        np.stack(unit_rows) if n_rows else np.zeros((0, MAX_PERIOD), np.int32)
    )
    scores = (
        np.stack(score_rows) if n_rows else np.zeros((0, MAX_PERIOD), np.int32)
    )
    return {
        "fwd_row": fwd_row, "bwd_row": bwd_row,
        "fwd_period": fwd_period, "bwd_period": bwd_period,
        "found_last": found_last, "units": units, "scores": scores,
    }


def _run_chunk(chunk, v_pad, orgs_dev, read_idx, qss, km_end, V, ks, lmax,
               fallback, fwd_row, bwd_row, fwd_period, bwd_period,
               found_last, unit_rows, score_rows):
    from mtr.utils.timers import TIMERS

    qb = len(chunk)
    with TIMERS.section("count_table"):  # device analog of -c's
        # "count table generation" (consensus.c:73-127): measured around
        # the k-mer table/max-node stage including its materialization
        sv, adj, maxfreq, nodes, n_nodes = _stage_a(
            v_pad,
            orgs_dev,
            jnp.asarray(read_idx[chunk], jnp.int32),
            jnp.asarray(qss[chunk], jnp.int32),
            jnp.asarray(km_end[chunk], jnp.int32),
            jnp.asarray(V[chunk], jnp.int32),
            jnp.asarray(ks[chunk], jnp.int32),
        )
        maxfreq.block_until_ready()
    maxfreq_h = np.asarray(maxfreq)
    nodes_h = np.asarray(nodes)
    n_nodes_h = np.asarray(n_nodes)

    # speculative jobs: every (gated query, direction, start node)
    jobs = []  # (chunk_row, node, is_fwd, node_rank)
    for r in range(qb):
        if maxfreq_h[r] > MIN_NUM_FREQ_UNIT:
            for d in (1, 0):
                for ni in range(int(n_nodes_h[r])):
                    jobs.append((r, int(nodes_h[r, ni]), d, ni))
    if not jobs:
        return
    tq = np.array([j[0] for j in jobs], np.int32)
    node0 = np.array([j[1] for j in jobs], np.int32)
    isf = np.array([j[2] for j in jobs], np.int32)
    rank = np.array([j[3] for j in jobs], np.int32)
    sv_j = jnp.take(sv, jnp.asarray(tq), axis=0)
    sc_j = jnp.take(adj, jnp.asarray(tq), axis=0)
    found, period, units, scores, ovf = _stage_b(
        sv_j, sc_j, jnp.asarray(node0),
        jnp.asarray(isf), jnp.asarray(ks[chunk][tq], jnp.int32),
        jnp.asarray(lmax[chunk][tq], jnp.int32),
    )
    found = np.asarray(found)
    period = np.asarray(period)
    units = np.asarray(units)
    scores = np.asarray(scores)
    ovf = np.asarray(ovf)

    for r in range(qb):
        qi = int(chunk[r])
        if maxfreq_h[r] <= MIN_NUM_FREQ_UNIT:
            continue  # gate failed: no walks, found_last stays 0
        bad = False
        any_bwd_found = False
        for d, row_arr, per_arr in ((1, fwd_row, fwd_period), (0, bwd_row, bwd_period)):
            sel = np.nonzero((tq == r) & (isf == d))[0]
            sel = sel[np.argsort(rank[sel])]
            winner = -1
            for ji in sel:
                if found[ji]:
                    winner = ji
                    break
            # the reference stops at the first looping node; an overflow
            # at or before the winner could have changed the outcome
            for ji in sel:
                if ovf[ji] and (winner < 0 or rank[ji] <= rank[winner]):
                    bad = True
            if bad:
                break
            if winner >= 0:
                p = int(period[winner])
                u = units[winner, :p].astype(np.int32)
                s = scores[winner, :p].astype(np.int32)
                if d == 0:
                    u = u[::-1].copy()
                    s = s[::-1].copy()
                    any_bwd_found = True
                row_arr[qi] = len(unit_rows)
                per_arr[qi] = p
                buf_u = np.zeros(MAX_PERIOD, np.int32)
                buf_s = np.zeros(MAX_PERIOD, np.int32)
                buf_u[:p] = u
                buf_s[:p] = s
                unit_rows.append(buf_u)
                score_rows.append(buf_s)
        if bad:
            fwd_row[qi] = -1
            bwd_row[qi] = -1
            fallback.append(qi)
            continue
        found_last[qi] = 1 if any_bwd_found else 0


def _host_fallback_query(qi, org_arrays, lens, read_idx, qss, qes, ks,
                         fwd_row, bwd_row, fwd_period, bwd_period,
                         found_last, unit_rows, score_rows):
    from mtr.oracle.dbg import walk_candidates
    from mtr.records import RepeatRecord
    from mtr.utils.encoding import encode_bases

    ridx = int(read_idx[qi])
    template = RepeatRecord()
    template.kmer = int(ks[qi])
    cands, found = walk_candidates(
        org_arrays[ridx], int(lens[ridx]), int(qss[qi]), int(qes[qi]), template
    )
    found_last[qi] = found
    # walk_candidates returns forward candidate first when both exist
    rows = [(fwd_row, fwd_period), (bwd_row, bwd_period)]
    # determine direction of each candidate by order: forward first if
    # two; a single candidate's direction is ambiguous from the list
    # alone, so re-derive: candidates are appended fwd then bwd
    if len(cands) == 2:
        dirs = [0, 1]
    elif len(cands) == 1:
        # if found_last == 1 the bwd search succeeded; whether the fwd
        # one did requires its absence to mean failure — walk_candidates
        # appends in direction order, so a single candidate with
        # found_last=1 could be bwd-only; with found_last=0 it is fwd-only
        dirs = [1] if found == 1 else [0]
    else:
        dirs = []
    for cand, di in zip(cands, dirs):
        row_arr, per_arr = rows[di]
        p = cand.rep_period
        row_arr[qi] = len(unit_rows)
        per_arr[qi] = p
        buf_u = np.zeros(MAX_PERIOD, np.int32)
        buf_s = np.zeros(MAX_PERIOD, np.int32)
        buf_u[:p] = encode_bases(cand.string)
        buf_s[:p] = cand.string_score
        unit_rows.append(buf_u)
        score_rows.append(buf_s)
