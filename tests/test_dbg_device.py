"""Device DBG (counting + max nodes + greedy walk) vs the host oracle —
the per-query walk outcome must match bit-for-bit (found flag, unit
codes, per-base scores, direction semantics)."""

import numpy as np

from mtr.oracle.dbg import walk_candidates, query_kmer_values, CountTable
from mtr.ops.dbg_device import dbg_walk_device_batch, _stage_a, _v_bucket
from mtr.records import RepeatRecord
from mtr.utils.encoding import encode_bases


def oracle_result(org, L, qs, qe, k):
    template = RepeatRecord()
    template.kmer = k
    cands, found = walk_candidates(org, L, qs, qe, template)
    return cands, found


def make_read(rng, L, unit_len, noise=0.1):
    unit = rng.integers(0, 4, unit_len)
    seq = np.tile(unit, L // unit_len + 1)[:L].copy()
    n_err = int(L * noise)
    if n_err:
        idx = rng.integers(0, L, n_err)
        seq[idx] = rng.integers(0, 4, n_err)
    org = np.zeros(L + 1, np.int64)
    org[:L] = seq
    return org


def check_queries(org_list, lens, queries):
    ridx = np.array([q[0] for q in queries])
    qss = np.array([q[1] for q in queries])
    qes = np.array([q[2] for q in queries])
    ks = np.array([q[3] for q in queries])
    res = dbg_walk_device_batch(org_list, lens, ridx, qss, qes, ks)
    for i, (r, qs, qe, k) in enumerate(queries):
        cands, found = oracle_result(org_list[r], lens[r], qs, qe, k)
        assert res["found_last"][i] == found, (i, k, qs, qe)
        got_rows = []
        for row_arr, per_arr in (
            (res["fwd_row"], res["fwd_period"]),
            (res["bwd_row"], res["bwd_period"]),
        ):
            row = row_arr[i]
            if row >= 0:
                p = per_arr[i]
                got_rows.append(
                    (res["units"][row, :p].tolist(),
                     res["scores"][row, :p].tolist())
                )
        want_rows = [
            (encode_bases(c.string).tolist(), list(c.string_score))
            for c in cands
        ]
        assert got_rows == want_rows, (i, k, qs, qe, got_rows, want_rows)


def test_dbg_device_periodic_fuzz():
    rng = np.random.default_rng(0)
    org_list, lens, queries = [], [], []
    for r in range(6):
        unit_len = int(rng.integers(2, 40))
        L = int(rng.integers(200, 1200))
        org_list.append(make_read(rng, L, unit_len, noise=0.08))
        lens.append(L)
        for _ in range(8):
            qs = int(rng.integers(0, L // 2))
            qe = int(rng.integers(qs + 20, L - 1))
            k = int(rng.integers(2, 11))
            queries.append((r, qs, qe, k))
    check_queries(org_list, lens, queries)


def test_dbg_device_high_k_and_tail_quirk():
    # k up to 15 exercises the hash-range codes and the raw-tail quirk
    # (positions past L-k+1 counted as raw bases, consensus.c:42-57)
    rng = np.random.default_rng(1)
    org_list, lens, queries = [], [], []
    for r in range(4):
        unit_len = int(rng.integers(20, 120))
        L = int(rng.integers(600, 2000))
        org_list.append(make_read(rng, L, unit_len, noise=0.05))
        lens.append(L)
        for _ in range(5):
            k = int(rng.integers(11, 16))
            qe = L - 1 - int(rng.integers(0, 5))  # near the read end
            qs = int(rng.integers(0, max(1, qe - 800)))
            queries.append((r, qs, qe, k))
    check_queries(org_list, lens, queries)


def test_dbg_device_random_noise_no_repeat():
    # mostly gate failures and failed walks (found_last == 0 paths)
    rng = np.random.default_rng(2)
    org_list, lens, queries = [], [], []
    for r in range(4):
        L = 500
        org = np.zeros(L + 1, np.int64)
        org[:L] = rng.integers(0, 4, L)
        org_list.append(org)
        lens.append(L)
        for _ in range(6):
            qs = int(rng.integers(0, 200))
            qe = int(rng.integers(qs + 30, L - 1))
            queries.append((r, qs, qe, int(rng.integers(2, 9))))
    check_queries(org_list, lens, queries)


def test_dbg_device_tiny_units_tie_storms():
    # homopolymers / 2-mers produce massive tie lists -> exercises the
    # overflow -> host-fallback path
    rng = np.random.default_rng(3)
    org_list, lens, queries = [], [], []
    for r, unit in enumerate(([0], [0, 1], [2, 2, 3])):
        L = 400
        seq = np.tile(unit, L // len(unit) + 1)[:L].copy()
        idx = rng.integers(0, L, 12)
        seq[idx] = rng.integers(0, 4, 12)
        org = np.zeros(L + 1, np.int64)
        org[:L] = seq
        org_list.append(org)
        lens.append(L)
        for k in (2, 3, 5, 7):
            queries.append((r, 5, L - 2, k))
    check_queries(org_list, lens, queries)


def test_stage_a_tables_match_oracle():
    # counting layer alone: maxFreq + ordered max-node list + decrement
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    for trial in range(6):
        L = int(rng.integers(100, 800))
        org = make_read(rng, L, int(rng.integers(2, 30)), noise=0.1)
        qs = int(rng.integers(0, L // 3))
        qe = int(rng.integers(qs + 20, L - 1))
        k = int(rng.integers(2, 12))
        vals = query_kmer_values(org, L, k, qs, qe)
        table = CountTable(vals)
        want_nodes, want_max = table.list_max_nodes()

        v = qe - qs + 1
        v_pad = _v_bucket(v)
        orgs = np.zeros((1, ((L + 128) // 128) * 128), np.int32)
        orgs[0, : L + 1] = org
        sv, adj, maxfreq, nodes, n_nodes = _stage_a(
            v_pad, jnp.asarray(orgs),
            jnp.zeros(1, jnp.int32),
            jnp.array([qs], jnp.int32),
            jnp.array([min(qe, L - k + 1)], jnp.int32),
            jnp.array([v], jnp.int32),
            jnp.array([k], jnp.int32),
        )
        assert int(maxfreq[0]) == want_max
        got_nodes = [int(x) for x in np.asarray(nodes[0, : int(n_nodes[0])])]
        assert got_nodes == want_nodes, (trial, got_nodes, want_nodes)
        # decremented counts visible through lookup
        sv_h, adj_h = np.asarray(sv[0]), np.asarray(adj[0])
        for nd in want_nodes[:5]:
            i = np.searchsorted(sv_h, nd)
            assert adj_h[i] == table.freq(nd), nd
