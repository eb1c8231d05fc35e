"""Device max-frequency pre-filter (ops/mf_filter.py) vs the oracle
multiset (oracle.dbg.query_kmer_values): the computed max multiplicity
must be EXACT — a false "unwalked" would change output vs the
reference (consensus.c:532)."""

import numpy as np
import pytest

import mtr.ops.mf_filter as MF
from mtr.ops.mf_filter import walked_mask, MIN_NUM_FREQ_UNIT
from mtr.oracle.dbg import query_kmer_values


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    # production chunk rows are sized for an accelerator (131k);
    # padding every CPU test call to that burns ~a minute for nothing
    monkeypatch.setattr(
        MF, "_Q_CHUNK", {64: 512, 256: 512, 1024: 512})


def oracle_walked(org, L, qs, qe, k):
    vals = query_kmer_values(org, L, k, qs, qe)
    _, counts = np.unique(vals, return_counts=True)
    return int(counts.max()) > MIN_NUM_FREQ_UNIT


def _check(orgs, lens, ridx, qs, qe, k):
    got = walked_mask(orgs, lens, ridx, qs, qe, k)
    for i in range(len(ridx)):
        want = oracle_walked(orgs[ridx[i]], lens[ridx[i]],
                             int(qs[i]), int(qe[i]), int(k[i]))
        V = int(qe[i] - qs[i] + 1)
        if V > 1024:
            assert got[i], "wide queries must stay host-routed"
        else:
            assert bool(got[i]) == want, (
                f"query {i}: qs={qs[i]} qe={qe[i]} k={k[i]} V={V}: "
                f"device={bool(got[i])} oracle={want}")


def test_mf_filter_random_queries():
    rng = np.random.default_rng(7)
    # read 0: noise; read 1: repeat-dense (unit 11 tiled) + noise tail
    r0 = rng.integers(0, 4, 3000).astype(np.int32)
    unit = rng.integers(0, 4, 11)
    r1 = np.concatenate([
        rng.integers(0, 4, 200),
        np.tile(unit, 120)[:1300],
        rng.integers(0, 4, 500),
    ]).astype(np.int32)
    orgs = [r0, r1]
    lens = [len(r0), len(r1)]
    n = 300
    ridx = rng.integers(0, 2, n).astype(np.int32)
    L = np.asarray(lens)[ridx]
    qs = (rng.random(n) * (L - 40)).astype(np.int32)
    width = rng.integers(8, 200, n)
    qe = np.minimum(qs + width, L - 1).astype(np.int32)
    k = rng.integers(2, 16, n).astype(np.int32)
    _check(orgs, lens, ridx, qs, qe, k)


def test_mf_filter_read_edge_tail():
    # ranges hugging the read end: the raw-base tail grows with k and
    # can collide with A^(k-1)X codes — the multiset must stay exact
    rng = np.random.default_rng(8)
    r = np.zeros(400, np.int32)  # all-A homopolymer: worst collisions
    r[150:340] = rng.integers(0, 4, 190)
    orgs, lens = [r], [400]
    qs, qe, ks = [], [], []
    for k in range(2, 16):
        for end in (399, 395, 390):
            qs.append(end - 60)
            qe.append(end)
            ks.append(k)
    n = len(qs)
    _check(orgs, lens, np.zeros(n, np.int32),
           np.asarray(qs, np.int32), np.asarray(qe, np.int32),
           np.asarray(ks, np.int32))


def test_mf_filter_bucket_boundaries():
    rng = np.random.default_rng(9)
    r = np.tile(rng.integers(0, 4, 7), 400).astype(np.int32)[:2600]
    orgs, lens = [r], [len(r)]
    qs, qe, ks = [], [], []
    for V in (63, 64, 65, 255, 256, 257, 1023, 1024, 1025, 2000):
        qs.append(10)
        qe.append(10 + V - 1)
        ks.append(5)
    n = len(qs)
    _check(orgs, lens, np.zeros(n, np.int32),
           np.asarray(qs, np.int32), np.asarray(qe, np.int32),
           np.asarray(ks, np.int32))
