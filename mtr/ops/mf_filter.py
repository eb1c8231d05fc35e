"""Device max-frequency pre-filter for DBG walk queries.

A (range, k) walk query only does table-scan + walk work when the max
multiplicity of its value multiset exceeds MIN_NUM_FREQ_UNIT
(consensus.c:532 via mtr_dbg_walk); otherwise its outputs are the
constants (found=0, periods 0, no unit rows).  The multiset is cheap,
dense, uniform work — exactly what an accelerator batches well — while the
walk itself is irregular host work.  So the hybrid engine computes
EVERY query's max frequency on device in one dispatch per V-bucket
(segment gather from a resident flat read array -> rolling k-mer codes
-> row sort -> max run length) and hands the native engine only the
queries that will actually walk.

Exactness: the value multiset mirrors oracle query_kmer_values /
native query_vals bit-for-bit — k-mer codes at positions
[qs, min(qe, L-k+1)) then RAW bases up to qe inclusive; the max run
length of the sorted row is the multiset's max multiplicity.  Padding
lanes get per-lane distinct negative sentinels (multiplicity 1).

Reference: consensus.c:37-120 (table build), 532 (the walk gate).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

KMAX = 15            # reference maxKmer (mTR.h)
MIN_NUM_FREQ_UNIT = 5
V_BUCKETS = (64, 256, 1024)   # wider queries go to the host unfiltered
# fixed query-chunk rows per bucket: exactly three compiled programs
# ever exist; larger V needs fewer rows anyway
_Q_CHUNK = {64: 1 << 17, 256: 1 << 14, 1024: 1 << 12}


@functools.partial(jax.jit, static_argnums=(5,))
def _mf_rows(flat, starts, kq, kmn, v, v_pad: int):
    """Max multiset multiplicity per query row.

    flat   (F,) int8 padded read concatenation (trailing slack >= KMAX)
    starts (Q,) int32 absolute offset of qs in flat
    kq     (Q,) int32 k per query
    kmn    (Q,) int32 number of k-mer lanes = max(0, min(qe,L-k+1)-qs)
    v      (Q,) int32 range width qe-qs+1 (0 for padding rows)

    The multiplicity is a fused pairwise-equality count —
    max_i sum_j [vals_i == vals_j] — rather than a sort: XLA fuses the
    (Q, V, V) equality cube into the reduction, and the straight-line
    program compiles orders of magnitude faster than a sort HLO on
    proxied backends."""
    seg = jax.vmap(
        lambda s: jax.lax.dynamic_slice(flat, (s,), (v_pad + KMAX,))
    )(starts).astype(jnp.int32)
    q = starts.shape[0]
    code = jnp.zeros((q, v_pad), jnp.int32)
    for t in range(KMAX):
        code = jnp.where((t < kq)[:, None],
                         code * 4 + seg[:, t:t + v_pad], code)
    j = jnp.arange(v_pad, dtype=jnp.int32)[None, :]
    sent = -(j + 2) + jnp.zeros((q, 1), jnp.int32)
    vals = jnp.where(j < kmn[:, None], code,
                     jnp.where(j < v[:, None], seg[:, :v_pad], sent))
    counts = jnp.sum(
        (vals[:, :, None] == vals[:, None, :]).astype(jnp.int32), axis=2)
    return jnp.max(counts, axis=1).astype(jnp.int32)


class _FlatCache:
    key = None
    flat = None
    offs = None


def _flat_reads(orgs):
    """One int8 device upload per batch of reads (keyed by identity)."""
    key = tuple(id(o) for o in orgs)
    if _FlatCache.key == key:
        return _FlatCache.flat, _FlatCache.offs
    total = sum(len(o) for o in orgs)
    n_pad = max(1 << (total + V_BUCKETS[-1] + KMAX - 1).bit_length(),
                1 << 16)
    flat = np.zeros(n_pad, np.int8)
    offs = []
    off = 0
    for o in orgs:
        flat[off:off + len(o)] = o.astype(np.int8)
        offs.append(off)
        off += len(o)
    _FlatCache.key = key
    _FlatCache.flat = jax.device_put(flat)
    _FlatCache.offs = np.asarray(offs, np.int64)
    return _FlatCache.flat, _FlatCache.offs


def walked_mask(orgs, lens, ridx, qs, qe, k) -> np.ndarray:
    """Bool per query: True iff the native walk engine must process it
    (max_freq > MIN_NUM_FREQ_UNIT, or the query is wider than the
    largest device bucket)."""
    n = len(ridx)
    out = np.ones(n, bool)  # default: host processes (incl. whales)
    if n == 0:
        return out
    flat, offs = _flat_reads(orgs)
    lens_a = np.asarray(lens, np.int64)
    V = (qe - qs + 1).astype(np.int64)
    L_q = lens_a[ridx]
    km_end = np.minimum(qe.astype(np.int64), L_q - k + 1)
    kmn = np.maximum(0, km_end - qs).astype(np.int32)
    starts = (offs[ridx] + qs).astype(np.int32)
    order = np.argsort(V, kind="stable")
    lo = 0
    for v_pad in V_BUCKETS:
        hi = int(np.searchsorted(V[order], v_pad + 1))
        bucket = order[lo:hi]
        lo = hi
        q_chunk = _Q_CHUNK[v_pad]
        for c0 in range(0, len(bucket), q_chunk):
            idx = bucket[c0:c0 + q_chunk]
            qn = len(idx)
            st = np.zeros(q_chunk, np.int32)
            kq = np.ones(q_chunk, np.int32)
            km = np.zeros(q_chunk, np.int32)
            vv = np.zeros(q_chunk, np.int32)
            st[:qn] = starts[idx]
            kq[:qn] = k[idx]
            km[:qn] = kmn[idx]
            vv[:qn] = V[idx]
            mf = np.asarray(_mf_rows(flat, *_put(st, kq, km, vv),
                                     v_pad))[:qn]
            out[idx] = mf > MIN_NUM_FREQ_UNIT
    return out


def _put(*arrays):
    return [jax.device_put(a) for a in arrays]
