"""Cross-read repeat-unit clustering — the reference's legacy phase 2
(k_means_clustering.c, unlinked from the current binary; see SURVEY.md
2.12).  This is the only cross-read computation in the system and hence
the natural all-gather point in a multi-host run.

Algorithm (faithful to the reference's live code — despite the filename
there is no Lloyd k-means):
  1. qualify TRs (unit span > min_rep_len, match ratio, >1 unit copies);
  2. sort by (rep_period, freq_2mer[16], num_freq_unit);
  3. group identical (rep_period, freq_2mer) keys with group size >=
     min_num_rep_tr; the LAST member represents the group
     (k_means_clustering.c:136-167);
  4. merge groups whose unit lengths differ <= 10% and whose 2-mer
     histograms lie within Manhattan distance 0.3 * rep_period,
     pointing each group at its largest neighbor, then chase roots and
     accumulate frequencies (:169-233);
  5. emit records sorted by (-group_freq, group_root_id).

The pairwise Manhattan distances in step 4 are computed as one batched
|a-b| reduction over the (G, 16) histogram matrix — on device (jitted,
see _near_matrix_device) when a JAX backend is usable and the group
count exceeds _DEVICE_MIN_GROUPS, else in NumPy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from mtr.records import RepeatRecord

MH_DISTANCE_THRESHOLD = 0.3   # chaining.cpp:39 / k_means_clustering.c:176
MIN_NUM_REP_TR = 2            # minimum group size for a representative
MIN_REP_LEN = 10              # qualification span threshold

# below this the host<->device transfer dwarfs the O(G^2 * 16) reduction
_DEVICE_MIN_GROUPS = 2048


@functools.lru_cache(maxsize=1)
def _device_near_fn():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def near(hists, periods):
        # (G, G) Manhattan distances over 2-mer histograms + the
        # reference's <=10% unit-length gate (k_means_clustering.c:169-180);
        # both gates in exact integer arithmetic (d <= 0.1p <=> 10d <= p
        # for the value ranges here) so host and device agree bit-for-bit
        dist = jnp.abs(hists[:, None, :] - hists[None, :, :]).sum(axis=2)
        len_ok = 10 * jnp.abs(periods[:, None] - periods[None, :]) <= (
            periods[:, None]
        )
        return (10 * dist <= 3 * periods[:, None]) & len_ok

    return near


def _near_matrix(hists: np.ndarray, periods: np.ndarray) -> np.ndarray:
    """Pairwise merge-eligibility matrix; device-backed for large G."""
    n = len(hists)
    if n >= _DEVICE_MIN_GROUPS:
        return np.asarray(
            _device_near_fn()(hists.astype(np.int32), periods.astype(np.int32))
        )
    dist = np.abs(hists[:, None, :] - hists[None, :, :]).sum(axis=2)
    len_ok = 10 * np.abs(periods[:, None] - periods[None, :]) <= (
        periods[:, None]
    )
    return (10 * dist <= 3 * periods[:, None]) & len_ok


@dataclasses.dataclass
class ClusteredTR:
    record: RepeatRecord
    global_id: int
    rep_id: int      # root representative's global id
    group_freq: int  # size of the merged group


def _sort_key(rec: RepeatRecord):
    return (rec.rep_period, tuple(rec.freq_2mer), rec.num_freq_unit)


def cluster_repeats(
    records: list[RepeatRecord],
    min_match_ratio: float = 0.6,
    min_num_rep_tr: int = MIN_NUM_REP_TR,
) -> list[ClusteredTR]:
    # 1. qualification (k_means_clustering.c:267-283)
    qualified: list[tuple[int, RepeatRecord]] = []
    for gid, rec in enumerate(records):
        if rec.repeat_len <= 0:
            continue
        ratio = rec.num_matches / rec.repeat_len
        if (
            rec.rep_period * rec.num_freq_unit > MIN_REP_LEN
            and ratio > min_match_ratio
            and rec.num_freq_unit > 1
        ):
            qualified.append((gid, rec))
    if not qualified:
        return []

    # 2. sort by (period, 2-mer histogram, unit count)
    qualified.sort(key=lambda t: _sort_key(t[1]))

    # 3. group identical (period, histogram) keys
    groups: list[dict] = []  # {"members": [...], "rep": gid, "freq": n}
    cur: list[tuple[int, RepeatRecord]] = []

    def flush_group():
        if len(cur) >= min_num_rep_tr:
            groups.append(
                {"members": list(cur), "rep_idx": len(groups), "freq": len(cur)}
            )

    for item in qualified:
        if cur and _sort_key(item[1])[:2] != _sort_key(cur[-1][1])[:2]:
            flush_group()
            cur = []
        cur.append(item)
    flush_group()
    if not groups:
        return []

    # 4. merge near-identical groups (vectorized pairwise Manhattan)
    periods = np.array([g["members"][-1][1].rep_period for g in groups])
    hists = np.array(
        [g["members"][-1][1].freq_2mer for g in groups], dtype=np.int64
    )
    freqs = np.array([g["freq"] for g in groups])
    n = len(groups)
    near = _near_matrix(hists, periods)

    parent = np.arange(n)
    for i in range(n):
        cand = np.nonzero(near[i])[0]
        best = i
        best_freq = freqs[i]
        for j in cand:
            if freqs[j] > best_freq:
                best_freq = freqs[j]
                best = int(j)
        parent[i] = best

    def root(i: int) -> int:
        while parent[i] != i:
            i = int(parent[i])
        return i

    group_freq = freqs.copy()
    for i in range(n):
        r = root(i)
        if r != i:
            group_freq[r] += freqs[i]

    # 5. emit, sorted by (-merged group freq, root id)
    out: list[ClusteredTR] = []
    for i, g in enumerate(groups):
        r = root(i)
        rep_gid = groups[r]["members"][-1][0]
        for gid, rec in g["members"]:
            out.append(
                ClusteredTR(
                    record=rec,
                    global_id=gid,
                    rep_id=rep_gid,
                    group_freq=int(group_freq[r]),
                )
            )
    out.sort(key=lambda c: (-c.group_freq, c.rep_id, c.global_id))
    return out


def gather_records_multihost(local_records: list[RepeatRecord]):
    """All-gather fixed-width record arrays across a jax.distributed run
    so every host can run cluster_repeats on the full set.  On a single
    process this is the identity."""
    import jax

    if jax.process_count() == 1:
        return local_records
    from jax.experimental import multihost_utils

    def pack(rec: RepeatRecord):
        return np.array(
            [rec.rep_period, rec.num_freq_unit, rec.num_matches, rec.repeat_len]
            + list(rec.freq_2mer),
            dtype=np.int32,
        )

    packed = np.stack([pack(r) for r in local_records]) if local_records else np.zeros((0, 20), np.int32)
    gathered = multihost_utils.process_allgather(packed)
    out = []
    for row in gathered.reshape(-1, packed.shape[1] if packed.size else 20):
        rec = RepeatRecord()
        rec.rep_period = int(row[0])
        rec.num_freq_unit = int(row[1])
        rec.num_matches = int(row[2])
        rec.repeat_len = int(row[3])
        rec.freq_2mer = [int(v) for v in row[4:20]]
        out.append(rec)
    return out
