"""ctypes bindings for the native host runtime (native/mtr_host.cpp).

Every binding has a NumPy fallback (the oracle implementation), so the
framework runs without the shared library; `available()` reports which
path is active.  The library is built with `make -C native`.
"""

from __future__ import annotations

import ctypes as ct
import mmap
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

# MTR_THREADS caps the native worker count (0 = hardware
# concurrency).  The scaling bench pins 1 thread/process so multi-process
# efficiency is measured against a genuinely single-threaded baseline.
_THREADS = int(os.environ.get("MTR_THREADS", "0"))


def _nthreads(n: int) -> int:
    return _THREADS if n == 0 and _THREADS > 0 else n


class _BufPool:
    """Reusable, huge-page-backed scratch buffers keyed by use-site.

    Some deployment hosts serve guest memory lazily (post-copy/uffd
    style), making the FIRST touch of every fresh 4 KB page cost tens of
    microseconds.  Allocating multi-hundred-MB result arrays per batch
    call was 10-40x slower than the actual compute.  The pool (a) reuses
    buffers across calls so pages stay resident and (b) requests
    MADV_HUGEPAGE so compulsory faults cover 2 MB at a time (~10x
    cheaper first touch)."""

    def __init__(self):
        self._bufs: dict[str, mmap.mmap] = {}

    def get(self, name: str, shape, dtype, zero: bool = False) -> np.ndarray:
        count = 1
        for s in shape:
            count *= int(s)
        need = count * np.dtype(dtype).itemsize
        mm = self._bufs.get(name)
        if mm is None or len(mm) < need:
            cap = 1 << max(20, (max(need, 1) - 1).bit_length())
            mm = mmap.mmap(-1, cap)
            try:
                mm.madvise(mmap.MADV_HUGEPAGE)
            except (AttributeError, OSError):
                pass
            self._bufs[name] = mm
        arr = np.frombuffer(mm, dtype=dtype, count=count).reshape(shape)
        if zero:
            arr.fill(0)
        return arr


POOL = _BufPool()

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_HERE, "native", "libmtr_host.so")

MAX_PERIOD = 500


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(_HERE, "native", "mtr_host.cpp")
    # always build from source: a stale .so silently diverging from
    # mtr_host.cpp would poison parity, so rebuild whenever the source is
    # newer than the library (the .so is never committed — .gitignore)
    stale = (
        os.path.exists(_SO)
        and os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_SO)
    )
    if not os.path.exists(_SO) or stale:
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["make", "-C", os.path.join(_HERE, "native"), "-B"],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                if not os.path.exists(_SO):
                    return None
    if not os.path.exists(_SO):
        return None
    lib = ct.CDLL(_SO)

    i64 = ct.c_int64
    lib.mtr_extrema_pair.argtypes = [
        ct.POINTER(ct.c_double), i64, i64,
        ct.POINTER(ct.c_double), ct.POINTER(i64), ct.POINTER(i64),
    ]
    lib.mtr_remove_redundant.argtypes = [
        ct.POINTER(ct.c_double), ct.POINTER(i64), i64, ct.c_double,
    ]
    lib.mtr_sliding_l1.argtypes = [
        ct.POINTER(ct.c_int32), i64, i64, ct.POINTER(i64),
    ]
    lib.mtr_dbg_walk_batch.argtypes = [
        ct.POINTER(ct.c_void_p), ct.POINTER(i64), ct.POINTER(i64),
        ct.POINTER(i64), ct.POINTER(ct.c_int32), i64,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.c_int,
    ]
    lib.mtr_fill_di.argtypes = [
        ct.POINTER(ct.c_int32), i64, ct.POINTER(ct.c_int32), i64, i64,
        ct.c_int,
        ct.POINTER(ct.c_double), ct.POINTER(i64), ct.POINTER(i64),
    ]
    lib.mtr_dbg_walk_batch2.argtypes = [
        ct.POINTER(ct.c_void_p), ct.POINTER(i64),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), i64,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        i64, ct.c_int,
    ]
    lib.mtr_dbg_walk_batch2.restype = i64
    lib.mtr_polish.argtypes = [
        ct.POINTER(ct.c_int32), i64, i64, i64, ct.c_int,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.c_int,
        ct.POINTER(ct.c_int32),
    ]
    lib.mtr_polish.restype = ct.c_int
    lib.mtr_wrap_dp_batch.argtypes = [
        ct.POINTER(ct.c_void_p), ct.POINTER(i64), ct.POINTER(i64),
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
        ct.POINTER(ct.c_int32), i64,
        ct.POINTER(i64), ct.POINTER(i64), ct.POINTER(i64), ct.c_int,
    ]
    lib.mtr_traceback_counts.argtypes = [
        ct.POINTER(ct.c_uint8), i64, i64, i64,
        ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), i64,
        ct.POINTER(i64), ct.POINTER(i64),
    ]
    lib.mtr_traceback_consensus.argtypes = [
        ct.POINTER(ct.c_uint8), i64, i64, i64,
        ct.POINTER(ct.c_int32), i64, ct.POINTER(i64), ct.POINTER(i64),
    ]
    lib.mtr_stage_timers.argtypes = [ct.c_int]
    lib.mtr_stage_read.argtypes = [ct.POINTER(i64), ct.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def enable_stage_timers(on: bool = True) -> None:
    """Turn on real per-stage accumulators inside the walk engine
    (init_inputString / count-table / walk sections, matching
    mTR.h:142-143).  Off by default: timing costs ~6% of a walk query."""
    lib = _load()
    if lib is not None:
        lib.mtr_stage_timers(1 if on else 0)


def read_stage_timers(reset: bool = True) -> tuple[float, float, float]:
    """(init_s, count_table_s, walk_s) accumulated since the last reset."""
    lib = _load()
    if lib is None:
        return 0.0, 0.0, 0.0
    out = np.zeros(3, np.int64)
    lib.mtr_stage_read(_ip64(out), 1 if reset else 0)
    return float(out[0]) / 1e9, float(out[1]) / 1e9, float(out[2]) / 1e9


def _dp(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_double))


def _ip64(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int64))


def _ip32(a):
    return a.ctypes.data_as(ct.POINTER(ct.c_int32))


def extrema_pair(di_tmp, di, di_end, di_w, di_len, w) -> bool:
    lib = _load()
    if lib is None:
        return False
    lib.mtr_extrema_pair(_dp(di_tmp), di_len, w, _dp(di), _ip64(di_end), _ip64(di_w))
    return True


def remove_redundant(di, di_end, input_len, min_jaccard=0.98) -> bool:
    lib = _load()
    if lib is None:
        return False
    lib.mtr_remove_redundant(_dp(di), _ip64(di_end), input_len, min_jaccard)
    return True


def fill_di(buf: np.ndarray, org: np.ndarray, L: int, rsl: int,
            manhattan: bool = True, l4_cap: int | None = None):
    """Full DI pass for one read (flanks, k/w sweep in Manhattan or
    Pearson mode, extrema pairing, de-shift, redundancy removal) in one
    native call.  Mutates `buf` (the persistent input_w_rand arena) in
    place, preserving the stale-tail quirk.  Returns (di, di_end, di_w)
    or None without the lib."""
    lib = _load()
    if lib is None:
        return None
    di_len = L + 2 * rsl
    di = np.empty(di_len, np.float64)
    di_end = np.empty(di_len, np.int64)
    di_w = np.empty(di_len, np.int64)
    if l4_cap is None:
        l4_cap = len(buf)
    lib.mtr_fill_di(
        _ip32(buf), l4_cap, _ip32(org), L, rsl, 1 if manhattan else 0,
        _dp(di), _ip64(di_end), _ip64(di_w),
    )
    return di, di_end, di_w


def dbg_walk_batch(orgs: list[np.ndarray], input_lens, qss, qes, ks, n_threads=0):
    """Returns None if the library is unavailable, else a dict of arrays."""
    lib = _load()
    if lib is None:
        return None
    n = len(orgs)
    org_ptrs = (ct.c_void_p * n)(*[o.ctypes.data for o in orgs])
    input_lens = np.asarray(input_lens, np.int64)
    qss = np.asarray(qss, np.int64)
    qes = np.asarray(qes, np.int64)
    ks = np.asarray(ks, np.int32)
    # np.empty: the C++ side writes every row it reports found for, and
    # only found rows are read back (zeroing 1 GB/batch showed up in profiles)
    ff = np.zeros(n, np.int32)
    fp = np.zeros(n, np.int32)
    fu = np.empty((n, MAX_PERIOD), np.int32)
    fs = np.empty((n, MAX_PERIOD), np.int32)
    bf = np.zeros(n, np.int32)
    bp = np.zeros(n, np.int32)
    bu = np.empty((n, MAX_PERIOD), np.int32)
    bs = np.empty((n, MAX_PERIOD), np.int32)
    fl = np.zeros(n, np.int32)
    lib.mtr_dbg_walk_batch(
        org_ptrs, _ip64(input_lens), _ip64(qss), _ip64(qes), _ip32(ks), n,
        _ip32(ff), _ip32(fp), _ip32(fu), _ip32(fs),
        _ip32(bf), _ip32(bp), _ip32(bu), _ip32(bs),
        _ip32(fl), _nthreads(n_threads),
    )
    return dict(
        fwd_found=ff, fwd_period=fp, fwd_unit=fu, fwd_scores=fs,
        bwd_found=bf, bwd_period=bp, bwd_unit=bu, bwd_scores=bs,
        found_last=fl,
    )


def dbg_walk_batch2(org_arrays: list[np.ndarray], len_table, read_idx,
                    qss, qes, ks, n_threads=0):
    """Compact-output batched walks: reads addressed as a per-read table
    + per-query index; found units/scores land in pooled row buffers.

    Returns None without the lib, else a dict with per-query
    fwd_row/bwd_row (row into units/scores, -1 = not found),
    fwd_period/bwd_period, found_last, and the shared units/scores
    row arrays."""
    lib = _load()
    if lib is None:
        return None
    n = len(read_idx)
    n_reads = len(org_arrays)
    org_table = (ct.c_void_p * n_reads)(*[o.ctypes.data for o in org_arrays])
    len_table = np.ascontiguousarray(len_table, np.int64)
    read_idx = np.ascontiguousarray(read_idx, np.int32)
    qss = np.ascontiguousarray(qss, np.int32)
    qes = np.ascontiguousarray(qes, np.int32)
    ks = np.ascontiguousarray(ks, np.int32)
    frow = POOL.get("walk_frow", (n,), np.int32)
    brow = POOL.get("walk_brow", (n,), np.int32)
    fper = POOL.get("walk_fper", (n,), np.int32)
    bper = POOL.get("walk_bper", (n,), np.int32)
    flast = POOL.get("walk_flast", (n,), np.int32)
    cap = max(4096, n // 8)
    while True:
        units = POOL.get("walk_units", (cap, MAX_PERIOD), np.int32)
        scores = POOL.get("walk_scores", (cap, MAX_PERIOD), np.int32)
        used = lib.mtr_dbg_walk_batch2(
            org_table, _ip64(len_table), _ip32(read_idx),
            _ip32(qss), _ip32(qes), _ip32(ks), n,
            _ip32(frow), _ip32(brow), _ip32(fper), _ip32(bper), _ip32(flast),
            _ip32(units), _ip32(scores), cap, _nthreads(n_threads),
        )
        if used <= cap:
            break
        cap = int(used)
    return dict(
        fwd_row=frow, bwd_row=brow, fwd_period=fper, bwd_period=bper,
        found_last=flast, units=units, scores=scores,
    )


def traceback_counts(moves: np.ndarray, max_i, max_j, rep, unit, unit_len):
    lib = _load()
    if lib is None:
        return None
    out5 = np.zeros(5, np.int64)
    i_final = ct.c_int64(0)
    moves = np.ascontiguousarray(moves)
    rep = np.ascontiguousarray(rep, np.int32)
    unit = np.ascontiguousarray(unit, np.int32)
    lib.mtr_traceback_counts(
        moves.ctypes.data_as(ct.POINTER(ct.c_uint8)), moves.shape[1],
        int(max_i), int(max_j), _ip32(rep), _ip32(unit), unit_len,
        _ip64(out5), ct.byref(i_final),
    )
    return tuple(int(x) for x in out5), int(i_final.value)


def traceback_consensus(moves: np.ndarray, max_i, max_j, rep, unit_len):
    lib = _load()
    if lib is None:
        return None
    consensus = np.zeros((MAX_PERIOD, 5), np.int64)
    missing = np.zeros((MAX_PERIOD, 4), np.int64)
    moves = np.ascontiguousarray(moves)
    rep = np.ascontiguousarray(rep, np.int32)
    lib.mtr_traceback_consensus(
        moves.ctypes.data_as(ct.POINTER(ct.c_uint8)), moves.shape[1],
        int(max_i), int(max_j), _ip32(rep), unit_len,
        _ip64(consensus), _ip64(missing),
    )
    return consensus, missing


def sliding_l1(vals: np.ndarray, w: int, n_out: int):
    """Native incremental sliding-L1 (returns None without the lib)."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.int32)
    out = np.zeros(n_out, np.int64)
    lib.mtr_sliding_l1(_ip32(vals), n_out, w, _ip64(out))
    return out


def wrap_dp_batch(orgs, qss, qes, units, unit_lens, schemes, modes, n_threads=0):
    """Host wrap-DP batch.  units: (n,500) int32; returns
    (counts (n,7) int64, consensus (n,500,5), missing (n,500,4)) or None.
    Consensus/missing rows are only valid for mode-1 jobs."""
    lib = _load()
    if lib is None:
        return None
    n = len(orgs)
    org_ptrs = (ct.c_void_p * n)(*[o.ctypes.data for o in orgs])
    qss = np.ascontiguousarray(qss, np.int64)
    qes = np.ascontiguousarray(qes, np.int64)
    units = np.ascontiguousarray(units, np.int32)
    unit_lens = np.ascontiguousarray(unit_lens, np.int32)
    schemes = np.ascontiguousarray(schemes, np.int32)
    modes = np.ascontiguousarray(modes, np.int32)
    # pooled outputs: counts rows are fully written by the C side; the
    # consensus/missing accumulators are only read (and so only zeroed)
    # for mode-1 rows
    counts = POOL.get("dp_counts", (n, 7), np.int64)
    n_cons = int(modes.sum())
    if n_cons:
        consensus = POOL.get("dp_consensus", (n, 500, 5), np.int64)
        missing = POOL.get("dp_missing", (n, 500, 4), np.int64)
        sel = modes != 0
        consensus[sel] = 0
        missing[sel] = 0
    else:
        consensus = np.zeros((1, 500, 5), np.int64)
        missing = np.zeros((1, 500, 4), np.int64)
    lib.mtr_wrap_dp_batch(
        org_ptrs, _ip64(qss), _ip64(qes), _ip32(units), _ip32(unit_lens),
        _ip32(schemes), _ip32(modes), n,
        _ip64(counts), _ip64(consensus), _ip64(missing), _nthreads(n_threads),
    )
    return counts, consensus, missing


def polish(org, input_len, rep_start, rep_end, k, unit, scores):
    """Native polish_repeat; returns revised unit list or None (no lib)."""
    lib = _load()
    if lib is None:
        return None
    org = np.ascontiguousarray(org, np.int32)
    unit_arr = np.ascontiguousarray(unit, np.int32)
    scores_arr = np.ascontiguousarray(scores, np.int32)
    out = np.zeros(MAX_PERIOD, np.int32)
    res = lib.mtr_polish(
        _ip32(org), input_len, rep_start, rep_end, k,
        _ip32(unit_arr), _ip32(scores_arr), len(unit_arr), _ip32(out),
    )
    if res < 0:
        return list(unit_arr)  # polish bailed: unit unchanged
    return out[:res].tolist()
