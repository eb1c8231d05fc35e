"""Production pipeline: batched device compute + host sequential logic.

Processes reads in batches; per batch the work is organized into phases
so every wrap-around DP lands in a few large device dispatches instead
of the reference's one-matrix-at-a-time scalar fills:

  1. DI + candidate ranges   (host numpy / sequential pairing — the
                              arena reuse semantics force read order)
  2. DBG walks               (host, all (range, k) queries)
  3. DP batch #1             (device: every walk candidate x 2 schemes)
  4. scheme + direction selection, acceptance gates
  5. polish + 2 revision rounds (each: host consensus-DP batch +
                              host rebuild + re-score DP batch)
  6. k-sweep selection, sequential acceptance replay, chaining, output

Phases 3/5 speculate across ranges: the reference suppresses some
pending ranges after an acceptance (handle_one_read.c:178-188), which
only SKIPS queries, so computing every range up front and replaying the
acceptance order afterwards yields byte-identical output.  With
MTR_WAVES=1 the speculation is wave-pruned instead (see
process_batch): ~99% of suppressible ranges never compute, at the cost
of serializing the later waves against the device leg, hence opt-in
(not yet measured on the GPU).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections import defaultdict

import numpy as np

from mtr.utils.timers import TIMERS

from mtr.config import MTRConfig, DEFAULT_CONFIG
from mtr.records import RepeatRecord, ratio_less
from mtr.io.fasta import iter_fasta, Read
from mtr.chaining import chain_records
from mtr.utils.encoding import encode_bases
from mtr.oracle.arena import Arena
from mtr.oracle.directional_index import fill_directional_index_with_end
from mtr.oracle.dbg import (
    walk_candidates,
    select_dp_candidate,
    MIN_PERIOD,
    MIN_NUM_FREQ_UNIT,
    MAX_PERIOD,
)
from mtr.oracle.wrap_dp import _assign
from mtr.oracle.consensus import polish_repeat

import os as _os


def _env_flag(name: str) -> bool:
    """Boolean env knob: unset, empty, and "0" are all OFF (a plain
    truthiness test would read FLAG=0 as enabled)."""
    return _os.environ.get(name, "") not in ("", "0")


# Jobs per counts-mode chunk.  The XLA engine's row step works on a
# (B, u_pad) plane to the chunk's longest job, so wider units take fewer
# jobs; the CUDA kernel runs one warp per job on its own rows.
B_XLA = {8: 4096, 32: 2048, 64: 2048, 128: 1024, 256: 512, 512: 256}
B_CUDA = 1 << 14


_ENCODE_CACHE: dict = {}


def _encode_unit(s: str) -> np.ndarray:
    """encode_bases with memoization: the same few unit strings appear in
    thousands of DP jobs per batch.  Returned arrays are read-only by
    convention (DP job padding copies out of them)."""
    a = _ENCODE_CACHE.get(s)
    if a is None:
        if len(_ENCODE_CACHE) > 65536:
            _ENCODE_CACHE.clear()
        a = encode_bases(s)
        _ENCODE_CACHE[s] = a
    return a


@functools.lru_cache(maxsize=1)
def _cpu_backend() -> bool:
    import jax

    return jax.default_backend() == "cpu"


_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """JAX's persistent compile cache: where JAX_COMPILATION_CACHE_DIR
    says (JAX reads that variable itself, so nothing else is set),
    otherwise a fixed directory inside the checkout (.gitignore lists
    it; a fixed path keeps cache keys stable across runs)."""
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = _os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def dedup_jobs(jobs: list["DPJob"]) -> tuple[list["DPJob"], list[int]]:
    """Many k values discover the SAME unit for the same range, and the
    DP result depends only on (read segment, unit, scheme, mode) — so
    identical jobs are computed once and fanned out.  Returns the unique
    job list and, per original job, its index into it."""
    uniq: dict = {}
    uniq_jobs: list[DPJob] = []
    remap: list[int] = []
    for job in jobs:
        key = (
            id(job.org), job.qs, job.qe,
            job.unit.tobytes(), job.scheme, job.mode,
        )
        idx = uniq.get(key)
        if idx is None:
            idx = len(uniq_jobs)
            uniq[key] = idx
            uniq_jobs.append(job)
        remap.append(idx)
    return uniq_jobs, remap


@dataclasses.dataclass
class DPJob:
    org: np.ndarray  # effective per-read arena view (codes + stale tail)
    qs: int
    qe: int
    unit: np.ndarray  # int32 unit codes
    scheme: tuple
    mode: str = "counts"  # 'counts' | 'consensus'
    result: object = None


class WrapDPBatcher:
    """Device wrap-DP engine.  Counts-mode jobs run on the platform's
    counts engine (ops/wrap_dp_counts.py) with the batch's reads
    resident on the device; only the small (B, 15) count rows cross
    back.  Consensus-mode (polish) jobs, whose per-column consensus
    tensors have no device engine, run on the host engine."""

    def __init__(self):
        # Freelist of padding buffers per shape.  A buffer is only
        # reused after its chunk's RESULT has materialized (inputs fully
        # consumed): JAX may alias page-aligned numpy args zero-copy on
        # the CPU backend, so refilling a buffer while a prior dispatch
        # is still in flight would corrupt that chunk.
        self._free: dict = defaultdict(list)
        self._seq = 0
        self._flat = None      # device-resident flat reads (int8)
        self._offsets: dict = {}  # id(org) -> offset into flat
        self.mesh = None       # set by ShardedWrapDPBatcher

    def _engine(self) -> str:
        from mtr.ops.wrap_dp_counts import default_engine, engine_for

        if self.mesh is not None:
            return engine_for(self.mesh.devices.flat[0].platform)
        return default_engine()

    def _fn(self, engine: str, b_pad: int, u_pad: int, r_pad: int):
        """Counts kernel for a chunk shape; sharded over self.mesh's
        'dp' axis when a mesh is attached."""
        if self.mesh is not None:
            from mtr.parallel.mesh import sharded_counts_fn

            return sharded_counts_fn(self.mesh, engine, b_pad, u_pad, r_pad)
        from mtr.ops.wrap_dp_counts import counts_fn

        return counts_fn(engine, b_pad, u_pad, r_pad)

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        """Upload the batch's read arrays once; chunks then address
        their rep segments by offset instead of shipping them."""
        import jax

        from mtr import native
        from mtr.ops.wrap_dp_counts import R_BUCKETS

        total = sum(len(o) for o in orgs)
        # trailing slack >= the largest r bucket so the XLA engine's
        # dynamic_slice never clamps; power-of-two total length bounds
        # distinct jit traces
        need = total + R_BUCKETS[-1]
        pad = 1 << max(20, (need - 1).bit_length())
        # double-buffered: the previous batch's device_put is async and
        # its source must not be refilled while potentially in flight
        self._seq += 1
        flat = native.POOL.get(
            f"resident_flat_{self._seq % 2}", (pad,), np.int8)
        off: dict = {}
        p = 0
        for o in orgs:
            flat[p : p + len(o)] = o
            off[id(o)] = p
            p += len(o)
        self._offsets = off
        self._flat = jax.device_put(flat)  # async

    def _acquire_resident(self, b_pad, u_pad):
        """[units int8, scal int32, starts int32, dirty_rows].  Fresh
        buffers come pre-set to the padding-row defaults; reused ones
        re-clean only the rows the previous dispatch wrote
        (dirty_rows), so a mostly-empty buffer costs no full memset."""
        from mtr import native

        lst = self._free[(b_pad, u_pad)]
        if lst:
            buf = lst.pop()
            units, scal, starts, dirty = buf
            units[:dirty].fill(-2)
            units[:dirty, :2] = 0
            scal[:dirty].fill(0)
            scal[:dirty, 1] = 2
            scal[:dirty, 2:5] = 1
            starts[:dirty] = 0
            return buf
        self._seq += 1
        s = self._seq
        units = native.POOL.get(
            f"res_units_{b_pad}x{u_pad}_{s}", (b_pad, u_pad), np.int8)
        scal = native.POOL.get(f"res_scal_{b_pad}_{s}", (b_pad, 8), np.int32)
        starts = native.POOL.get(f"res_starts_{b_pad}_{s}", (b_pad,), np.int32)
        units.fill(-2)
        units[:, :2] = 0
        scal.fill(0)
        scal[:, 1] = 2
        scal[:, 2:5] = 1
        starts.fill(0)
        return [units, scal, starts, 0]

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        uniq_jobs, remap = (jobs, None) if deduped else dedup_jobs(jobs)
        cons = [j for j in uniq_jobs if j.mode == "consensus"]
        if cons:
            HostDPBatcher()._run(cons)
        self._run([j for j in uniq_jobs if j.mode != "consensus"])
        if remap is not None and len(uniq_jobs) != len(jobs):
            # results live on the job objects; remap indexes the intact
            # uniq_jobs list
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result

    def _run(self, jobs: list[DPJob]) -> None:
        """Counts-mode jobs: group by (u_pad, r_pad), dispatch every
        chunk asynchronously, then collect."""
        from mtr.ops.wrap_dp_counts import U_BUCKETS, bucket, row_bucket

        if not jobs:
            return
        if self._flat is None or any(
                id(j.org) not in self._offsets for j in jobs):
            # callers register each batch's reads via begin_batch;
            # direct callers get their jobs' reads registered here
            self.begin_batch(list({id(j.org): j.org for j in jobs}.values()))
        engine = self._engine()
        groups: dict[tuple[int, int], list[int]] = defaultdict(list)
        for idx, job in enumerate(jobs):
            u_pad = bucket(len(job.unit), U_BUCKETS)
            r_pad = row_bucket(engine, job.qe - job.qs + 1)
            groups[(u_pad, r_pad)].append(idx)

        pending = []
        for (u_pad, r_pad), idxs in sorted(groups.items()):
            # longest-first ordering keeps chunks rep_len homogeneous
            idxs.sort(key=lambda i: jobs[i].qs - jobs[i].qe)
            cap = B_CUDA if engine == "cuda" else B_XLA[u_pad]
            chunk: list[int] = []
            chunk_max_rl = 0
            for i in idxs:
                rl = jobs[i].qe - jobs[i].qs + 1
                # the XLA engine pays b_pad x the chunk's longest job,
                # so a cut must save thousands of rows; the CUDA
                # kernel's warps run their own rows and never cut
                if chunk and (
                    len(chunk) >= cap
                    or (engine == "xla" and rl * 4 < chunk_max_rl
                        and chunk_max_rl - rl > 4096 and len(chunk) >= 32)
                ):
                    pending.append(self._dispatch(
                        engine, jobs, chunk, u_pad, r_pad, cap))
                    chunk = []
                if not chunk:
                    chunk_max_rl = rl
                chunk.append(i)
            if chunk:
                # dispatch is async: later chunks' host-side padding
                # overlaps earlier chunks' device execution
                pending.append(self._dispatch(
                    engine, jobs, chunk, u_pad, r_pad, cap))
        for item in pending:
            item[1].copy_to_host_async()
        for item in pending:
            self._collect(jobs, *item)

    def _dispatch(self, engine, jobs, chunk, u_pad, r_pad, cap):
        """One counts chunk: power-of-two batch (bounds the number of
        compiled shapes), rows filled from the jobs, reads addressed by
        offset into the resident flat array."""
        n = len(chunk)
        b_pad = min(cap, max(8, 1 << (n - 1).bit_length()))
        if self.mesh is not None:
            n_dev = int(self.mesh.devices.size)
            b_pad = -(-max(b_pad, n_dev) // n_dev) * n_dev  # equal shards
        buffers = self._acquire_resident(b_pad, u_pad)
        units, scal, starts = buffers[:3]
        buffers[3] = n  # dirty rows for the next reuse
        # vectorized row fill: python-per-job only for attribute
        # extraction; unit payloads write once per distinct unit
        qs_a = np.fromiter((jobs[i].qs for i in chunk), np.int64, n)
        qe_a = np.fromiter((jobs[i].qe for i in chunk), np.int64, n)
        off_a = np.fromiter(
            (self._offsets[id(jobs[i].org)] for i in chunk), np.int64, n)
        starts[:n] = off_a + qs_a + 1
        scal[:n, 0] = qe_a - qs_a + 1
        scal[:n, 2:5] = [jobs[i].scheme for i in chunk]
        by_unit: dict = defaultdict(list)
        for row, idx in enumerate(chunk):
            by_unit[jobs[idx].unit.tobytes()].append(row)
        ulen = np.empty(n, np.int32)
        for rows in by_unit.values():
            unit = jobs[chunk[rows[0]]].unit
            units[np.asarray(rows), : len(unit)] = unit
            ulen[rows] = len(unit)
        scal[:n, 1] = ulen
        with TIMERS.section("dp_dispatch"):
            res = self._fn(engine, b_pad, u_pad, r_pad)(
                self._flat, starts, scal, units)
        TIMERS.count("dp_jobs", n)
        TIMERS.count("dp_chunks")
        return (chunk, res, (b_pad, u_pad), buffers)

    def _collect(self, jobs, chunk, res, shape_key, buffers) -> None:
        # the blocked device->host wait, split from dispatch so the -c
        # stage summary attributes device time unambiguously
        # (reference timer granularity: main.c:108-121)
        with TIMERS.section("dp_wait"):
            rows = np.asarray(res)[: len(chunk)]
        # result materialized => the dispatch consumed its inputs; the
        # padding buffers may now be reused by a later chunk
        self._free[shape_key].append(buffers)
        assert rows[:, 6].all(), "wrap-DP engine left a job unfinished"
        for idx, r in zip(chunk, rows.tolist()):
            m, x, ins, dele, scanned, i_final = r[:6]
            jobs[idx].result = ((m, x, ins, dele, scanned), i_final, r[9])


class ShardedWrapDPBatcher(WrapDPBatcher):
    """WrapDPBatcher whose counts kernels run under shard_map over a
    device mesh: every chunk's job batch is split evenly across the
    mesh's 'dp' axis (SURVEY.md 2.13 — reads/queries are the
    embarrassingly parallel axis), the flat read array is replicated,
    and each device runs the same engine on its local shard.  Results
    concatenate back on the batch axis, so outputs are bit-identical to
    the single-device batcher."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh


class HostDPBatcher:
    """Native C++ wrap-DP engine (threaded AVX-512 / scalar fills) with
    the same job interface as WrapDPBatcher: the engine without an
    accelerator, the hybrid engine's host leg, and every polish job."""

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        pass  # host engine reads segments in place

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        if deduped:
            self._run(jobs)
            return
        uniq_jobs, remap = dedup_jobs(jobs)
        self._run(uniq_jobs)
        if len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result

    def _run(self, jobs: list[DPJob]) -> None:
        from mtr import native

        if not jobs:
            return
        if not native.available():
            # dependency-free degrade: exact oracle DP per job.  Slow,
            # but a checkout whose native build failed (no compiler)
            # must still "just work" like the reference CLI (main.c:48)
            self._run_oracle(jobs)
            return
        n = len(jobs)
        # pooled: the C side reads only units[q, :ulens[q]], so stale data
        # beyond each unit is never seen
        units = native.POOL.get("dpb_units", (n, 500), np.int32)
        ulens = np.zeros(n, np.int32)
        schemes = np.zeros((n, 3), np.int32)
        modes = np.zeros(n, np.int32)
        orgs, qss, qes = [], [], []
        for q, job in enumerate(jobs):
            units[q, : len(job.unit)] = job.unit
            ulens[q] = len(job.unit)
            schemes[q] = job.scheme
            modes[q] = 0 if job.mode == "counts" else 1
            orgs.append(np.ascontiguousarray(job.org, np.int32))
            qss.append(job.qs)
            qes.append(job.qe)
        with TIMERS.section("dp_fill"):
            res = native.wrap_dp_batch(orgs, qss, qes, units, ulens, schemes, modes)
        if res is None:
            self._run_oracle(jobs)
            return
        counts, cons, miss = res
        TIMERS.count("dp_jobs", n)
        clist = counts[:n].tolist()  # one C-level conversion for all rows
        for q, job in enumerate(jobs):
            if job.mode == "counts":
                m, x, ins, dele, scanned, i_final, max_i = clist[q]
                job.result = ((m, x, ins, dele, scanned), i_final, max_i)
            else:
                job.result = (cons[q], miss[q])


    def _run_oracle(self, jobs: list[DPJob]) -> None:
        """Pure-Python engine (oracle wrap_dp_fill + traceback,
        wrap_around_DP.c:222-354): byte-identical to the native/device
        engines, used only when libmtr_host.so cannot be built."""
        from mtr.oracle.wrap_dp import traceback, wrap_dp_fill

        with TIMERS.section("dp_fill"):
            for job in jobs:
                rep_len = job.qe - job.qs + 1
                rep = job.org[job.qs + 1 : job.qs + 1 + rep_len]
                mg, mp, ip = job.scheme
                D, max_wrd, max_i, max_j = wrap_dp_fill(
                    rep, job.unit, mg, mp, ip)
                path, i_final = traceback(
                    D, max_wrd, max_i, max_j, rep, job.unit, mg, mp, ip)
                if job.mode == "counts":
                    n_m = n_x = n_i = n_d = 0
                    for mv, _, _ in path:
                        if mv == "M":
                            n_m += 1
                        elif mv == "X":
                            n_x += 1
                        elif mv == "I":
                            n_i += 1
                        else:
                            n_d += 1
                    job.result = (
                        (n_m, n_x, n_i, n_d, n_m + n_x + n_d),
                        i_final, max_i,
                    )
                else:
                    cons = np.zeros((501, 5), np.int64)
                    miss = np.zeros((501, 4), np.int64)
                    for mv, i, j in path:
                        if mv in ("M", "X"):
                            cons[j][rep[i - 1]] += 1
                        elif mv == "D":
                            cons[j][4] += 1
                        else:
                            miss[j][rep[i - 1]] += 1
                    job.result = (cons, miss)
        TIMERS.count("dp_jobs", len(jobs))


class HybridDPBatcher:
    """Big counts-mode DP jobs go to the device engine, small ones and
    every polish (consensus-mode) job to the native host engine, the two
    legs overlapped: the device chunks execute asynchronously while the
    host threads work through the rest.  Every engine is bit-exact, so
    the split is pure scheduling.  A device failure raises."""

    def __init__(self, cell_threshold: int | None = None):
        self.device = WrapDPBatcher()
        self.host = HostDPBatcher()
        if cell_threshold is None:
            # resident feeding leaves the device a ~fixed cost per
            # dispatch, so jobs of >= 256k cells go there
            env_cells = _os.environ.get("MTR_HYBRID_CELLS")
            if env_cells is not None:
                cell_threshold = int(env_cells)  # explicit override wins
            else:
                cell_threshold = 1 << 18
                from mtr import native

                if not native.available():
                    # no native host leg: its oracle fallback is orders
                    # of magnitude slower than a device dispatch, so ship
                    # every counts job to the device
                    cell_threshold = 0
        self.cell_threshold = cell_threshold
        self.dev_idle_s = 0.0
        self._batch_orgs = None

    def pop_dev_idle(self) -> float:
        """Host-idle-waiting-on-device seconds since the last call."""
        v = self.dev_idle_s
        self.dev_idle_s = 0.0
        return v

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        # DEFERRED: the flat upload only happens once a device-bound
        # job set materializes, and then on the device thread — on
        # short-read workloads whose jobs all stay under the floor the
        # upload would be a pure tax on the critical path
        self._batch_orgs = orgs

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        import threading

        uniq_jobs, remap = (
            (jobs, None) if deduped else dedup_jobs(jobs))

        # counts-mode cells; polish jobs (-1) always stay on the host
        cells = [
            (j.qe - j.qs + 1) * len(j.unit) if j.mode == "counts" else -1
            for j in uniq_jobs
        ]
        thr = self.cell_threshold
        counts_cells = [c for c in cells if c >= 0]
        if counts_cells and max(counts_cells) < thr:
            # small-job workloads (e.g. 3 kb reads: biggest jobs ~100 k
            # cells) would otherwise never touch the device; only the
            # larger of their jobs can amortize a dispatch
            thr = max(thr >> 4, 1 << 14)
        to_dev = [c >= 0 and c >= thr for c in cells]
        big = [j for j, d in zip(uniq_jobs, to_dev) if d]
        small = [j for j, d in zip(uniq_jobs, to_dev) if not d]
        if big:
            # engagement gate: a device round costs a ~fixed dispatch +
            # pull latency whatever it carries, so engage only when the
            # shipped cells could plausibly amortize it
            dev_cells = sum((j.qe - j.qs + 1) * len(j.unit) for j in big)
            if dev_cells < int(_os.environ.get(
                    "MTR_MIN_DEVICE_CELLS", str(1 << 26))):
                small.extend(big)
                big = []
        if big:
            err: list = []

            def dev_run():
                try:
                    if self._batch_orgs is not None:
                        self.device.begin_batch(self._batch_orgs)
                        self._batch_orgs = None
                    self.device._run(big)
                except BaseException as e:  # re-raised on the caller thread
                    err.append(e)

            t = threading.Thread(target=dev_run)
            t.start()
            try:
                self.host._run(small)
            finally:
                t_host_done = time.time()
                t.join()
            # host-idle time spent waiting on the device leg: the
            # adaptive wave policy compares it to walk wall time
            self.dev_idle_s += time.time() - t_host_done
            if err:
                raise err[0]
        else:
            self.host._run(small)
        if remap is not None and len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result


def make_batcher(cfg: MTRConfig):
    """Pick the DP engine.  `auto` is the hybrid engine when JAX has an
    accelerator, and otherwise the native host engine (or the device
    batcher on XLA's CPU backend when the native library is
    unavailable: far faster than the oracle)."""
    if cfg.backend == "device":
        return WrapDPBatcher()
    if cfg.backend == "host":
        return HostDPBatcher()
    if cfg.backend == "hybrid":
        return HybridDPBatcher()
    import jax

    if jax.default_backend() != "cpu":
        return HybridDPBatcher()
    from mtr import native

    return HostDPBatcher() if native.available() else WrapDPBatcher()


def apply_counts(rr: RepeatRecord, job: DPJob) -> None:
    """Fill record fields from a counts-mode DP result
    (wrap_around_DP.c:337-350)."""
    (n_m, n_x, n_i, n_d, scanned), i_final, max_i = job.result
    rr.rep_start = job.qs + i_final + 1
    rr.rep_end = job.qs + max_i
    rr.repeat_len = max_i - i_final
    rr.num_freq_unit = scanned // len(job.unit) if len(job.unit) else 0
    rr.num_matches = n_m
    rr.num_mismatches = n_x
    rr.num_insertions = n_i
    rr.num_deletions = n_d
    rr.match_gain, rr.mismatch_penalty, rr.indel_penalty = job.scheme


@dataclasses.dataclass
class RangeQuery:
    read_idx: int
    qs: int
    qe: int
    w: int
    k: int
    candidates: list = dataclasses.field(default_factory=list)
    found: int = 0
    result: RepeatRecord | None = None  # post-selection record (or cleared)


@dataclasses.dataclass
class ReadState:
    read: Read
    org: np.ndarray  # effective arena view, length L+1
    di: np.ndarray
    di_end: np.ndarray
    di_w: np.ndarray
    ridx: int = -1   # file-order read index (multi-host merge key)


def _wrap_dp_schemes(batcher, queries_with_candidates) -> None:
    """Phase 3+4a: batched wrap_around_DP (both schemes) for every walk
    candidate; per candidate keep the higher-ratio scheme
    (wrap_around_DP.c:357-429).

    Candidates are deduplicated by (read, range, unit) BEFORE job
    construction — different k values routinely discover the same unit,
    and the DP + scheme selection depend only on this key — so each
    unique candidate builds one job pair and runs one selection."""
    dpjobs: list[DPJob] = []
    uniq: dict = {}           # key -> index into selections
    sel_jobs: list = []       # per unique key: (job113, job131)
    meta: list = []           # per candidate: (cand, uniq_idx)
    for q, org_arr in queries_with_candidates:
        for cand in q.candidates:
            unit = _encode_unit(cand.string)
            key = (id(org_arr), q.qs, q.qe, cand.string)
            ui = uniq.get(key)
            if ui is None:
                ui = len(sel_jobs)
                uniq[key] = ui
                j113 = DPJob(org_arr, q.qs, q.qe, unit, (1, 1, 3))
                j131 = DPJob(org_arr, q.qs, q.qe, unit, (1, 3, 1))
                dpjobs.append(j113)
                dpjobs.append(j131)
                sel_jobs.append((j113, j131))
            meta.append((cand, ui))
    # dpjobs is already unique under the batcher's dedup key (one job
    # pair per (org, range, unit); schemes differ within a pair)
    batcher.run(dpjobs, deduped=True)
    # one scheme selection per unique candidate, vectorized: the scalar
    # loop's semantics (wrap_around_DP.c:357-429 via ratio_less) reduce
    # to: take (1,3,1) iff its ratio is non-NaN and either (1,1,3)'s is
    # NaN or strictly smaller; else (1,1,3) if non-NaN; else neither.
    n_sel = len(sel_jobs)
    if n_sel:
        cnt = np.empty((2 * n_sel, 2), np.int64)
        for idx, job in enumerate(dpjobs):
            (n_m, n_x, n_i, n_d, _scanned), _, _ = job.result
            cnt[idx, 0] = n_m
            cnt[idx, 1] = n_m + n_x + n_i + n_d
        with np.errstate(invalid="ignore"):
            # denom == 0 implies m == 0 (counts are nonnegative), so the
            # only singular case is 0/0 -> NaN, exactly C float math
            r = cnt[:, 0].astype(np.float32) / cnt[:, 1].astype(np.float32)
        r113, r131 = r[0::2], r[1::2]
        nan113, nan131 = np.isnan(r113), np.isnan(r131)
        pick131 = ~nan131 & (nan113 | (r131 > r113))
        pick113 = ~pick131 & ~nan113
        rs = r.astype(np.float64)
        ms = cnt[:, 0].tolist()
        ds = cnt[:, 1].tolist()
    empty = RepeatRecord()
    for cand, ui in meta:
        if pick131[ui]:
            best_job, ji = sel_jobs[ui][1], 2 * ui + 1
        elif pick113[ui]:
            best_job, ji = sel_jobs[ui][0], 2 * ui
        else:
            _assign(cand, empty)
            continue
        # apply_counts touches exactly the fields set_rr would copy
        # from a counts-updated clone, so write cand directly
        apply_counts(cand, best_job)
        cand._rk = (ds[ji], ms[ji], float(rs[ji]))  # pre-fill ratio cache


def _polish_phase(batcher, states, polish_set, cfg) -> None:
    """Phase 5: polish_repeat then two revision rounds, batched.

    Each item of polish_set is (query, record); records are revised in
    place.  Mirrors revise_representative_unit (consensus.c:1048-1087):
    both rounds compare against the PRE-revision ratio."""
    if not polish_set:
        return
    items = []
    for q, rr in polish_set:
        org = states[q.read_idx].org
        input_len = states[q.read_idx].read.length
        polish_repeat(org, input_len, rr)
        items.append((q, rr, rr.match_ratio()))

    for scheme in ((5, 1, 1), (1, 1, 3)):
        # consensus DP on current units
        consjobs = []
        tmps = []
        for q, rr, base_ratio in items:
            org = states[q.read_idx].org
            tmp = rr.copy()
            tmp.match_gain, tmp.mismatch_penalty, tmp.indel_penalty = scheme
            consjobs.append(
                DPJob(org, tmp.rep_start, tmp.rep_end, _encode_unit(tmp.string),
                      scheme, mode="consensus")
            )
            tmps.append(tmp)
        batcher.run(consjobs)
        # host rebuild (batched argmax), then re-score the revised units
        from mtr.oracle.consensus import rebuild_units_batch

        rebuild_units_batch(tmps, [job.result for job in consjobs])
        scorejobs = []
        score_meta = []
        for (q, rr, base_ratio), tmp, job in zip(items, tmps, consjobs):
            if tmp.rep_period < MAX_PERIOD:
                org = states[q.read_idx].org
                sj = DPJob(org, tmp.rep_start, tmp.rep_end,
                           _encode_unit(tmp.string), scheme)
                scorejobs.append(sj)
                score_meta.append(((q, rr, base_ratio), tmp, sj))
        batcher.run(scorejobs)
        for (q, rr, base_ratio), tmp, sj in score_meta:
            apply_counts(tmp, sj)
            if ratio_less(base_ratio, tmp.match_ratio()):
                _assign(rr, tmp)


def _live_positions(st) -> np.ndarray:
    """Candidate-range start positions of a read (collection-time live
    set: di_end in [0, L) — handle_one_read.c:227-246)."""
    L = st.read.length
    return np.nonzero((st.di_end > -1) & (st.di_end < L))[0]


def waves_enabled(force=None) -> bool:
    """Wave-pruning switch: MTR_WAVES=1 forces on, MTR_NO_WAVES
    forces off; otherwise `force` (the adaptive policy's verdict)
    decides, defaulting to off."""
    if _env_flag("MTR_NO_WAVES"):
        return False
    if _env_flag("MTR_WAVES"):
        return True
    return bool(force)


def waves_policy(walk_s: float | None, dev_idle_s: float | None) -> bool:
    """Adaptive wave pruning: full speculation hides
    ALL walk work behind the device leg, so pruning only pays when the
    walk queue is the scarce resource — i.e. the previous batch spent
    clearly more wall time walking than it spent idle-waiting on the
    device."""
    if walk_s is None or dev_idle_s is None:
        return False
    return walk_s > 2.0 * dev_idle_s + 0.2


def wave1_positions(states, cfg=None, force=None):
    """Wave-1 selection for suppression pruning: the positions that NO
    earlier range can ever suppress.  A range q < p can only suppress p
    when its accepted repeat reaches past p's end (rep_end > qe_p with
    rep_end <= qe_q — handle_one_read.c:178-188), so p is safe iff the
    running max of earlier ends <= qe_p.

    Default OFF (every position becomes wave 1): pruning cuts total
    work 20%+ on repeat-dense sets, but on the hybrid engine the wave-2
    walks serialize against the device leg that full speculation
    overlaps.  MTR_WAVES=1 enables pruning — the right trade when walk
    CPU is the scarce resource."""
    sel = []
    waves = waves_enabled(force)
    for st in states:
        pos = _live_positions(st)
        if not waves or not len(pos):
            sel.append(pos)
            continue
        qe = st.di_end[pos].astype(np.int64)
        runmax = np.maximum.accumulate(qe)
        excl = np.empty_like(runmax)
        excl[0] = -1
        excl[1:] = runmax[:-1]
        # strict <: an equal-end earlier range CAN still suppress p
        # (rep_end = qs + max_i may reach qe_q + 1, so rep_end > qe_p
        # is possible when qe_q == qe_p); keeping such positions out of
        # wave 1 preserves the "no earlier range can suppress" invariant
        sel.append(pos[excl < qe])
    return sel


def _collect_queries(states, cfg, pos_sel=None):
    """Phase 2a: flat (read_idx, qs, qe, w, k) arrays for every candidate
    range x k, built with vectorized repeats (the k sweep is a function
    of w only — config.k_sweep / handle_one_read.c:104-118).  RangeQuery
    objects are only materialized for the few % of queries whose walk
    finds a unit.  pos_sel optionally restricts each read to an explicit
    position subset (wave pruning)."""
    lo_small = cfg.min_kmer - 3
    lo_big = cfg.min_kmer
    hi_small = cfg.max_kmer - 5
    hi_mid = cfg.max_kmer - 3
    hi_big = cfg.max_kmer
    chunks = []
    for ridx, st in enumerate(states):
        pos = (_live_positions(st) if pos_sel is None else pos_sel[ridx])
        if not len(pos):
            continue
        qe = st.di_end[pos].astype(np.int64)
        w = st.di_w[pos].astype(np.int64)
        k_lo = np.where(w < 1000, lo_small, lo_big)
        k_hi = np.where(w < 100, hi_small, np.where(w < 1000, hi_mid, hi_big))
        counts = k_hi - k_lo + 1
        total = int(counts.sum())
        # per-segment aranges: offset within each range's k run
        seg_start = np.repeat(np.cumsum(counts) - counts, counts)
        ks = np.repeat(k_lo, counts) + (np.arange(total) - seg_start)
        chunks.append((
            np.full(total, ridx, np.int32),
            np.repeat(pos, counts).astype(np.int32),
            np.repeat(qe, counts).astype(np.int32),
            np.repeat(w, counts).astype(np.int32),
            ks.astype(np.int32),
        ))
    if not chunks:
        z = np.zeros(0, np.int32)
        return z, z, z, z, z
    return tuple(np.concatenate([c[i] for c in chunks]) for i in range(5))


def walk_batch(states: list[ReadState], cfg: MTRConfig, pos_sel=None):
    """Phase 2 — (range, k) walk queries for a batch (optionally a wave
    subset).  Pure host (or device-walk) work with no DP-batcher
    dependency, so run_file overlaps it with the PREVIOUS batch's device
    DP wait."""
    from mtr import native
    from mtr.oracle.dbg import freq_2mer_array
    from mtr.utils.encoding import decode_bases

    _t_period = time.time()  # walk share of "Computing periods"

    ridx_a, qs_a, qe_a, w_a, k_a = _collect_queries(states, cfg, pos_sel)
    n_q = len(ridx_a)
    queries: list[RangeQuery] = []  # materialized for walk hits only

    _t_walk = time.time()
    use_dev_walks = (
        cfg.backend == "device" and cfg.use_device_walks and n_q > 0
    )
    if use_dev_walks or (cfg.use_native and native.available() and n_q):
        if use_dev_walks:
            from mtr.ops.dbg_device import dbg_walk_device_batch

            res = dbg_walk_device_batch(
                [st.org for st in states],
                [st.read.length for st in states],
                ridx_a, qs_a, qe_a, k_a,
            )
        else:
            orgs = [st.org for st in states]
            lens = [st.read.length for st in states]
            sub = None
            if (cfg.backend == "hybrid" and n_q >= 32768
                    and not _cpu_backend()
                    and _env_flag("MTR_MF_FILTER")):
                # device pre-filter: the walk gate max_freq >
                # MIN_NUM_FREQ_UNIT is pure dense counting — one device
                # dispatch per V-bucket classifies every query exactly,
                # so the host builds tables only for queries that walk
                # (ops/mf_filter.py; gate: consensus.c:532).  Opt-in:
                # not yet measured against the host build with the
                # ascending-k early-out
                from mtr.ops.mf_filter import walked_mask

                sub = np.nonzero(walked_mask(
                    orgs, lens, ridx_a, qs_a, qe_a, k_a))[0]
            if sub is not None and len(sub) < n_q:
                r = native.dbg_walk_batch2(
                    orgs, lens, ridx_a[sub], qs_a[sub], qe_a[sub],
                    k_a[sub])
                res = {
                    "fwd_row": np.full(n_q, -1, np.int32),
                    "bwd_row": np.full(n_q, -1, np.int32),
                    "fwd_period": np.zeros(n_q, np.int32),
                    "bwd_period": np.zeros(n_q, np.int32),
                    "found_last": np.zeros(n_q, np.int32),
                    "units": r["units"],
                    "scores": r["scores"],
                }
                for key in ("fwd_row", "bwd_row", "fwd_period",
                            "bwd_period", "found_last"):
                    res[key][sub] = r[key][: len(sub)]
            else:
                res = native.dbg_walk_batch2(
                    orgs, lens, ridx_a, qs_a, qe_a, k_a)
        frow, brow = res["fwd_row"], res["bwd_row"]
        units_rows, scores_rows = res["units"], res["scores"]
        unit_cache: dict = {}  # unit bytes -> (string, freq_2mer)
        hits = np.nonzero((frow[:n_q] >= 0) | (brow[:n_q] >= 0))[0]
        # bulk int conversion: per-element np scalar indexing costs ~1 us
        # a pop over tens of thousands of hit queries
        h_ridx = ridx_a[hits].tolist()
        h_qs = qs_a[hits].tolist()
        h_qe = qe_a[hits].tolist()
        h_w = w_a[hits].tolist()
        h_k = k_a[hits].tolist()
        h_f = frow[hits].tolist()
        h_b = brow[hits].tolist()
        h_fp = res["fwd_period"][hits].tolist()
        h_bp = res["bwd_period"][hits].tolist()
        h_found = res["found_last"][hits].tolist()
        cand_proto = RepeatRecord().__dict__
        for hi in range(len(hits)):
            ridx = h_ridx[hi]
            st = states[ridx]
            q = RangeQuery(ridx, h_qs[hi], h_qe[hi], h_w[hi], h_k[hi])
            q.found = h_found[hi]
            for row, period in ((h_f[hi], h_fp[hi]), (h_b[hi], h_bp[hi])):
                if row < 0:
                    continue
                ukey = units_rows[row][:period].tobytes()
                ent = unit_cache.get(ukey)
                if ent is None:
                    unit = units_rows[row][:period].tolist()
                    ent = (decode_bases(unit), freq_2mer_array(unit))
                    unit_cache[ukey] = ent
                cand = RepeatRecord.__new__(RepeatRecord)
                cand.__dict__.update(cand_proto)
                cand.read_id = st.read.read_id
                cand.input_len = st.read.length
                cand.kmer = q.k
                cand.rep_period = period
                cand.string = ent[0]
                # ndarray copy, not tolist(): ~10x cheaper per candidate
                # (all consumers index it; RepeatRecord.copy() listifies)
                cand.string_score = scores_rows[row][:period].copy()
                cand.freq_2mer = list(ent[1])
                q.candidates.append(cand)
            queries.append(q)
    else:
        for i in range(n_q):
            ridx = int(ridx_a[i])
            st = states[ridx]
            q = RangeQuery(ridx, int(qs_a[i]), int(qe_a[i]), int(w_a[i]), int(k_a[i]))
            template = RepeatRecord()
            template.read_id = st.read.read_id
            template.input_len = st.read.length
            template.kmer = q.k
            q.candidates, q.found = walk_candidates(
                st.org, st.read.length, q.qs, q.qe, template
            )
            if q.candidates:
                queries.append(q)

    TIMERS.add("walks", time.time() - _t_walk)
    if native.available():
        # real measured init_inputString / count-table sections from the
        # walk engine (zeros unless -c enabled them)
        init_s, count_s, _walk_s = native.read_stage_timers()
        TIMERS.add("initialize", init_s)
        TIMERS.add("count_table", count_s)
    TIMERS.count("speculative_queries", n_q)
    TIMERS.add("period", time.time() - _t_period)
    return queries


def _accepts(rr: RepeatRecord | None) -> bool:
    """Acceptance gate of handle_one_read.c:239-240."""
    return (
        rr is not None
        and rr.repeat_len > 0
        and rr.rep_start + MIN_PERIOD * MIN_NUM_FREQ_UNIT < rr.rep_end
    )


def _process_wave(states, batcher, cfg, queries, range_result) -> None:
    """Phases 3-6a for one wave of walk queries: batched DP scheme
    selection, acceptance gates, polish/revision rounds, k-sweep
    selection.  Merges per-range winners into range_result (keyed
    (read_idx, qs, qe); value None = computed but no qualifying
    record)."""
    # phase 3+4a: scheme selection for every candidate
    _wrap_dp_schemes(batcher, [(q, states[q.read_idx].org) for q in queries])

    # phase 4b: direction selection + gates -> per-query result; build
    # polish set (queries without candidates were never materialized =
    # cleared records)
    polish_set = []
    for q in queries:
        if not q.candidates or q.found == 0:
            q.result = None
            continue
        st = states[q.read_idx]
        rr = RepeatRecord()
        rr.read_id = st.read.read_id
        rr.input_len = st.read.length
        rr.kmer = q.k
        select_dp_candidate(rr, q.candidates, cfg.min_match_ratio)
        if rr.rep_period * (q.qe - q.qs + 1) > cfg.wrap_dp_size:
            q.result = None
            continue
        q.result = rr
        coverage = rr.repeat_len // rr.rep_period
        if 5 <= coverage <= 20 and rr.rep_period > 5:
            polish_set.append((q, rr))

    # phase 5: polish + revision rounds
    with TIMERS.section("polish"):
        _polish_phase(batcher, states, polish_set, cfg)

    # phase 6a: k-sweep selection per range
    by_range: dict[tuple[int, int, int], list[RangeQuery]] = defaultdict(list)
    for q in queries:
        by_range[(q.read_idx, q.qs, q.qe)].append(q)
    for key, qs_list in by_range.items():
        best = None
        max_ratio = -1.0
        for q in sorted(qs_list, key=lambda x: x.k):
            tmp = q.result
            if tmp is None:
                continue  # cleared records never pass the filters below
            r = tmp.match_ratio()
            if (
                ratio_less(max_ratio, r)
                and cfg.min_match_ratio <= r
                and tmp.num_freq_unit > MIN_NUM_FREQ_UNIT
                and MIN_PERIOD <= tmp.rep_period
            ):
                max_ratio = r
                best = tmp
        range_result[key] = best


MAX_WAVES = 6


def process_batch(states: list[ReadState], batcher: WrapDPBatcher,
                  cfg: MTRConfig, queries: list[RangeQuery] | None = None,
                  pos_sel=None):
    """Wave-pruned batch processing.

    The reference suppresses pending ranges after each acceptance
    (handle_one_read.c:178-188) and never computes their queries; the
    round-3 pipeline speculatively computed EVERY range and replayed the
    acceptance order afterwards — byte-identical but ~22% dead walk/DP
    work on repeat-dense reads.  Waves recover most of the skips while
    keeping device batches large:

      wave 1: positions no earlier range can ever suppress (the running
              max of earlier ends <= own end) — computable up front, so
              run_file's overlap thread can pre-walk them;
      replay: advance each read's acceptance cursor through computed or
              killed positions, applying the reference's kills exactly;
      wave k: positions an optimistic simulation (kills from all
              computed acceptances, uncomputed positions assumed
              non-accepting) leaves alive.  A misprediction only costs
              a later wave — every computation is pure, and the replay
              consumes results strictly in position order, so output
              equality is unconditional.
    """
    # register the batch's reads with the device engine (resident
    # feeding): uploaded once, gathered per chunk on device
    batcher.begin_batch([st.org for st in states])

    _t0 = time.time()  # DP share of "Computing periods" (main.c:113)
    _t_walks = 0.0     # inner walk_batch calls self-report their time

    all_pos = [_live_positions(st) for st in states]
    for p in all_pos:
        TIMERS.count("ranges_total", len(p))
    computed = [np.zeros(len(st.di_end), bool) for st in states]
    if queries is None:
        pos_sel = wave1_positions(states, cfg)
        _tw = time.time()
        queries = walk_batch(states, cfg, pos_sel)
        _t_walks += time.time() - _tw
    elif pos_sel is None:
        pos_sel = all_pos  # legacy callers pre-walk every position

    range_result: dict[tuple[int, int, int], RepeatRecord | None] = {}
    cursor = [0] * len(states)
    accepted: list[list[RepeatRecord]] = [[] for _ in states]
    nq = [0] * len(states)
    wave = 0
    while True:
        wave += 1
        for ridx, ps in enumerate(pos_sel):
            if len(ps):
                computed[ridx][ps] = True
                TIMERS.count("computed_ranges", len(ps))
        _process_wave(states, batcher, cfg, queries, range_result)

        # exact replay: advance cursors, apply kills to the live arrays
        alldone = True
        for ridx, st in enumerate(states):
            di, di_end, di_w = st.di, st.di_end, st.di_w
            pos = all_pos[ridx]
            c = cursor[ridx]
            comp = computed[ridx]
            while c < len(pos):
                p = int(pos[c])
                qe = int(di_end[p])
                if qe < 0:
                    # suppressed before its turn: if never computed, its
                    # walks + DP were skipped exactly as the reference
                    # skips them
                    TIMERS.count("suppressed_ranges")
                    if not comp[p]:
                        TIMERS.count("pruned_ranges")
                    c += 1
                    continue
                if not comp[p]:
                    break  # a later wave must compute this position
                nq[ridx] += 1  # reference query_counter: per live range
                rr = range_result.get((ridx, p, qe))
                if _accepts(rr):
                    accepted[ridx].append(rr)
                    span = np.arange(rr.rep_start, rr.rep_end)
                    kill = span[(di[span] != -1) & (di_end[span] < rr.rep_end)]
                    di[kill] = -1.0
                    di_end[kill] = -1
                    di_w[kill] = -1
                c += 1
            cursor[ridx] = c
            if c < len(pos):
                alldone = False
        if alldone:
            break

        # next wave: optimistic simulation from each cursor
        pos_sel = []
        n_new = 0
        for ridx, st in enumerate(states):
            pos = all_pos[ridx]
            c = cursor[ridx]
            if c >= len(pos):
                pos_sel.append(pos[:0])
                continue
            comp = computed[ridx]
            if wave >= MAX_WAVES:
                # bound the wave count: compute everything still alive
                rem = pos[c:]
                live = rem[(st.di_end[rem] >= 0) & ~comp[rem]]
                pos_sel.append(live)
                n_new += len(live)
                continue
            di_s = st.di.copy()
            de_s = st.di_end.copy()
            need: list[int] = []
            for p in pos[c:]:
                p = int(p)
                qe = int(de_s[p])
                if qe < 0:
                    continue
                if not comp[p]:
                    need.append(p)
                    continue
                rr = range_result.get((ridx, p, qe))
                if _accepts(rr):
                    span = np.arange(rr.rep_start, rr.rep_end)
                    kill = span[(di_s[span] != -1) & (de_s[span] < rr.rep_end)]
                    di_s[kill] = -1.0
                    de_s[kill] = -1
            pos_sel.append(np.asarray(need, dtype=pos.dtype))
            n_new += len(need)
        if n_new == 0:  # explicit raise: an assert vanishes under -O,
            # turning a selection stall into a silent infinite loop
            raise RuntimeError(
                "wave selection stalled with unfinished reads")
        TIMERS.count("waves_extra")
        _tw = time.time()
        queries = walk_batch(states, cfg, pos_sel)
        _t_walks += time.time() - _tw

    TIMERS.add("period", time.time() - _t0 - _t_walks)

    out = []
    for ridx in range(len(states)):
        TIMERS.count("queries", nq[ridx])
        with TIMERS.section("chaining"):
            out.append(chain_records(accepted[ridx]))
    return out


@functools.lru_cache(maxsize=4)
def _device_di_compute_cached(manhattan: bool):
    """Long reads compute the DI sweep on device (the sliding histograms
    dominate their runtime); pairing/redundancy stay host-sequential for
    parity.  On multi-device meshes the Manhattan stencil shards read
    POSITIONS with a ring halo exchange (sequence parallelism,
    SURVEY.md 2.13; the stencil is fill_directional_index.c:171-295)."""
    import jax

    from mtr.ops.directional_index import (
        di_manhattan_device,
        di_pearson_device,
        make_di_manhattan_sharded,
    )

    if manhattan:
        if jax.device_count() > 1:
            from mtr.parallel.mesh import make_mesh

            return make_di_manhattan_sharded(make_mesh())
        return di_manhattan_device
    return di_pearson_device


def _device_di_compute(cfg: MTRConfig):
    return _device_di_compute_cached(cfg.manhattan_distance)


def run_file(
    path: str,
    cfg: MTRConfig = DEFAULT_CONFIG,
    out=None,
    checkpoint: str | None = None,
    strict: bool = True,
    record_sink=None,
    read_filter=None,
    read_meta=None,
):
    """Batched device-backed equivalent of handle_one_file.

    checkpoint: optional path recording the number of fully emitted
    reads; on restart, reads up to that count are skipped and output
    resumes exactly where the previous run stopped (the reference has no
    resume story — partial runs restart from scratch).
    strict: when False, a failing read batch is reported to stderr and
    skipped instead of aborting the file (failure isolation for
    production sweeps).
    record_sink: optional callable receiving every emitted RepeatRecord
    (used by the --cluster stage, which needs fields such as freq_2mer
    that the 13-field text format does not carry).
    read_filter: optional callable(ridx) -> bool selecting the reads
    this process handles (multi-host sharding; the arena is still
    replayed over every read for bit-exactness).  checkpoint counts
    SELECTED reads only.
    read_meta: optional callable(ridx, n_records) invoked per emitted
    read (the multi-host merge needs per-read record counts).
    """
    import gc
    import sys

    if out is None:
        out = sys.stdout
    enable_compile_cache()
    # the pipeline allocates millions of small acyclic records per
    # batch; default generation-0 thresholds trigger thousands of
    # collections per file (each also running XLA's gc callback —
    # ~1.5 s profiled on the north-star set).  Widen while running.
    _gc_thresh = gc.get_threshold()
    gc.set_threshold(200_000, 50, 50)
    if cfg.print_computation_time:
        from mtr import native

        native.enable_stage_timers()  # real -c stage sections (mTR.h:142)
    arena = Arena(cfg.max_input_length)
    batcher = make_batcher(cfg)
    batch: list[ReadState] = []
    done_reads = 0
    skip = 0
    if checkpoint:
        try:
            with open(checkpoint) as f:
                skip = int(f.read().strip() or 0)
        except FileNotFoundError:
            skip = 0

    # Two-stage batch pipeline: stage A (walks — pure host CPU) and
    # stage B (DP + polish + selection — owns the batcher, mostly
    # device wait) run in worker threads.  A(k) overlaps B(k-1)'s
    # device wait, and the main thread's FASTA read + DI pass overlaps
    # both; emission stays in order because B batches are serialized
    # and drained before the next B starts.
    import threading

    pending_a = None  # (thread, states, holderA)
    pending_b = None  # (thread, states, holderB)

    def drain_b():
        nonlocal pending_b, done_reads
        if pending_b is None:
            return
        t, states, holder = pending_b
        t.join()
        pending_b = None
        if "error" in holder:
            if strict:
                raise holder["error"]
            print(
                f"warning: batch of {len(states)} reads failed "
                f"({holder['error']}); skipped",
                file=sys.stderr,
            )
            holder["results"] = [[] for _ in states]
        for st, records in zip(states, holder["results"]):
            for rec in records:
                out.write(rec.format_record() + "\n")
                if record_sink is not None:
                    record_sink(rec)
                if cfg.print_alignment:
                    from mtr.pretty import pretty_print_alignment

                    out.write("\n")
                    pretty_print_alignment(st.org, rec, out)
            if read_meta is not None:
                read_meta(st.ridx, len(records))
            done_reads += 1
        out.flush()
        if checkpoint:
            with open(checkpoint, "w") as f:
                f.write(str(done_reads + skip))

    def promote_a():
        """Wait for the pending walk stage, then start its DP stage
        (after the previous DP batch fully drains)."""
        nonlocal pending_a, pending_b
        if pending_a is None:
            return
        t, states, ha = pending_a
        t.join()
        pending_a = None
        drain_b()
        hb: dict = {}

        def work_b():
            try:
                if "error" in ha:
                    raise ha["error"]
                hb["results"] = process_batch(
                    states, batcher, cfg, queries=ha["queries"],
                    pos_sel=ha["pos_sel"])
            except Exception as e:  # pragma: no cover - failure isolation
                hb["error"] = e

        t2 = threading.Thread(target=work_b)
        t2.start()
        pending_b = (t2, states, hb)

    # adaptive wave pruning: decided per batch from the PREVIOUS
    # batch's measured walk wall time vs host-idle-on-device wait
    # (waves_policy); env vars force either way, output is identical
    adapt = {"walk_s": None, "on": False}

    def flush():
        nonlocal batch, pending_a
        if not batch:
            return
        promote_a()
        pop_idle = getattr(batcher, "pop_dev_idle", None)
        if pop_idle is not None:
            adapt["on"] = waves_policy(adapt["walk_s"], pop_idle())
        states = batch
        batch = []
        ha: dict = {}

        def work_a():
            try:
                # pre-walk only wave 1: later waves depend on acceptance
                # replay, so process_batch computes them itself
                ha["pos_sel"] = wave1_positions(
                    states, cfg, force=adapt["on"])
                _t0 = time.time()
                ha["queries"] = walk_batch(states, cfg, ha["pos_sel"])
                adapt["walk_s"] = time.time() - _t0
            except Exception as e:  # pragma: no cover - failure isolation
                ha["error"] = e

        t = threading.Thread(target=work_a)
        t.start()
        pending_a = (t, states, ha)

    min_rsl = 100
    own = 0
    batch_bases = 0
    try:
        for ridx, read in enumerate(iter_fasta(path, cfg.max_input_length)):
          arena.load_read(read.codes)  # keep arena reuse semantics even when skipping
          if read_filter is not None and not read_filter(ridx):
              continue
          own += 1
          if own <= skip:
              continue
          L = read.length
          org_eff = arena.org_input[: L + 1].copy()
          rsl = min_rsl if L < min_rsl * 10 else L // 10
          di_compute = None
          if cfg.backend == "device" and L >= cfg.device_di_threshold:
              # hybrid keeps DI on the host: the sweep is many small
              # (k, w) dispatches
              di_compute = _device_di_compute(cfg)
          with TIMERS.section("range"):
              di, di_end, di_w = fill_directional_index_with_end(
                  arena, L, rsl, manhattan=cfg.manhattan_distance,
                  di_compute=di_compute, use_native=cfg.use_native,
              )
          batch.append(ReadState(read, org_eff, di, di_end, di_w, ridx))
          batch_bases += L
          if (len(batch) >= cfg.reads_per_batch
                  or batch_bases >= cfg.bases_per_batch):
              flush()
              batch_bases = 0
        flush()
        promote_a()
        drain_b()
    finally:
        gc.set_threshold(*_gc_thresh)
