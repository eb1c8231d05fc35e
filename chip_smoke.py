#!/usr/bin/env python3
"""Smoke test of the system on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only: the sharded DP
                                       # batcher on 4 cards vs 1

Phases:
  1. device: JAX sees a GPU; the card's name and power limit; the
     native host library is loaded;
  2. kernel parity at real widths: the counts engine the pipeline
     selects (the CUDA kernel) and the XLA engine, on seeded jobs at
     the production shapes plus units 2/7/129/257/500 under schemes
     (1,1,3), (1,3,1), (5,1,1), each row equal to the native host
     engine; a sample also equal to the oracle;
  3. timing: cells/s of both engines at those shapes (device-synced);
  4. main path: the CLI's default engine on 8 reads of the north-star
     set (200 bp x 200 copies, Nanopore profile, 40 kb flanks), byte-
     identical to --backend host, with device DP chunks counted; and
     the committed multi20_100x10 set, byte-identical to the reference
     binary's golden output;
  5. --backend device (device DI, DBG walks and DP) on multi20_100x10
     and on one generated 105 kb read, byte-identical to the host
     engine.

Any failed phase exits non-zero.  The last stdout line is one JSON
object {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
SCHEMES = ((1, 1, 3), (1, 3, 1), (5, 1, 1))
# (unit_len, rep_len bound, jobs) at the production shapes
SHAPES = ((100, 4096, 2048), (200, 32768, 1024), (500, 4096, 256))


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi gave no card")
    return r.stdout.strip().splitlines()[0]


def run_cli(argv) -> tuple[str, float]:
    """cli.main in this process with stdout captured: (output, seconds)."""
    from mtr import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} exited {rc}")
    return buf.getvalue(), dt


def north_star_fasta(td: str, n_reads: int = 8) -> str:
    """bench.py's north-star set: 200 bp x 200 copies, sub/ins/del
    9.7/2.9/7.5%, 40 kb flanks, seed 20200."""
    from mtr.testutil.rand_seq import write_fasta

    path = os.path.join(td, "ns200x200.fasta")
    write_fasta(path, path + ".units", 200, 200, 9.7, 2.9, 7.5,
                40000, 40000, n_reads, seed=20200)
    return path


# ---- phase 2/3 ------------------------------------------------------------

def shape_jobs(rng, unit_len, rep_max, n):
    """Planted repeats with ~15% random errors, rep_len in
    [rep_max/2, rep_max], schemes cycling."""
    import numpy as np

    jobs = []
    for q in range(n):
        rl = int(rng.integers(rep_max // 2, rep_max + 1))
        unit = rng.integers(0, 4, unit_len)
        rep = np.tile(unit, rl // unit_len + 1)[:rl].copy()
        err = rng.random(rl) < 0.15
        rep[err] = rng.integers(0, 4, int(err.sum()))
        jobs.append((rep.astype(np.int32), unit.astype(np.int32),
                     SCHEMES[q % 3]))
    return jobs


def host_rows(jobs):
    """Native host engine: (n, 7) [m, x, ins, del, scanned, i_final, max_i]."""
    import numpy as np

    from mtr import native

    n = len(jobs)
    orgs = [np.concatenate([[0], rep]).astype(np.int32) for rep, _, _ in jobs]
    units = np.zeros((n, 500), np.int32)
    for q, (_, unit, _) in enumerate(jobs):
        units[q, : len(unit)] = unit
    res = native.wrap_dp_batch(
        orgs, np.zeros(n, np.int64), [len(rep) - 1 for rep, _, _ in jobs],
        units, [len(u) for _, u, _ in jobs], [s for _, _, s in jobs],
        np.zeros(n, np.int32))
    check(res is not None, "native wrap_dp_batch unavailable")
    return np.asarray(res[0][:n]).copy()


def engine_args(jobs, u_pad, r_pad, b):
    import jax

    from mtr.testutil.dp_jobs import pack_jobs

    return [jax.device_put(a) for a in pack_jobs(jobs, b, u_pad, max(r_pad, 128))]


def time_fn(fn, args, reps=3) -> float:
    fn(*args).block_until_ready()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_kernels(card: str) -> None:
    import numpy as np

    from mtr.ops.wrap_dp_counts import (
        U_BUCKETS, bucket, counts_fn, default_engine, row_bucket)
    from mtr.testutil.dp_jobs import mismatches

    selected = default_engine()
    check(selected == "cuda", f"pipeline selects {selected!r} on the GPU")
    engines = (selected, "xla")
    rng = np.random.default_rng(20200)
    sets = [(f"u{ul}_r{rm}_b{n}", shape_jobs(rng, ul, rm, n), ul, rm)
            for ul, rm, n in SHAPES]
    extra = []
    for ul in (2, 7, 129, 257, 500):
        extra += shape_jobs(rng, ul, 4096, 6)
    sets.append(("units_2_7_129_257_500", extra, 500, 4096))
    timings = []
    for name, jobs, max_unit, rep_max in sets:
        u_pad = bucket(max_unit, U_BUCKETS)
        b = max(8, 1 << (len(jobs) - 1).bit_length())
        want = host_rows(jobs)
        cells = sum(len(r) * len(u) for r, u, _ in jobs)
        outs = {}
        for eng in engines:
            r_pad = row_bucket(eng, rep_max)
            fn = counts_fn(eng, b, u_pad, r_pad)
            args = engine_args(jobs, u_pad, r_pad, b)
            rows = np.asarray(fn(*args))[: len(jobs)]
            got = rows[:, [0, 1, 2, 3, 4, 5, 9]]
            bad = np.nonzero((got != want).any(axis=1))[0]
            check(len(bad) == 0 and rows[:, 6].all(),
                  f"{eng} {name}: {len(bad)} rows differ from the host "
                  f"engine, first {bad[:3].tolist()}")
            outs[eng] = rows
            if name != sets[-1][0]:
                timings.append((eng, name, cells, time_fn(fn, args)))
        check(np.array_equal(outs["cuda"], outs["xla"]),
              f"{name}: cuda and xla rows differ")
        # oracle on a sample: the shortest job and one of each scheme
        order = np.argsort([len(r) for r, _, _ in jobs])
        sample = [int(order[0])] + [q for q in range(3) if q < len(jobs)]
        sub = [jobs[q] for q in sample]
        check(not mismatches(outs["cuda"][sample], sub),
              f"{name}: cuda rows differ from the oracle")
        print(f"phase 2: {name}: {len(jobs)} jobs equal on host engine, "
              f"cuda, xla; {len(sample)} on the oracle", flush=True)
    print(f"phase 3: card {card}", flush=True)
    for eng, name, cells, t in timings:
        print(f"phase 3: {eng:4s} {name}: {cells} cells in {t:.6f} s = "
              f"{cells / t / 1e9:.3f} GCUPS ({card})", flush=True)


# ---- phase 4/5 ------------------------------------------------------------

def phase_main_path(td: str, card: str) -> None:
    from mtr.utils.timers import TIMERS

    fasta = north_star_fasta(td)
    before = TIMERS.counters.get("dp_chunks", 0)
    out, t_cold = run_cli([fasta])
    chunks = TIMERS.counters.get("dp_chunks", 0) - before
    check(chunks > 0, "the default engine ran no device DP chunk")
    out2, t_warm = run_cli([fasta])
    host, t_host = run_cli(["--backend", "host", fasta])
    check(out and out == host == out2,
          "default engine output differs from --backend host")
    print(f"phase 4: north-star 8 reads: default engine {chunks} device DP "
          f"chunks, {len(out.splitlines())} records == host; wall cold "
          f"{t_cold:.3f} s, warm {t_warm:.3f} s, host {t_host:.3f} s "
          f"({card})", flush=True)
    golden_fa = os.path.join(GOLDEN, "multi20_100x10.fasta")
    out, t = run_cli([golden_fa])
    check(out == open(os.path.join(GOLDEN, "multi20_100x10.out")).read(),
          "multi20_100x10 differs from the golden")
    print(f"phase 4: multi20_100x10 default engine == golden ({t:.3f} s)",
          flush=True)


def phase_device_backend(td: str) -> None:
    from mtr.testutil.rand_seq import write_fasta

    golden_fa = os.path.join(GOLDEN, "multi20_100x10.fasta")
    out, t = run_cli(["--backend", "device", golden_fa])
    check(out == open(os.path.join(GOLDEN, "multi20_100x10.out")).read(),
          "--backend device differs from the golden on multi20_100x10")
    print(f"phase 5: --backend device multi20_100x10 == golden ({t:.3f} s)",
          flush=True)
    # 100 bp x 250 copies between 40 kb flanks: a 105 kb read, past
    # config.device_di_threshold (65536), so the device DI engages
    long_fa = os.path.join(td, "long105k.fasta")
    write_fasta(long_fa, long_fa + ".units", 100, 250, 9.7, 2.9, 7.5,
                40000, 40000, 1, seed=105)
    out, t = run_cli(["--backend", "device", long_fa])
    host, t_host = run_cli(["--backend", "host", long_fa])
    check(out and out == host, "--backend device differs from host on 105 kb")
    print(f"phase 5: --backend device 105 kb read == host ({t:.3f} s, host "
          f"{t_host:.3f} s)", flush=True)


# ---- phase 6 --------------------------------------------------------------

def phase_four_cards(td: str, card: str) -> None:
    import mtr.pipeline as P
    from mtr.config import MTRConfig
    from mtr.parallel.mesh import make_mesh

    fasta = north_star_fasta(td)

    def run_with(batcher):
        buf = io.StringIO()
        orig = P.make_batcher
        P.make_batcher = lambda _cfg: batcher
        try:
            t0 = time.perf_counter()
            P.run_file(fasta, MTRConfig(), buf)
            return buf.getvalue(), time.perf_counter() - t0
        finally:
            P.make_batcher = orig

    single, t1 = run_with(P.WrapDPBatcher())
    sharded, t4 = run_with(P.ShardedWrapDPBatcher(make_mesh(4)))
    check(single and single == sharded,
          "sharded 4-card output differs from the single-card run")
    print(f"phase 6: north-star 8 reads, sharded over 4 cards == 1 card; "
          f"wall {t4:.3f} s vs {t1:.3f} s (first runs, compile "
          f"included; {card})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "mtr")):
        print("chip_smoke: the mtr package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    try:
        check(len(devs) >= want, f"{len(devs)} GPUs visible, {want} needed")
        card = card_line()
        from mtr import native

        check(native.available(), "native host library did not load")
        print(f"phase 1: {dev.platform} {dev.device_kind} x{len(devs)}; "
              f"native host library loaded", flush=True)
        with tempfile.TemporaryDirectory() as td:
            if args.four_cards:
                phase_four_cards(td, card)
            else:
                phase_kernels(card)
                phase_main_path(td, card)
                phase_device_backend(td)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": want}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
