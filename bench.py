"""Benchmark driver: the north-star metrics on real hardware.

BASELINE.json defines the metric set: reads/s/chip on the 200_200
Nanopore set, wrap-around-DP GCUPS/chip, and output-equality rate vs the
reference binary.  The bundled 200_200 Badread zips are absent from the
reference snapshot (PacBio_Nanopore_read/Readme, .MISSING_LARGE_BLOBS),
so the set is regenerated with the reference's own generator semantics:
rand_seq, unit 200 bp x 200 copies, flanks unit*freq, Nanopore-profile
error rates sub/ins/del = 9.7/2.9/7.5% (test_single_TR/test.sh:16-18).

Prints ONE JSON line.  Primary fields {"metric", "value", "unit",
"vs_baseline"} = reads/s on the 200_200 set for the fastest engine;
extra fields carry the other north-star metrics:
  wrap_dp_gcups        counts-mode wrap-DP engine throughput on the
                       device (the engine the pipeline selects), unit
                       100 / rep 4096 / 2048 jobs; _u200 at unit 200 /
                       rep 32768 / 1024 jobs
  device               platform, device_kind and count as JAX reports
                       them, and the card's name and power limit
  output_equality_rate identical output lines vs the reference binary
                       (GLIBC_TUNABLES=glibc.malloc.tcache_count=0 -- see
                       PARITY.md) across the 200_200 + 100x10 sets
  singleTR_100x10      round-1 headline workload (vs 17 reads/s C ref)

Engine selection is empirical: the engines run in child processes
(one at a time, so each owns the card; the parent never initialises
JAX) with one warmup pass plus best-of-N timed passes.  A run that
finds no GPU fails.
"""

import json
import os
import subprocess
import sys
import time

# Reference-binary rates measured on this container (1 core, stock
# Makefile, no -O): BASELINE.md.  Re-derivable: /tmp/refbuild/mTR.
BASELINE_200x200_READS_PER_S = 0.328   # 5 reads in 15.24 s
BASELINE_100x10_READS_PER_S = 17.0
# The stock Makefile ships NO -O flag (Makefile:5-12).  The honest
# comparison is the same source at -O2: rebuilt with
# CFLAGS += -O2 (output byte-identical on both bench sets), measured
# best-of-N on this container, 1 core: 20 north-star reads in 24.84 s;
# 100 short reads in 2.22 s.  Re-derivable: build_reference_O2().
BASELINE_200x200_O2_READS_PER_S = 0.805
BASELINE_100x10_O2_READS_PER_S = 44.9

N_READS_200 = int(os.environ.get("MTR_BENCH_READS_200", "20"))
N_READS_100 = int(os.environ.get("MTR_BENCH_READS", "100"))
N_REPS = int(os.environ.get("MTR_BENCH_REPS", "3"))
FASTA_200 = "/tmp/mtr_bench_200x200.fasta"
FASTA_100 = "/tmp/mtr_bench_100x10.fasta"
REF_BIN = "/tmp/refbuild/mTR"

_CHILD_ENV = {
    # keep glibc from returning freed arenas to the OS: on lazy-memory
    # hosts re-faulting returned pages is expensive (mtr/native.py)
    "MALLOC_MMAP_MAX_": "0",
    "MALLOC_TRIM_THRESHOLD_": "1073741824",
}
REPO = os.path.dirname(os.path.abspath(__file__))


def ensure_sets():
    from mtr.testutil.rand_seq import write_fasta

    regen = os.environ.get("MTR_BENCH_REGEN")

    def stale(fasta, n):
        # a sidecar records the read count the file was generated with;
        # changing MTR_BENCH_READS* must regenerate, not skew reads/s
        # against a stale file
        meta = fasta + ".n"
        if not os.path.exists(fasta):
            return True
        try:
            return int(open(meta).read().strip()) != n
        except (FileNotFoundError, ValueError):
            return True

    if stale(FASTA_200, N_READS_200) or regen:
        write_fasta(FASTA_200, FASTA_200[:-6] + ".units",
                    200, 200, 9.7, 2.9, 7.5, 40000, 40000, N_READS_200,
                    seed=20200)
        open(FASTA_200 + ".n", "w").write(str(N_READS_200))
    if stale(FASTA_100, N_READS_100) or regen:
        write_fasta(FASTA_100, FASTA_100[:-6] + ".units",
                    100, 10, 1.6, 9.0, 3.8, 1000, 1000, N_READS_100,
                    seed=12345)
        open(FASTA_100 + ".n", "w").write(str(N_READS_100))


def ensure_reference():
    """Build the unmodified reference binary for equality goldens."""
    if os.path.exists(REF_BIN):
        return True
    import glob
    import shutil

    src = "/root/reference"
    if not os.path.isdir(src):
        return False
    bld = "/tmp/refbuild"
    os.makedirs(bld, exist_ok=True)
    for pat in ("*.c", "*.cpp", "*.h", "Makefile"):
        for f in glob.glob(os.path.join(src, pat)):
            shutil.copy(f, bld)
    r = subprocess.run(["make"], cwd=bld, capture_output=True)
    return r.returncode == 0 and os.path.exists(REF_BIN)


def build_reference_O2(dest="/tmp/refbuild/mTR_O2"):
    """Rebuild the unmodified reference source at -O2 (the honest
    baseline build — the stock Makefile has no -O flag).  Returns the
    binary path or None."""
    if os.path.exists(dest):
        return dest
    if not ensure_reference():
        return None
    import glob
    import shutil

    bld = "/tmp/refbuild_O2"
    os.makedirs(bld, exist_ok=True)
    for pat in ("*.c", "*.cpp", "*.h", "Makefile"):
        for f in glob.glob(os.path.join("/tmp/refbuild", pat)):
            shutil.copy(f, bld)
    mk = os.path.join(bld, "Makefile")
    txt = open(mk).read().replace(
        "CFLAGS\t= -std=c99", "CFLAGS\t= -O2 -std=c99").replace(
        "$(CPP) -c $<", "$(CPP) -O2 -c $<")
    open(mk, "w").write(txt)
    r = subprocess.run(["make"], cwd=bld, capture_output=True)
    built = os.path.join(bld, "mTR")
    if r.returncode != 0 or not os.path.exists(built):
        return None
    shutil.copy(built, dest)
    return dest


def reference_golden(fasta, pearson=False):
    """Reference output under the deterministic-allocator configuration
    (PARITY.md), cached beside the fasta."""
    golden = fasta + (".p.refout" if pearson else ".refout")
    if os.path.exists(golden) and os.path.getmtime(golden) >= os.path.getmtime(fasta):
        return golden
    if not ensure_reference():
        return None
    env = {**os.environ, "GLIBC_TUNABLES": "glibc.malloc.tcache_count=0"}
    cmd = [REF_BIN] + (["-p"] if pearson else []) + [fasta]
    try:
        with open(golden, "w") as out:
            r = subprocess.run(cmd, stdout=out, env=env, timeout=3600)
        ok = r.returncode == 0
    except Exception:  # incl. TimeoutExpired: never keep a partial golden
        ok = False
    if not ok:
        try:
            os.unlink(golden)
        except FileNotFoundError:
            pass
        return None
    return golden


WORM = "/root/reference/test_multiple_TRs/data/worm_chrII_1.fasta"
MULTI90K = "/root/reference/test_multiple_TRs/data/2_5_10_20_50_100_200_set.fasta"
FASTA_STRUCT = "/tmp/mtr_bench_structured.fasta"
FASTA_800K = "/tmp/mtr_bench_800k.fasta"


def ensure_800k():
    """One 800 kbp synthetic read (PARITY.md long-read case): inside the
    reference's well-defined envelope (< ~833 kbp), so a golden exists;
    exercises the long-context path in the equality metric."""
    if os.path.exists(FASTA_800K):
        return
    from mtr.testutil.rand_seq import write_fasta

    write_fasta(FASTA_800K, FASTA_800K[:-6] + ".units",
                100, 2000, 9.7, 2.9, 7.5, 300000, 300000, 1, seed=80080)


def ensure_structured():
    """Badread-style structured-error set (burst indels, homopolymer
    slips, read-level identity spread) extended with
    Badread's artifact classes (junk/random reads, chimeras, ligation
    adapters)."""
    marker = FASTA_STRUCT + ".v2"
    if os.path.exists(FASTA_STRUCT) and os.path.exists(marker):
        return
    from mtr.testutil.structured_errors import write_structured_fasta

    write_structured_fasta(FASTA_STRUCT, FASTA_STRUCT[:-6] + ".units",
                           50, 12, 0.08, 600, 12, seed=4242,
                           junk_frac=0.1, random_frac=0.05,
                           chimera_frac=0.15, adapters=True)
    open(marker, "w").write("1")


def _eqout_path(fasta, backend, pearson):
    # always under /tmp: the fasta may live in the read-only reference
    suffix = f".{backend}.p.eqout" if pearson else f".{backend}.eqout"
    return os.path.join("/tmp", os.path.basename(fasta) + suffix)


def equality_child(backend, fasta, pearson):
    """Equality-only run: one pass, output to _eqout_path."""
    import io

    from mtr.config import MTRConfig
    from mtr.pipeline import run_file

    cfg = MTRConfig(backend=backend, manhattan_distance=not pearson)
    buf = io.StringIO()
    run_file(fasta, cfg, buf)
    with open(_eqout_path(fasta, backend, pearson), "w") as f:
        f.write(buf.getvalue())
    print(json.dumps({"ok": True}))
    return 0


def child(backend, fasta, n_reads, n_reps):
    """Measured run in-process: warmup + n_reps timed passes, best dt.
    Also emits the output lines (for the equality metric).

    backend may be a comma-separated list: the engines then measure
    INTERLEAVED (round-robin passes in one process), so drift hits
    every engine equally."""
    import io

    from mtr.config import MTRConfig
    from mtr.pipeline import run_file

    backends = backend.split(",")
    cfgs = {
        b: MTRConfig(backend=b, reads_per_batch=min(128, n_reads))
        for b in backends
    }
    for b in backends:  # warmup: compiles, pools, pages
        buf = io.StringIO()
        run_file(fasta, cfgs[b], buf)
        with open(fasta + f".{b}.out", "w") as f:
            f.write(buf.getvalue())
    best = {b: float("inf") for b in backends}
    for _ in range(n_reps):
        for b in backends:
            t0 = time.time()
            run_file(fasta, cfgs[b], io.StringIO())
            best[b] = min(best[b], time.time() - t0)
    print(json.dumps({"dt": {b: best[b] for b in backends}}))
    return 0


def _gcups_one(engine, b, unit_len, rep_len):
    """Device GCUPS of the counts engine on b planted-repeat jobs of one
    shape: best of 3 synced calls after a compiling one."""
    import jax
    import numpy as np

    from mtr.ops.wrap_dp_counts import U_BUCKETS, bucket, counts_fn, row_bucket
    from mtr.testutil.dp_jobs import pack_jobs

    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, unit_len)
    rep = np.tile(unit, rep_len // unit_len + 1)[:rep_len]
    u_pad = bucket(unit_len, U_BUCKETS)
    r_pad = row_bucket(engine, rep_len)
    args = [jax.device_put(a) for a in pack_jobs(
        [(rep, unit, (1, 1, 3))] * b, b, u_pad, max(r_pad, 128))]
    fn = counts_fn(engine, b, u_pad, r_pad)
    fn(*args).block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return b * unit_len * rep_len / best / 1e9


def child_gcups():
    """Counts-engine GCUPS at the two production shapes, plus the device
    the child found (the parent stays off JAX)."""
    import jax

    from mtr.ops.wrap_dp_counts import default_engine

    dev = jax.devices()[0]
    engine = default_engine()
    print(json.dumps({
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "engine": engine,
        "gcups": _gcups_one(engine, 2048, 100, 4096),
        "gcups_w": _gcups_one(engine, 1024, 200, 32768),
    }))
    return 0


def card_info():
    """The card's name and power limit, from nvidia-smi (not JAX)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None


def run_child(args, timeout_s):
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *args],
            capture_output=True, timeout=timeout_s, cwd=REPO,
            env={**os.environ, **_CHILD_ENV},
        )
    except subprocess.TimeoutExpired:
        return None
    if r.returncode != 0:
        return None
    try:
        return json.loads(r.stdout.splitlines()[-1])
    except Exception:
        return None


def equality_rate(pairs):
    """(rate, n_compared): fraction of identical output lines across the
    (ours, golden) pairs where BOTH files exist — sets whose golden or
    output is missing are excluded from the count, not silently folded
    in."""
    total = match = n_compared = 0
    for ours, golden in pairs:
        if not (ours and golden and os.path.exists(ours) and os.path.exists(golden)):
            continue
        n_compared += 1
        a = open(ours).read().splitlines()
        b = open(golden).read().splitlines()
        total += max(len(a), len(b))
        match += sum(1 for x, y in zip(a, b) if x == y)
    return ((match / total) if total else None), n_compared


def measure_set(fasta, n_reads, candidates, n_reps, timeout_s):
    results = {}
    # host + hybrid measure interleaved in ONE child (drift-fair); the
    # pure-device engine runs in a child of its own
    grouped = [b for b in candidates if b != "device"]
    if grouped:
        r = run_child(
            ["--child", ",".join(grouped), fasta, str(n_reads),
             str(n_reps)], timeout_s)
        if r is not None:
            dt = r["dt"]
            if isinstance(dt, dict):
                results.update(dt)
            else:  # single-backend child (forced via MTR_BENCH_BACKEND)
                results[grouped[0]] = dt
    if "device" in candidates:
        r = run_child(
            ["--child", "device", fasta, str(n_reads), str(n_reps)],
            min(timeout_s, 2400))
        if r is not None:
            dt = r["dt"]
            results["device"] = (
                dt["device"] if isinstance(dt, dict) else dt)
    if not results:
        return None, None, {}
    best = min(results, key=results.get)
    per_engine = {k: round(n_reads / v, 3) for k, v in results.items()}
    return best, n_reads / results[best], per_engine


def main():
    ensure_sets()
    g = run_child(["--gcups"], timeout_s=1800)
    if g is None or g.get("platform") != "gpu":
        print(json.dumps({"metric": "reads_per_s_nanopore_200x200",
                          "value": 0.0, "unit": "reads/s",
                          "vs_baseline": 0.0, "error": "no GPU",
                          "device": g}))
        return 1
    device = {k: g[k] for k in ("platform", "device_kind", "count")}
    device["card"] = card_info()
    force = os.environ.get("MTR_BENCH_BACKEND")
    candidates = [force] if force else ["host", "hybrid", "device"]

    # the north-star workload
    b200, rate200, eng200 = measure_set(
        FASTA_200, N_READS_200, candidates, N_REPS, timeout_s=5400)
    # round-1 headline workload (comparability across rounds)
    b100, rate100, eng100 = measure_set(
        FASTA_100, N_READS_100, candidates, N_REPS, timeout_s=5400)

    pairs = []
    for fasta, backend in ((FASTA_200, b200), (FASTA_100, b100)):
        if backend:
            pairs.append((f"{fasta}.{backend}.out", reference_golden(fasta)))

    # heterogeneous equality sets: real Nanopore worm
    # read, Pearson (-p) mode on the 7-type 90 kb fixture, and a
    # Badread-style structured-error set — all run on the winning
    # backend and folded into the published metric
    import shutil

    eq_backend = b200 or b100 or "host"
    ensure_structured()
    ensure_800k()
    extra = []
    for src, pearson in ((WORM, False), (MULTI90K, True),
                         (FASTA_STRUCT, False), (FASTA_800K, False)):
        if not os.path.exists(src):
            continue
        fasta = src
        if src.startswith("/root/reference"):
            fasta = "/tmp/mtr_bench_" + os.path.basename(src)
            if not os.path.exists(fasta):
                shutil.copy(src, fasta)
        extra.append((fasta, pearson))
    for fasta, pearson in extra:
        args = ["--child-eq", eq_backend, fasta, "1" if pearson else "0"]
        if run_child(args, timeout_s=1800) is not None:
            pairs.append((_eqout_path(fasta, eq_backend, pearson),
                          reference_golden(fasta, pearson)))
    # a set counts only when BOTH our output and the golden exist
    eq, n_eq_sets = equality_rate(pairs)

    if rate200 is None:
        print(json.dumps({"metric": "reads_per_s_nanopore_200x200",
                          "value": 0.0, "unit": "reads/s",
                          "vs_baseline": 0.0, "error": "no engine",
                          "device": device}))
        return 1
    print(json.dumps({
        "metric": f"reads_per_s_nanopore_200x200_{b200}",
        "value": round(rate200, 3),
        "unit": "reads/s",
        "vs_baseline": round(rate200 / BASELINE_200x200_READS_PER_S, 3),
        # vs the same source rebuilt at -O2 (the fair-compile baseline)
        "vs_baseline_O2": round(rate200 / BASELINE_200x200_O2_READS_PER_S, 3),
        "wrap_dp_gcups": round(g["gcups"], 2),
        "wrap_dp_gcups_u200": round(g["gcups_w"], 2),
        "wrap_dp_engine": g["engine"],
        "device": device,
        "output_equality_rate": eq,
        "equality_sets": n_eq_sets,
        "singleTR_100x10": {
            "backend": b100,
            "reads_per_s": round(rate100, 3) if rate100 else None,
            "vs_baseline": round(rate100 / BASELINE_100x10_READS_PER_S, 3)
            if rate100 else None,
            "vs_baseline_O2": round(
                rate100 / BASELINE_100x10_O2_READS_PER_S, 3)
            if rate100 else None,
        },
        # per-engine reads/s (transparency: winner margins vs session
        # noise are visible, not just the argmax)
        "engines_200x200": eng200,
        "engines_100x10": eng100,
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        sys.exit(child(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                       int(sys.argv[5])))
    if len(sys.argv) > 1 and sys.argv[1] == "--child-eq":
        sys.exit(equality_child(sys.argv[2], sys.argv[3],
                                sys.argv[4] == "1"))
    if len(sys.argv) > 1 and sys.argv[1] == "--gcups":
        sys.exit(child_gcups())
    sys.exit(main())
