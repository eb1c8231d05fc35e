"""Scaling measurements -> SCALING.md (BASELINE north-star: >=85%
efficiency to 2 hosts; VERDICT r2 missing #1).

Two measurements, both honest about this container's 2 physical cores:

1. PROCESS scaling (the multi-host axis): reads/s for the same fixed
   workload under 1 process vs 2 real jax.distributed processes
   (run_file_sharded round-robin shards + deterministic merge), each
   process pinned to ONE native thread (MTR_THREADS=1) so the
   baseline is genuinely single-threaded.  This is the
   embarrassingly-parallel axis the reference processes sequentially
   (handle_one_file.c:281-287).

2. VIRTUAL-DEVICE weak scaling (the multi-chip axis): the position-
   sharded DI stencil (plain XLA + ring halo exchange,
   ops/directional_index.make_sharded_sliding_l1) with a FIXED block of
   positions per device on 1/2/4/8 virtual CPU devices.  Ideal weak
   scaling holds t(n) flat; past n=2 the 2-core host saturates, which
   the table reports as-is.

Usage: python scripts/scaling_bench.py            # writes SCALING.md
       python scripts/scaling_bench.py --json     # machine-readable
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)  # script mode puts scripts/ first, not REPO
FASTA = "/tmp/mtr_scaling_200x50.fasta"
N_READS = 64


def ensure_fixture():
    # fewer, LONGER reads (18 kb: 200 bp x 50 + 4 kb flanks): per-read
    # compute dwarfs the per-process serial fraction (FASTA parse +
    # bit-exactness arena replay over every read), which on 3 kb reads
    # was ~40% of the 1-process wall time and polluted the efficiency
    if os.path.exists(FASTA):
        return
    sys.path.insert(0, REPO)
    from mtr.testutil.rand_seq import write_fasta

    write_fasta(FASTA, FASTA + ".units", 200, 50, 9.7, 2.9, 7.5,
                4000, 4000, N_READS, seed=777)


def worker(pid: int, n: int, port: int, prefix: str) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if n > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{port}",
            num_processes=n, process_id=pid,
        )
    from mtr.config import MTRConfig
    from mtr.parallel.distributed import run_file_sharded

    t0 = time.time()
    run_file_sharded(FASTA, prefix, MTRConfig(backend="host"),
                     process_index=pid, process_count=n)
    print(json.dumps({"dt": time.time() - t0}))
    return 0


def run_dp_sharded(n: int, total_b: int = 2048) -> dict:
    """DP-path scaling: a FIXED wrap-DP chunk (total_b jobs, unit 100,
    rep 2048) sharded over an n-virtual-device mesh exactly as
    ShardedWrapDPBatcher shards every chunk (parallel/mesh.py
    sharded_counts_fn: batch dim split, flat reads replicated), on the
    XLA counts engine so CPU devices run real compiled code.

    Returns wall time of the sharded dispatch AND the per-device compute
    time for one local shard (total_b/n jobs), the latter measured in a
    SEPARATE single-device process: under
    xla_force_host_platform_device_count=n XLA:CPU divides the host's
    intra-op threadpool across the n virtual devices, so timing "one
    device while the others idle" inside the n-device process slows
    with n — a host artifact a real device does not have."""
    code = (
        "import os, time, json, numpy as np\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        f"n = {n}\n"
        f"B = {total_b}\n"
        "assert jax.device_count() == n, jax.devices()\n"
        "from mtr.parallel.mesh import make_mesh, sharded_counts_fn\n"
        "from mtr.ops.wrap_dp_counts import counts_fn\n"
        "from mtr.testutil.dp_jobs import pack_jobs\n"
        "rng = np.random.default_rng(0)\n"
        "unit_len, rep_len, r_pad = 100, 2048, 4096\n"
        "unit = rng.integers(0, 4, unit_len)\n"
        "rep = np.tile(unit, rep_len // unit_len + 1)[:rep_len]\n"
        "def inputs(b):\n"
        "    return pack_jobs([(rep, unit, (1, 1, 3))] * b, b, 128, r_pad)\n"
        "def best_of(f, a, k=3):\n"
        "    np.asarray(f(*a)); ts = []\n"
        "    for _ in range(k):\n"
        "        t0 = time.time(); np.asarray(f(*a)); ts.append(time.time() - t0)\n"
        "    return min(ts)\n"
        "if MODE == 'shard':\n"
        "    t = best_of(counts_fn('xla', B // n, 128, r_pad), inputs(B // n))\n"
        "elif n == 1:\n"
        "    t = best_of(counts_fn('xla', B, 128, r_pad), inputs(B))\n"
        "else:\n"
        "    fn = sharded_counts_fn(make_mesh(n), 'xla', B, 128, r_pad)\n"
        "    t = best_of(fn, inputs(B))\n"
        "print(json.dumps({'t': t}))\n"
    )

    def run(mode: str):
        devs = 1 if mode == "shard" else n
        env = {**os.environ,
               "XLA_FLAGS":
               f"--xla_force_host_platform_device_count={devs}"}
        mcode = code.replace("MODE", repr(mode)).replace(
            "assert jax.device_count() == n",
            f"assert jax.device_count() == {devs}")
        r = subprocess.run([sys.executable, "-c", mcode], cwd=REPO,
                           env=env, capture_output=True, timeout=1200)
        if r.returncode != 0:
            raise RuntimeError(r.stderr.decode()[-2000:])
        return json.loads(r.stdout.splitlines()[-1])["t"]

    return {"t_wall": run("wall"), "t_shard": run("shard")}


def run_procs(n: int) -> float:
    """Compute time for the whole workload under n processes: the MAX of
    the workers' self-reported run_file_sharded times.  Interpreter +
    jax.distributed startup (a per-process constant, ~2 s here) is
    excluded — it amortizes to nothing on production-sized inputs and
    would otherwise dominate this fixture."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    prefix = f"/tmp/mtr_scaling_p{n}"
    env = {**os.environ, "MTR_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    ncores = os.cpu_count() or 1
    procs = [
        subprocess.Popen(
            # one core per process — without pinning, a single process
            # spreads over every core (pipeline overlap thread + JAX
            # pool) and the 1-process baseline silently becomes
            # multi-core, understating scaling efficiency
            ["taskset", "-c", str(pid % ncores), sys.executable,
             os.path.abspath(__file__), "--worker", str(pid), str(n),
             str(port), prefix],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(n)
    ]
    dts = []
    for p in procs:
        out, err = p.communicate(timeout=2400)
        if p.returncode != 0:
            raise RuntimeError(err.decode()[-2000:])
        dts.append(json.loads(out.decode().splitlines()[-1])["dt"])
    return max(dts)


def run_vdev(n: int) -> float:
    """Weak-scaled sharded-DI step time on n virtual devices."""
    code = (
        "import os, time, json, numpy as np\n"
        "os.environ['JAX_PLATFORMS']='cpu'\n"
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        f"assert jax.device_count() == {n}, jax.devices()\n"
        "from mtr.parallel.mesh import make_mesh\n"
        "from mtr.ops.directional_index import make_sharded_sliding_l1\n"
        f"mesh = make_mesh({n})\n"
        f"n_pad = 131072 * {n}\n"
        "fn = make_sharded_sliding_l1(mesh, n_pad, 4, 20480)\n"
        "codes = np.random.default_rng(0).integers(0, 256, n_pad)"
        ".astype(np.int32)\n"
        "fn(codes, 640).block_until_ready()  # compile\n"
        "ts = []\n"
        "for _ in range(5):\n"
        "    t0 = time.time()\n"
        "    fn(codes, 640).block_until_ready()\n"
        "    ts.append(time.time() - t0)\n"
        "print(json.dumps({'dt': min(ts)}))\n"
    )
    env = {**os.environ,
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={n}"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(r.stderr.decode()[-2000:])
    return json.loads(r.stdout.splitlines()[-1])["dt"]


def main() -> int:
    ensure_fixture()
    # best-of-2: single-shot wall times on a 2-core shared container
    # fluctuate +-30%
    t1 = min(run_procs(1), run_procs(1))
    t2 = min(run_procs(2), run_procs(2))
    proc_eff = t1 / (2 * t2)

    # DP-path (ShardedWrapDPBatcher-style shard_map) scaling
    dp = {n: run_dp_sharded(n) for n in (1, 2, 4, 8)}

    # weak scaling: per-device work fixed, ideal keeps t(n) flat; the
    # 2-core host parallelizes 2 virtual devices genuinely, beyond that
    # shards time-share cores (reported as-is)
    vdev = {}
    for n in (1, 2, 4, 8):
        vdev[n] = run_vdev(n)
    weak = {n: vdev[1] / vdev[n] for n in vdev}

    result = {
        "workload": f"{N_READS} reads of 18 kb (200bp unit x 50, "
                    "Nanopore profile), host engine, "
                    "1 native thread/process, 1 pinned core/process",
        "procs": {"t1": round(t1, 2), "t2": round(t2, 2),
                  "reads_per_s_1p": round(N_READS / t1, 2),
                  "reads_per_s_2p": round(N_READS / t2, 2),
                  "efficiency": round(proc_eff, 3)},
        "dp_sharded": {str(n): {"t_wall": round(dp[n]["t_wall"], 4),
                                "t_shard": round(dp[n]["t_shard"], 4),
                                "shard_eff": round(
                                    dp[1]["t_shard"] / (n * dp[n]["t_shard"]),
                                    3)}
                       for n in dp},
        "vdev_weak": {str(n): {"t": round(vdev[n], 3),
                               "efficiency": round(weak[n], 3)}
                      for n in vdev},
    }
    if "--json" in sys.argv:
        print(json.dumps(result))
        return 0

    with open(os.path.join(REPO, "SCALING.md"), "w") as f:
        f.write(
            "# SCALING — measured parallel efficiency\n\n"
            "Produced by `python scripts/scaling_bench.py` on this "
            "container (2 physical cores — the honest ceiling for any "
            "local measurement; the design axis is SURVEY.md §2.13: "
            "reads are embarrassingly parallel, the reference processes "
            "them sequentially in `handle_one_file.c:281-287`).\n\n"
            "## 1. Process scaling (multi-host axis)\n\n"
            f"Workload: {result['workload']}; real `jax.distributed` "
            "coordinator, round-robin read shards "
            "(`run_file_sharded`), deterministic merge.\n\n"
            "| processes | wall s | reads/s | efficiency |\n"
            "|---|---|---|---|\n"
            f"| 1 | {result['procs']['t1']} | "
            f"{result['procs']['reads_per_s_1p']} | 1.000 |\n"
            f"| 2 | {result['procs']['t2']} | "
            f"{result['procs']['reads_per_s_2p']} | "
            f"{result['procs']['efficiency']} |\n\n"
            + "## 2. DP-path scaling (ShardedWrapDPBatcher axis)\n\n"
            "A fixed 2048-job wrap-DP chunk (unit 100, rep 2048) "
            "sharded over the 'dp' mesh axis exactly as "
            "`ShardedWrapDPBatcher` shards every chunk; engine = the "
            "pure-XLA counts kernel (real compiled code on CPU "
            "devices).  `t_shard` is ONE device executing ONE local "
            "shard (B/n jobs) measured without core time-sharing; "
            "`shard_eff` = t_shard(1) / (n * t_shard(n)) shows whether "
            "splitting the batch costs per-device efficiency (padding "
            "quantization).  `t_wall` is the full sharded dispatch, "
            "core-limited past n=2 on this host.\n\n"
            "| devices | t_wall s | t_shard s | shard efficiency |\n"
            "|---|---|---|---|\n"
            + "".join(
                f"| {n} | {result['dp_sharded'][str(n)]['t_wall']} | "
                f"{result['dp_sharded'][str(n)]['t_shard']} | "
                f"{result['dp_sharded'][str(n)]['shard_eff']} |\n"
                for n in (1, 2, 4, 8)
            )
            + "\n## 3. Virtual-device weak scaling (multi-chip axis)\n\n"
            "Position-sharded DI stencil (ring halo exchange over the "
            "mesh axis), 131072 positions per device; ideal weak "
            "scaling keeps wall time flat (efficiency 1.0).  The 2-core "
            "host genuinely parallelizes 2 virtual devices; past that, "
            "shards time-share cores and efficiency reads n_cores/n by "
            "construction — the n<=2 rows are the transferable "
            "evidence.\n\n"
            "| devices | wall s | weak efficiency |\n"
            "|---|---|---|\n"
            + "".join(
                f"| {n} | {result['vdev_weak'][str(n)]['t']} | "
                f"{result['vdev_weak'][str(n)]['efficiency']} |\n"
                for n in (1, 2, 4, 8)
            )
            + "\nNorth-star (BASELINE.md): >=85% efficiency to 2 hosts — "
            f"measured {result['procs']['efficiency']:.1%} at 2 "
            "processes (compute time, startup excluded) on 2 shared "
            "cores; the per-read pipeline shares no state across reads, "
            "so the only multi-host costs are the shard/merge plumbing "
            "measured here and the final output merge.\n"
        )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]),
                        int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
