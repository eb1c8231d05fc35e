"""Counts-mode wrap-DP engine (ops/wrap_dp_counts.py) vs the scalar
oracle: counts, positions and argmax must be bit-identical (the oracle
is verified byte-level against the reference binary,
wrap_around_DP.c:222-354).  Here the dispatcher runs its CPU engine,
ops/wrap_dp_xla.py; chip_smoke.py runs the same job sets through the
CUDA kernel on the card.  The cases span unit buckets 8-512, row
buckets up to 65536, all three schemes, deletion-heavy random reads
and degenerate one-base jobs."""

import numpy as np
import pytest

from mtr.testutil.dp_jobs import engine_rows, mismatches, rand_jobs


def _degenerate(_rng):
    return [
        (np.zeros(1, np.int32), np.array([1, 2], np.int32), (1, 1, 3)),
        (np.array([3], np.int32), np.array([3, 3], np.int32), (1, 1, 3)),
        (np.zeros(5, np.int32), np.zeros(2, np.int32) + 2, (1, 3, 1)),
    ]


def _tiled(rng, n, unit_len, copies, rep_len, err_every, scheme=(1, 1, 3)):
    jobs = []
    for _ in range(n):
        unit = rng.integers(0, 4, unit_len).astype(np.int32)
        rep = np.tile(unit, copies)[:rep_len].copy()
        rep[::err_every] = rng.integers(0, 4, len(rep[::err_every]))
        jobs.append((rep.astype(np.int32), unit, scheme))
    return jobs


def _long_units(rng):
    # units 129-256, both main schemes
    jobs = []
    for ul in (129, 150, 200, 255, 256):
        unit = rng.integers(0, 4, ul).astype(np.int32)
        rep = np.tile(unit, 3)[: ul * 2 + 37].copy()
        rep[::13] = rng.integers(0, 4, len(rep[::13]))
        jobs.append((rep, unit, (1, 1, 3)))
        jobs.append((rep, unit, (1, 3, 1)))
    return jobs


def _wide_deletion_heavy(rng):
    # ip=1 opens long in-row deletion chains across many columns and
    # through the wrap column
    jobs = rand_jobs(rng, 16, 80, 40, scheme=(1, 3, 1), periodic=False)
    for ul in (140, 200):
        unit = rng.integers(0, 4, ul).astype(np.int32)
        rep = rng.integers(0, 4, 3 * ul).astype(np.int32)
        jobs.append((rep, unit, (1, 3, 1)))
    return jobs


def _wide_multi_tile(rng):
    jobs = []
    for ul in (150, 200):
        unit = rng.integers(0, 4, ul).astype(np.int32)
        rep = np.tile(unit, 4)[: ul * 3 + 11].copy()
        rep[::7] = rng.integers(0, 4, len(rep[::7]))
        jobs.append((rep, unit, (1, 1, 3)))
    return jobs


def _pack2_bucket(rng):
    jobs = rand_jobs(rng, 6, 300, 40)
    unit = rng.integers(0, 4, 200).astype(np.int32)
    rep = np.tile(unit, 3)[:500].copy()
    rep[::9] = rng.integers(0, 4, len(rep[::9]))
    jobs.append((rep, unit, (1, 1, 3)))
    return jobs


def _noisy_batch(scheme):
    # planted repeats of units 2-39 with 1/8 errors, rep_len 10-255
    def make(rng):
        jobs = []
        for _ in range(8):
            ul = int(rng.integers(2, 40))
            rl = int(rng.integers(10, 256))
            unit = rng.integers(0, 4, ul)
            rep = np.tile(unit, rl // ul + 1)[:rl].copy()
            nse = rng.integers(0, rl, max(1, rl // 8))
            rep[nse] = rng.integers(0, 4, len(nse))
            jobs.append((rep.astype(np.int32), unit.astype(np.int32), scheme))
        return jobs
    return make


def _production_limits(rng):
    # the largest unit (500, u_pad 512) under the polish re-score
    # scheme (5,1,1): the largest scores a counts job produces
    return _tiled(rng, 4, 500, 4, 1900, 11, scheme=(5, 1, 1)) + \
        _tiled(rng, 4, 497, 4, 1500, 5, scheme=(1, 3, 1))


# (case, seed, job-set maker, u_pad, r_pad)
CASES = [
    ("small_fuzz_u32", 0, lambda r: rand_jobs(r, 48, 60, 30), 32, 64),
    ("tiny_units_u8", 1, lambda r: rand_jobs(r, 48, 80, 7), 8, 128),
    ("deletion_heavy_u32", 2, lambda r: rand_jobs(
        r, 32, 60, 30, scheme=(1, 3, 1), periodic=False), 32, 64),
    ("scheme511_u32", 3, lambda r: rand_jobs(
        r, 32, 50, 20, scheme=(5, 1, 1)), 32, 64),
    ("unit_at_pad_boundary_u8", 4, lambda r: _tiled(r, 16, 8, 6, 40, 7),
     8, 64),
    ("degenerate_u8", 0, _degenerate, 8, 8),
    ("production_limits_u512", 5, _production_limits, 512, 4096),
    ("small_fuzz_u128", 10, lambda r: rand_jobs(r, 48, 60, 30), 128, 128),
    ("tiny_units_u128", 11, lambda r: rand_jobs(r, 48, 80, 7), 128, 128),
    ("deletion_heavy_u128", 12, lambda r: rand_jobs(
        r, 32, 60, 30, scheme=(1, 3, 1), periodic=False), 128, 128),
    ("scheme511_u128", 13, lambda r: rand_jobs(
        r, 32, 50, 20, scheme=(5, 1, 1)), 128, 128),
    ("unit_at_lane_boundary_u128", 14, lambda r: _tiled(r, 8, 128, 4, 400, 11),
     128, 512),
    ("multi_tile_u128", 15, lambda r: rand_jobs(r, 12, 500, 60), 128, 512),
    ("degenerate_u128", 0, _degenerate, 128, 128),
    ("bucket_32768_u128", 17, lambda r: rand_jobs(r, 8, 300, 40) + rand_jobs(
        r, 4, 200, 25, scheme=(1, 3, 1), periodic=False), 128, 32768),
    ("long_units_u256", 20, _long_units, 256, 1024),
    ("small_units_u256", 21, lambda r: rand_jobs(r, 32, 60, 30) + rand_jobs(
        r, 32, 80, 7), 256, 128),
    ("deletion_heavy_u256", 22, _wide_deletion_heavy, 256, 1024),
    ("scheme511_u256", 23, lambda r: rand_jobs(
        r, 16, 50, 20, scheme=(5, 1, 1)), 256, 128),
    ("multi_tile_u256", 24, _wide_multi_tile, 256, 1024),
    ("bucket_32768_u256", 25, _pack2_bucket, 256, 32768),
    ("bucket_65536_u256", 26, lambda r: rand_jobs(r, 4, 250, 35), 256, 65536),
    ("degenerate_u256", 0, _degenerate, 256, 128),
    ("noisy_113_u128", 7, _noisy_batch((1, 1, 3)), 128, 256),
    ("noisy_131_u128", 7, _noisy_batch((1, 3, 1)), 128, 256),
    ("noisy_511_u128", 7, _noisy_batch((5, 1, 1)), 128, 256),
    ("noisy_511_polish_set_u128", 3, _noisy_batch((5, 1, 1)), 128, 256),
]


@pytest.mark.parametrize("name,seed,make,u_pad,r_pad", CASES,
                         ids=[c[0] for c in CASES])
def test_counts_engine_matches_oracle(name, seed, make, u_pad, r_pad):
    jobs = make(np.random.default_rng(seed))
    rows = engine_rows("xla", jobs, u_pad, r_pad)
    assert not mismatches(rows, jobs)


# ---- the dispatcher and the device batcher around it -------------------

import mtr.ops.wrap_dp_counts as C  # noqa: E402
import mtr.pipeline as P  # noqa: E402


def test_engine_choice_per_platform():
    assert C.engine_for("gpu") == "cuda"
    assert C.engine_for("cpu") == "xla"
    assert C.default_engine() == "xla"  # the test mesh is XLA's CPU


@pytest.mark.parametrize("rep_len,xla_r", [(1, 4096), (4096, 4096),
                                           (4097, 32768), (70000, 262144),
                                           (2_000_000, 1048576)])
def test_row_bucket(rep_len, xla_r):
    assert C.row_bucket("xla", rep_len) == xla_r
    assert C.row_bucket("cuda", rep_len) == 0  # each warp runs its own rows


@pytest.mark.parametrize("unit_len,u_pad", [(2, 8), (8, 8), (9, 32),
                                            (33, 64), (100, 128),
                                            (129, 256), (500, 512)])
def test_unit_bucket(unit_len, u_pad):
    assert C.bucket(unit_len, C.U_BUCKETS) == u_pad


def _read_jobs(seed=5):
    """Counts jobs on two reads: units 2-300, both schemes."""
    rng = np.random.default_rng(seed)
    orgs = [rng.integers(0, 4, 3001).astype(np.int32) for _ in range(2)]
    jobs = []
    for q in range(40):
        org = orgs[q % 2]
        ul = int(rng.choice([2, 7, 30, 100, 150, 300]))
        unit = org[100 : 100 + ul].copy()
        qs = int(rng.integers(0, 1500))
        qe = qs + int(rng.integers(ul, 1400))
        jobs.append(P.DPJob(org, qs, qe, unit,
                            ((1, 1, 3), (1, 3, 1))[q % 2]))
    return jobs


def _host_results(jobs):
    ref = [P.DPJob(j.org, j.qs, j.qe, j.unit, j.scheme) for j in jobs]
    P.HostDPBatcher()._run(ref)
    return [j.result for j in ref]


def test_batcher_matches_host_engine():
    jobs = _read_jobs()
    P.WrapDPBatcher()._run(jobs)  # registers its reads itself
    assert [j.result for j in jobs] == _host_results(jobs)


def test_batcher_shapes_per_engine(monkeypatch):
    """XLA chunks bucket rows; CUDA chunks do not, so one chunk per unit
    bucket; every batch is a power of two holding its chunk."""
    calls = []
    real = C.counts_fn

    def spy(engine, b, u_pad, r_pad):
        calls.append((engine, b, u_pad, r_pad))
        return real("xla", b, u_pad, r_pad or 4096)

    jobs = _read_jobs()
    monkeypatch.setattr(C, "counts_fn", spy)
    P.WrapDPBatcher()._run(jobs)
    assert {c[0] for c in calls} == {"xla"}
    assert {c[3] for c in calls} == {4096}
    calls.clear()
    monkeypatch.setattr(P.WrapDPBatcher, "_engine", lambda self: "cuda")
    P.WrapDPBatcher()._run(jobs)
    assert all(c[0] == "cuda" and c[3] == 0 for c in calls)
    assert sorted(c[2] for c in calls) == [8, 32, 128, 256, 512]
    n_per_u = {}
    for j in jobs:
        u = C.bucket(len(j.unit), C.U_BUCKETS)
        n_per_u[u] = n_per_u.get(u, 0) + 1
    for _, b, u_pad, _ in calls:
        assert b == max(8, 1 << (n_per_u[u_pad] - 1).bit_length())
    assert [j.result for j in jobs] == _host_results(jobs)


def test_padding_rows_and_row_layout():
    """Padding rows (rep_len 0) come back as empty finished rows, and the
    (B, 15) layout repeats m / ins / i_final in columns 11-13."""
    rng = np.random.default_rng(9)
    jobs = rand_jobs(rng, 3, 90, 12)
    rows = engine_rows("xla", jobs, 32, 4096, b=8)
    assert rows.shape == (8, 15) and rows.dtype == np.int32
    assert not mismatches(rows, jobs)
    assert (rows[3:] == [0] * 6 + [1] + [0] * 8).all()
    assert (rows[:3, 11] == rows[:3, 0]).all()
    assert (rows[:3, 12] == rows[:3, 2]).all()
    assert (rows[:3, 13] == rows[:3, 5]).all()
    assert (rows[:, 7] == 0).all() and (rows[:, 14] == 0).all()


def test_cuda_library_not_loaded_on_cpu():
    from mtr.ops import wrap_dp_cuda

    P.WrapDPBatcher()._run(_read_jobs(6))
    assert not wrap_dp_cuda.loaded()


@pytest.mark.gpu
def test_cuda_counts_match_oracle_on_card():
    """The CUDA kernel itself; chip_smoke.py runs this on the card."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")
    for name, seed, make, u_pad, _r_pad in CASES:
        jobs = make(np.random.default_rng(seed))
        assert not mismatches(engine_rows("cuda", jobs, u_pad, 0), jobs), name
