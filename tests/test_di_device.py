"""Device DI stencil vs the host oracle: DI ranges must be identical."""

import numpy as np

from mtr.io.fasta import iter_fasta
from mtr.oracle.arena import Arena
from mtr.oracle.directional_index import (
    fill_directional_index_with_end,
    sliding_l1,
)
from mtr.ops.directional_index import sliding_l1_device, di_manhattan_device

FASTA = "/root/reference/test_multiple_TRs/data/3_5.fasta"


def test_sliding_l1_matches_oracle():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 64, 5000).astype(np.int32)
    for w in (5, 20, 80):
        a = sliding_l1(vals, w, 1000)
        b = sliding_l1_device(vals, w, 1000)
        assert np.array_equal(a, b), f"w={w}"


def test_full_di_ranges_match():
    read = next(iter_fasta(FASTA))
    a1, a2 = Arena(), Arena()
    a1.load_read(read.codes)
    a2.load_read(read.codes)
    rsl = 100 if read.length < 1000 else read.length // 10
    di0, de0, dw0 = fill_directional_index_with_end(a1, read.length, rsl)
    di1, de1, dw1 = fill_directional_index_with_end(
        a2, read.length, rsl, di_compute=di_manhattan_device
    )
    assert np.array_equal(di0, di1)
    assert np.array_equal(de0, de1)
    assert np.array_equal(dw0, dw1)


def test_pearson_device_matches_oracle():
    from mtr.oracle.directional_index import (
        init_input_w_rand,
        di_pearson,
    )
    from mtr.ops.directional_index import di_pearson_device

    read = next(iter_fasta(FASTA))
    arena = Arena()
    arena.load_read(read.codes)
    rsl = 100 if read.length < 1000 else read.length // 10
    di_len = read.length + 2 * rsl
    for k, w in ((1, 5), (3, 20), (5, 40)):
        init_input_w_rand(arena, k, read.length, rsl)
        a = di_pearson(arena.input_w_rand, di_len, w, k, rsl)
        b = di_pearson_device(arena.input_w_rand, di_len, w, k, rsl)
        assert np.array_equal(a, b), f"k={k} w={w}"


def test_full_di_pearson_ranges_match():
    from mtr.ops.directional_index import di_pearson_device

    read = next(iter_fasta(FASTA))
    a1, a2 = Arena(), Arena()
    a1.load_read(read.codes)
    a2.load_read(read.codes)
    rsl = 100 if read.length < 1000 else read.length // 10
    di0, de0, dw0 = fill_directional_index_with_end(
        a1, read.length, rsl, manhattan=False
    )
    di1, de1, dw1 = fill_directional_index_with_end(
        a2, read.length, rsl, manhattan=False, di_compute=di_pearson_device
    )
    assert np.array_equal(di0, di1)
    assert np.array_equal(de0, de1)
    assert np.array_equal(dw0, dw1)


def test_sharded_sliding_l1_8dev_matches_oracle():
    # the position-sharded halo-exchange stencil on the virtual 8-device
    # CPU mesh must agree with the host oracle exactly (SURVEY.md 2.13)
    from mtr.parallel.mesh import make_mesh
    from mtr.ops.directional_index import sliding_l1_sharded

    rng = np.random.default_rng(7)
    k = 3
    vals = rng.integers(0, 4**k, 20000).astype(np.int32)
    mesh = make_mesh(8)
    for w in (5, 40, 640):
        n_out = 17000
        a = sliding_l1(vals, w, n_out)
        b = sliding_l1_sharded(vals, w, n_out, mesh, k, halo=2048)
        assert np.array_equal(a, b), f"w={w}"
