"""MT19937 correctness against published MT19937 test vectors."""

import numpy as np

from mtr.utils.mt19937 import MT19937


def test_seed_5489_known_values():
    # canonical first outputs of mt19937 with the default seed
    m = MT19937(5489)
    assert [m.genrand_int32() for _ in range(3)] == [
        3499211612,
        581869302,
        3890346734,
    ]


def test_seed_0_values():
    # verified against the reference binary's MT (seed 0, draws 1-5)
    m = MT19937(0)
    assert list(m.random_uint32(5)) == [
        2357136044,
        2546248239,
        3071714933,
        3626093760,
        2588848963,
    ]


def test_block_boundary():
    # draws 2001-2003 cross multiple twist regenerations (seed 0)
    m = MT19937(0)
    m.random_uint32(2000)
    assert list(m.random_uint32(3)) == [2546401361, 3952537117, 43223238]


def test_scalar_vector_agree():
    a, b = MT19937(42), MT19937(42)
    assert [a.genrand_int32() for _ in range(1500)] == list(b.random_uint32(1500))


def test_random_bases_mod4():
    m1, m2 = MT19937(0), MT19937(0)
    assert np.array_equal(m1.random_bases(100), m2.random_uint32(100) % 4)
