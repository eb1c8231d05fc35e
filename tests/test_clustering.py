"""Cross-read clustering stage (legacy phase 2, SURVEY.md 2.12)."""

from mtr.clustering import cluster_repeats
from mtr.records import RepeatRecord
from mtr.oracle.dbg import freq_2mer_array
from mtr.utils.encoding import encode_bases


def mk(unit: str, n_units=10, matches=None):
    rec = RepeatRecord()
    rec.rep_period = len(unit)
    rec.string = unit
    rec.num_freq_unit = n_units
    rec.repeat_len = len(unit) * n_units
    rec.num_matches = matches if matches is not None else rec.repeat_len
    rec.freq_2mer = freq_2mer_array(encode_bases(unit).tolist())
    return rec


def test_identical_units_group():
    recs = [mk("GCT") for _ in range(5)] + [mk("TTAGGC") for _ in range(3)]
    out = cluster_repeats(recs)
    assert len(out) == 8
    rep_ids = {c.rep_id for c in out}
    assert len(rep_ids) == 2
    # larger group sorts first
    assert out[0].group_freq == 5


def test_low_quality_filtered():
    bad = mk("GCT", n_units=1)  # Num_freq_unit <= 1
    out = cluster_repeats([bad])
    assert out == []


def test_rotated_units_same_histogram_merge():
    # cyclic rotations share the wrap-around 2-mer histogram, so they
    # land in one group (the reference's key is (period, histogram))
    recs = [mk("GCT") for _ in range(3)] + [mk("CTG") for _ in range(2)]
    out = cluster_repeats(recs)
    assert len({c.rep_id for c in out}) == 1
    assert out[0].group_freq == 5


def test_device_near_matrix_matches_numpy():
    # the jitted distance kernel (used when G >= _DEVICE_MIN_GROUPS) must
    # agree with the NumPy reduction bit-for-bit
    import numpy as np
    from mtr.clustering import _near_matrix, _device_near_fn

    rng = np.random.default_rng(3)
    n = 300
    hists = rng.integers(0, 50, (n, 16)).astype(np.int64)
    periods = rng.integers(2, 500, n)
    np_near = _near_matrix(hists, periods)  # n below threshold -> numpy
    dev_near = np.asarray(
        _device_near_fn()(hists.astype(np.int32), periods.astype(np.int32))
    )
    assert (np_near == dev_near).all()
