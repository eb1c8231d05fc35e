"""Chaining quirk unit tests (chaining.cpp semantics)."""

from mtr.chaining import chain_records
from mtr.records import RepeatRecord


def rec(start, end, matches):
    r = RepeatRecord()
    r.rep_start = start
    r.rep_end = end
    r.num_matches = matches
    r.repeat_len = end - start
    return r


def test_single_record():
    out = chain_records([rec(100, 200, 90)])
    assert len(out) == 1


def test_non_overlapping_chain():
    a, b = rec(100, 200, 90), rec(300, 400, 80)
    out = chain_records([a, b])
    assert [o.rep_start for o in out] == [100, 300]


def test_overlapping_picks_best():
    # two alignments covering the same span; the higher score wins,
    # the dominated one is evicted from the Y list
    a, b = rec(100, 400, 50), rec(100, 400, 200)
    out = chain_records([a, b])
    assert len(out) == 1 and out[0].num_matches == 200


def test_short_span_excluded():
    # start_x + 10 > end_x: no events at all (chaining.cpp:255-258)
    a, b = rec(100, 105, 5), rec(200, 400, 100)
    out = chain_records([a, b])
    assert [o.rep_start for o in out] == [200]


def test_span_exactly_ten_never_enters_y():
    # start_x + 10 == end_x: both events satisfy isStart() so the
    # alignment never enters the Y list (chaining.cpp:189-194 quirk)
    a = rec(100, 110, 10)
    out = chain_records([a])
    assert out == []


def test_predecessor_link_allows_small_overlap():
    # predecessor rule: end_y <= start_y + 10
    a, b = rec(100, 205, 100), rec(210, 400, 100)
    out = chain_records([a, b])
    assert len(out) == 2
    assert out[0].rep_start == 100


def test_empty():
    assert chain_records([]) == []
