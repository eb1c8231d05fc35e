"""Alignment pretty printing (-a flag) — wrap_around_DP.c:57-213.

Re-runs the wrap-around DP with the record's stored scoring scheme and
prints the alignment in 50-column blocks, read on top / '|' symbols /
unit copies below, emitted in reverse-order chunks.  Note the C caller
passes the 0-origin rep_start and the function indexes
orgInputString[rep_start-1+i] for i=1.., i.e. the segment
org[rep_start .. rep_end]."""

from __future__ import annotations

import numpy as np

from mtr.records import RepeatRecord
from mtr.oracle.wrap_dp import wrap_dp_fill, traceback
from mtr.utils.encoding import encode_bases

_B = "ACGT"
WIDTH = 50


def pretty_print_alignment(org: np.ndarray, rec: RepeatRecord, out) -> None:
    unit = encode_bases(rec.string)
    mg, mp, ip = rec.match_gain, rec.mismatch_penalty, rec.indel_penalty
    rep_len = rec.rep_end - rec.rep_start + 1
    rep = org[rec.rep_start : rec.rep_start + rep_len]
    D, max_wrd, max_i, max_j = wrap_dp_fill(rep, unit, mg, mp, ip)
    path, _ = traceback(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip)

    inp, sym, reps = [], [], []
    for mv, i, j in path:
        if mv == "M":
            inp.append(_B[rep[i - 1]])
            sym.append("|")
            reps.append(_B[unit[j - 1]])
        elif mv == "X":
            inp.append(_B[rep[i - 1]])
            sym.append(" ")
            reps.append(_B[unit[j - 1]])
        elif mv == "D":
            inp.append("-")
            sym.append(" ")
            reps.append(_B[unit[j - 1]])
        else:  # insertion
            inp.append(_B[rep[i - 1]])
            sym.append(" ")
            reps.append("-")

    out.write(
        f"match gain = {mg}, mismatch penalty = {mp}, indel penalty = {ip}\n\n"
    )
    pos = len(inp)
    i_start = pos - 1
    while i_start >= 0:
        i_end = i_start - WIDTH if -1 <= i_start - WIDTH else -1
        for arr in (inp, sym, reps):
            out.write("".join(arr[i] for i in range(i_start, i_end, -1)))
            out.write("\n")
        out.write("\n")
        i_start -= WIDTH
