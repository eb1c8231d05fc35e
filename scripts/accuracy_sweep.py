"""Accuracy sweep — the test_single_TR/test.sh harness.

For each unit length, generates synthetic single-TR reads with the
reference error profile, runs the detector, and reports the exact
cyclic-unit match count plus the comp_mTR_DP ratio buckets
(>=1 / 0.99 / 0.98 / 0.96 / 0.94), mirroring test.sh:32-61.

Usage: python scripts/accuracy_sweep.py [--reads N] [--backend B]
       [--lengths 2,5,10,20,50,100,200] [--freq 10]
"""

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100)
    ap.add_argument("--backend", default="host")
    ap.add_argument("--lengths", default="2,5,10,20,50,100,200")
    ap.add_argument("--freq", type=int, default=10)
    ap.add_argument("--seed", type=int, default=12345)
    args = ap.parse_args()

    from mtr.testutil.rand_seq import write_fasta
    from mtr.testutil.evaluators import count_match, comp_dp
    from mtr.config import MTRConfig
    from mtr.pipeline import run_file

    sub, ins, dele = 1.6, 9.0, 3.8  # test.sh:12-14
    for i in (int(x) for x in args.lengths.split(",")):
        j = args.freq
        flank = i * j
        fasta = f"/tmp/sweep_{i}_{j}.fasta"
        units_f = f"/tmp/sweep_{i}_{j}.units"
        write_fasta(fasta, units_f, i, j, sub, ins, dele, flank, flank,
                    args.reads, seed=args.seed)
        out = io.StringIO()
        t0 = time.time()
        run_file(fasta, MTRConfig(backend=args.backend), out)
        dt = time.time() - t0
        lines = out.getvalue().splitlines()
        truth = [ln.strip() for ln in open(units_f)]
        exact = count_match(lines, truth)
        ratios = comp_dp(lines, truth)
        buckets = {
            t: sum(1 for r in ratios if r >= t) for t in (1, 0.99, 0.98, 0.96, 0.94)
        }
        print(
            f"unit={i:>3} x{j}: exact={exact}/{args.reads}  "
            + "  ".join(f">={t}:{n}" for t, n in buckets.items())
            + f"  ({args.reads/dt:.1f} reads/s)"
        )


if __name__ == "__main__":
    main()
