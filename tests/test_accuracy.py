"""Statistical accuracy harness (test_single_TR/test.sh equivalent).

The reference binary scores 62/100 exact cyclic-unit matches on the
unit=100 x10 workload at the 1.6/9.0/3.8% error profile (BASELINE.md);
our detector is byte-identical on fixed inputs, so the same statistical
range must hold on freshly generated sets.
"""

import io

import pytest

from mtr.testutil.rand_seq import write_fasta
from mtr.testutil.evaluators import count_match, comp_dp
from mtr.config import MTRConfig
from mtr.pipeline import run_file


def run_sweep(unit_len, freq, n_reads, seed=777):
    fasta = f"/tmp/acc_{unit_len}_{freq}.fasta"
    units_f = f"/tmp/acc_{unit_len}_{freq}.units"
    write_fasta(fasta, units_f, unit_len, freq, 1.6, 9.0, 3.8,
                unit_len * freq, unit_len * freq, n_reads, seed=seed)
    out = io.StringIO()
    run_file(fasta, MTRConfig(backend="host"), out)
    truth = [ln.strip() for ln in open(units_f)]
    lines = out.getvalue().splitlines()
    return count_match(lines, truth), comp_dp(lines, truth)


@pytest.mark.slow
def test_accuracy_unit100():
    # byte parity with the reference makes these counts DETERMINISTIC for
    # the fixed seed: pin them exactly so any 1-read regression fails.
    # 35/50 exact = 70%, consistent with the reference's ~62% statistical
    # level on this profile (BASELINE.md; seed-to-seed variance).
    exact, ratios = run_sweep(100, 10, 50)
    assert exact == 35, f"exact={exact}/50 (expected exactly 35)"
    assert sum(1 for r in ratios if r >= 0.99) == 48
    assert sum(1 for r in ratios if r >= 0.98) == 49


@pytest.mark.slow
def test_accuracy_unit5():
    exact, ratios = run_sweep(5, 10, 50)
    assert exact == 49, f"exact={exact}/50 (expected exactly 49)"
    assert sum(1 for r in ratios if r >= 0.98) == 49
