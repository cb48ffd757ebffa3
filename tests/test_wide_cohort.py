"""1000-sample cohort lane (the reference's GATK joint-genotyping
scale): block==sequential on sampled windows, chunk-invariant output.

The full chromosome-scale bench lives in tools/wide_cohort_bench.py
(a bench.py lane); the 1000-sample correctness run is
slow (~2 min) and marked `slow` — select with `pytest -m slow`.
A 200-sample variant runs in the default suite."""

import pytest

from genomicsdb_tpu.tools.wide_cohort_bench import run


def test_wide_cohort_200():
    out = run(n_samples=200, n_records=400, n_windows=3)
    assert out["seq_windows_verified"] == 3
    assert out["lines"] == 400


@pytest.mark.slow
def test_wide_cohort_1000():
    out = run(n_samples=1000, n_records=600, n_windows=3)
    assert out["seq_windows_verified"] == 3
    assert out["lines"] == 600
