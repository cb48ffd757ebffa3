"""End-to-end device combine step vs the numpy semantics oracle."""

import numpy as np
import pytest

from genomicsdb_tpu.core import formats
from genomicsdb_tpu.ops import merge as M
from genomicsdb_tpu.ops.combine_step import (block_to_args, combine_step,
                                             synthesize_cohort)

INT_MISSING = formats.INT_MISSING


def test_combine_step_matches_oracle():
    blk = synthesize_cohort(num_samples=8, cells_per_sample=32,
                            region_len=1024, seed=7)
    out = combine_step(*block_to_args(blk), max_merged=4, ploidy=2)
    live = np.asarray(out["live"])
    pl_out = np.asarray(out["pl"])
    ad_out = np.asarray(out["ad"])
    gt_out = np.asarray(out["gt"])
    med = np.asarray(out["info_median"])
    med_ok = np.asarray(out["info_median_ok"])
    dp_sum = np.asarray(out["dp_info_sum"])
    B, S = live.shape
    for b in range(B):
        nm = int(blk.rec_num_merged[b])
        st = int(blk.starts[b])
        dp_expect = 0
        for s in range(S):
            # oracle live cell: last cell with col <= start, end >= start
            cols = blk.col[s]
            idx = np.searchsorted(cols, st, side="right") - 1
            exp_live = -1
            if idx >= 0 and blk.end[s, idx] >= st:
                exp_live = idx
            assert live[b, s] == exp_live, (b, s)
            if exp_live < 0:
                assert np.all(pl_out[b, s] == INT_MISSING)
                continue
            c = exp_live
            # build lut row from inv_bs: merged->input; oracle wants
            # input->merged
            inv = blk.inv_bs[b, s]
            n_in = int((inv >= 0).sum())
            lut_row = np.full(n_in, M.LUT_MISSING, dtype=np.int32)
            for m_i, in_a in enumerate(inv[:nm]):
                if 0 <= in_a < n_in:
                    lut_row[in_a] = m_i
            non_ref = blk.nr_bs[b, s] >= 0
            exp_pl = M.remap_by_genotype(
                blk.pl[s, c, :blk.pl_len[s, c]], lut_row, nm, non_ref, 2,
                INT_MISSING)
            np.testing.assert_array_equal(pl_out[b, s, :len(exp_pl)],
                                          exp_pl, err_msg=f"PL b={b} s={s}")
            exp_ad = M.remap_by_alleles(
                blk.ad[s, c, :blk.ad_len[s, c]], lut_row, nm, non_ref,
                False, INT_MISSING)
            np.testing.assert_array_equal(ad_out[b, s, :len(exp_ad)],
                                          exp_ad, err_msg=f"AD b={b} s={s}")
            exp_gt = M.remap_gt_field(blk.gt[s, c], lut_row, nm, non_ref,
                                      contains_phase=False)
            np.testing.assert_array_equal(gt_out[b, s], exp_gt,
                                          err_msg=f"GT b={b} s={s}")
            # DP logic
            dpi = int(blk.dp_info[s, c])
            if dpi == INT_MISSING:
                if int(blk.min_dp[s, c]) != INT_MISSING:
                    dpi = int(blk.min_dp[s, c])
                else:
                    dpi = int(blk.dp[s, c])
            if dpi != INT_MISSING:
                dp_expect += dpi
        assert dp_sum[b] == dp_expect, b
    # medians
    F = blk.info_f.shape[0]
    for f in range(F):
        for b in range(min(B, 64)):
            vals = []
            for s in range(S):
                if live[b, s] >= 0:
                    x = blk.info_f[f, s, live[b, s]]
                    if np.isfinite(x):
                        vals.append(float(x))
            if not vals:
                assert not med_ok[f, b]
            else:
                assert med_ok[f, b]
                assert med[f, b] == sorted(vals)[len(vals) // 2]


def test_combine_step_dense_matches():
    """Host pre-gather + combine_step_dense == combine_step outputs."""
    import numpy as np
    from genomicsdb_tpu.ops.combine_step import (
        block_to_args, combine_step, combine_step_dense,
        gather_block_host, live_cells_at_host, synthesize_cohort)
    blk = synthesize_cohort(num_samples=8, cells_per_sample=32,
                            region_len=2048, seed=3)
    live = live_cells_at_host(blk.starts, blk.col, blk.end)
    blk.live = live
    ref = combine_step(*block_to_args(blk), max_merged=4, ploidy=2)
    g = gather_block_host(blk, live)
    out = combine_step_dense(
        g["plg"], g["invg"], g["pllg"], g["nrg"], g["adg"], g["adlg"],
        g["gtg"], g["gqg"], g["dpfg"], g["mdpg"], g["dpig"], g["infog"],
        g["infoig"], g["infofsg"], g["valid"], blk.rec_num_merged,
        max_merged=4, ploidy=2)
    for key in ("pl", "ad", "gt", "dp_info_sum", "gq", "dp_format",
                "min_dp", "info_fsum", "info_imedian", "info_median"):
        a, b = np.asarray(ref[key]), np.asarray(out[key])
        if a.dtype.kind == "f":
            assert np.allclose(a, b, equal_nan=True), key
        else:
            assert np.array_equal(a, b), key


# ---------------------------------------------------------------------------
# The XLA combine_step against the per-record oracle (ops/merge.py) across
# ploidy, per-call ploidy, phased GT, odd shapes, the row restrictions the
# block writer uses, and the narrow pack/fetch round trip.

OUT_KEYS = ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "live",
            "info_median", "info_median_ok", "info_imedian",
            "info_imedian_ok", "info_fsum", "info_fsum_ok", "dp_info_sum")


def _oracle_check(blk, out, ploidy, mixed=False, gt_phase=False):
    """Every live (record, sample) cell's PL/AD/GT, each record's DP sum
    and the float medians equal the sequential oracle's values."""
    live = np.asarray(out["live"])
    pl_out, ad_out, gt_out = (np.asarray(out[k]) for k in ("pl", "ad",
                                                           "gt"))
    dp_sum = np.asarray(out["dp_info_sum"])
    B, S = live.shape
    for b in range(B):
        nm = int(blk.rec_num_merged[b])
        dp_expect = 0
        for s in range(S):
            c = int(live[b, s])
            if c < 0:
                continue
            inv = blk.inv_bs[b, s]
            n_in = int((inv >= 0).sum())
            lut_row = np.full(n_in, M.LUT_MISSING, dtype=np.int32)
            for m_i, in_a in enumerate(inv[:nm]):
                if 0 <= in_a < n_in:
                    lut_row[in_a] = m_i
            non_ref = blk.nr_bs[b, s] >= 0
            p = int(blk.gt_len_bs[b, s]) if mixed else ploidy
            exp_pl = M.remap_by_genotype(
                blk.pl[s, c, :blk.pl_len[s, c]], lut_row, nm, non_ref, p,
                INT_MISSING)
            np.testing.assert_array_equal(pl_out[b, s, :len(exp_pl)],
                                          exp_pl, err_msg=f"PL {b},{s}")
            exp_ad = M.remap_by_alleles(
                blk.ad[s, c, :blk.ad_len[s, c]], lut_row, nm, non_ref,
                False, INT_MISSING)
            np.testing.assert_array_equal(ad_out[b, s, :len(exp_ad)],
                                          exp_ad, err_msg=f"AD {b},{s}")
            gt_in = blk.gt[s, c][:p] if mixed else blk.gt[s, c]
            exp_gt = M.remap_gt_field(gt_in, lut_row, nm, non_ref,
                                      contains_phase=gt_phase)
            np.testing.assert_array_equal(gt_out[b, s, :len(exp_gt)],
                                          exp_gt, err_msg=f"GT {b},{s}")
            if mixed:
                assert (gt_out[b, s, p:] == formats.INT_VECTOR_END).all()
            dpi = int(blk.dp_info[s, c])
            if dpi == INT_MISSING:
                dpi = int(blk.min_dp[s, c]) \
                    if int(blk.min_dp[s, c]) != INT_MISSING \
                    else int(blk.dp[s, c])
            if dpi != INT_MISSING:
                dp_expect += dpi
        assert dp_sum[b] == dp_expect, b
    med, med_ok = np.asarray(out["info_median"]), \
        np.asarray(out["info_median_ok"])
    for f in range(blk.info_f.shape[0]):
        for b in range(min(B, 48)):
            vals = sorted(float(blk.info_f[f, s, live[b, s]])
                          for s in range(S) if live[b, s] >= 0
                          and np.isfinite(blk.info_f[f, s, live[b, s]]))
            assert bool(med_ok[f, b]) == bool(vals)
            if vals:
                assert med[f, b] == vals[len(vals) // 2]


def _assert_same(ref, got, rows=None):
    for key in OUT_KEYS:
        a, b = np.asarray(ref[key]), np.asarray(got[key])
        if rows is not None and key in ("pl", "ad", "gt", "gq",
                                        "dp_format", "min_dp"):
            a = a[rows]
            b = b[:len(rows)]
        np.testing.assert_array_equal(np.isnan(a) if a.dtype.kind == "f"
                                      else a,
                                      np.isnan(b) if b.dtype.kind == "f"
                                      else b, err_msg=key)
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(np.nan_to_num(a),
                                          np.nan_to_num(b), err_msg=key)


def _phased(blk):
    """Diploid GT rewritten with an interleaved phase slot: [a0, |, a1]."""
    rng = np.random.default_rng(5)
    flag = rng.integers(0, 2, size=blk.gt.shape[:2] + (1,)).astype(np.int32)
    blk.gt = np.concatenate([blk.gt[..., :1], flag, blk.gt[..., 1:]], -1)
    return blk


CASES = {
    **{f"ploidy{p}": dict(ploidy=p) for p in range(1, 7)},
    **{f"mixed_pmax{p}": dict(ploidy=p, mixed=True) for p in (2, 3, 6)},
    "phased_gt": dict(ploidy=2, phased=True),
    "odd_B_S": dict(ploidy=2, samples=5, cells=37, region=2999),
    "med_rows": dict(ploidy=2, restrict="med"),
    "remap_rows": dict(ploidy=2, restrict="remap"),
    "pack_fetch": dict(ploidy=2, restrict="pack"),
    "pack_fetch_rows": dict(ploidy=2, restrict="pack_rows"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_combine_step_cases(case):
    from genomicsdb_tpu.ops.combine_step import (fetch_outputs,
                                                 fetch_outputs_split,
                                                 pack_outputs)
    kw = CASES[case]
    ploidy = kw["ploidy"]
    blk = synthesize_cohort(num_samples=kw.get("samples", 6),
                            cells_per_sample=kw.get("cells", 40),
                            region_len=kw.get("region", 3000),
                            seed=len(case), ploidy=ploidy)
    mixed = kw.get("mixed", False)
    if mixed:
        rng = np.random.default_rng(3)
        blk.gt_len_bs = rng.integers(1, ploidy + 1,
                                     size=blk.live.shape).astype(np.int32)
    if kw.get("phased"):
        blk = _phased(blk)
    out = combine_step(*block_to_args(blk), max_merged=4, ploidy=ploidy,
                       gt_phase=kw.get("phased", False), mixed_ploidy=mixed)
    restrict = kw.get("restrict")
    B = blk.live.shape[0]
    rows = np.arange(1, B, 3, dtype=np.int32)
    if restrict is None:
        _oracle_check(blk, out, ploidy, mixed, kw.get("phased", False))
    elif restrict == "med":
        got = combine_step(*block_to_args(blk), med_rows=rows,
                           max_merged=4, ploidy=ploidy)
        for key in ("info_median", "info_imedian", "info_fsum"):
            for k in (key, key + "_ok"):
                np.testing.assert_array_equal(
                    np.nan_to_num(np.asarray(got[k])),
                    np.nan_to_num(np.asarray(out[k])[:, rows]), err_msg=k)
    elif restrict == "remap":
        got = combine_step(*block_to_args(blk), remap_rows=rows,
                           max_merged=4, ploidy=ploidy)
        _assert_same(out, got, rows)
    elif restrict == "pack":
        host = fetch_outputs(out, pack_outputs(out))
        _assert_same(out, host)
    else:
        ref_rows = np.setdiff1d(np.arange(B), rows)
        full = {k: np.asarray(v) for k, v in out.items()}
        ident = {k: full[k][ref_rows] for k in ("pl", "ad", "gt", "gq",
                                                "dp_format", "min_dp")}
        host = fetch_outputs_split(out, pack_outputs(out, rows=rows), rows,
                                   ref_rows, ident)
        host["live"] = full["live"]
        _assert_same(out, host)
