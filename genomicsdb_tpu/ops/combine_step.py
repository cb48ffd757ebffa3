"""End-to-end batched combine step (the flagship device computation).

One jit-compiled call performs, for a block of B aligned intervals over S
samples, everything the reference's per-position operator stack does
per record (scan_and_operate -> BroadCombinedGVCFOperator::operate,
query_variants.cc:334 / broad_combined_gvcf.cc:765) — as dense gathers and
masked reductions:

  1. live-cell selection per (interval, sample)     [host sweep / gather]
  2. PL genotype reorder onto merged alleles        [table gather]
  3. AD allele reorder                              [gather]
  4. GT remap + encode                              [gather + bit math]
  5. INFO combine ops: median (RankSums/MQ/MQ0), sum (RAW_MQ), DP logic
  6. GQ / MIN_DP / DP FORMAT collection

Allele LUTs are per (record, sample) — `inv_bs [B, S, M]` maps each
merged allele of record b to sample s's input allele (-1 absent).  This
is the gathered form directly consumable by the remap kernels; building
it host-side (store_block.py) lets spanning deletions and multi-position
variant cells use different LUTs per record, which a per-cell LUT cannot
express.

The same math (`_combine_math`) backs three execution modes:
  * combine_step        — gathers [S, C] cell tensors on device
  * combine_step_dense  — host-pre-gathered inputs (PCIe-host config)
  * parallel.sharded    — shard_map over a (pos, row) device mesh with
    collectives (NCCL on GPUs) for the cross-sample reductions
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..core import formats
from . import jax_kernels as K

INT_MISSING = formats.INT_MISSING


@dataclass
class CellBlock:
    """Dense per-row cell layout for one column-partition block.

    S samples x C cells per sample (padded); B aligned intervals.
    All int32 except coordinates.
    """
    col: np.ndarray        # [S, C] int64, padded with INT64_MAX
    end: np.ndarray        # [S, C] int64 effective ENDs
    pl: np.ndarray         # [S, C, G_in] int32 padded INT_MISSING
    pl_len: np.ndarray     # [S, C] int32
    ad: np.ndarray         # [S, C, A_in] int32
    ad_len: np.ndarray     # [S, C]
    gt: np.ndarray         # [S, C, P] int32 allele idxs (-1 no-call)
    gq: np.ndarray         # [S, C] int32 (INT_MISSING invalid)
    dp: np.ndarray         # [S, C] int32 FORMAT DP
    min_dp: np.ndarray     # [S, C] int32
    dp_info: np.ndarray    # [S, C] int32 INFO DP
    info_f: np.ndarray     # [F, S, C] float32 scalar INFO fields, MEDIAN op
    info_i: np.ndarray     # [Fi, S, C] int32 scalar INFO fields, MEDIAN op
    info_fs: np.ndarray    # [Fs, S, C] float32 scalar INFO fields, SUM op
    inv_bs: np.ndarray     # [B, S, M] merged->input allele idx (-1 absent)
    nr_bs: np.ndarray      # [B, S] input NON_REF allele idx (-1 none)
    # per-interval (precomputed by the sweep):
    starts: np.ndarray     # [B] int64 interval starts
    rec_num_merged: np.ndarray  # [B] int32 merged alleles per record
    rec_has_nr: np.ndarray = None  # [B] bool: merged alleles include
    # NON_REF (gates the GT remap's absent-allele fallback,
    # variant_operations.cc:233-260 non_ref_exists)
    live: np.ndarray = None  # [B, S] int32 live cell idx (-1 none); host-
    # precomputed (device derivation is a slow scalar-core gather)
    del_rw: np.ndarray = None  # [B, S] bool: call was spanning-deletion-
    # rewritten -> its INFO combine contributions are invalidated
    # (broad_combined_gvcf.cc:1066-1075)
    gt_len_bs: np.ndarray = None  # [B, S] int32 stored GT length of the
    # live call (0 = missing); drives per-call ploidy for general-ploidy
    # cohorts
    ploidy: int = 2            # max ploidy the block is sized for
    gt_phase: bool = False     # GT stored with interleaved phase slots


def _gather_cells(x: jnp.ndarray, live: jnp.ndarray) -> jnp.ndarray:
    """x: [S, C, ...]; live: [B, S] cell idx (-1 none) -> [B, S, ...]."""
    idx = jnp.clip(live, 0, x.shape[1] - 1)
    out = jax.vmap(lambda xs, ls: xs[ls], in_axes=(0, 1), out_axes=1)(x, idx)
    return out


def gt_remap_unrolled(gtg: jnp.ndarray, invg: jnp.ndarray,
                      rec_num_merged: jnp.ndarray,
                      rec_has_nr: jnp.ndarray,
                      gt_phase: bool = False,
                      gt_lens=None) -> jnp.ndarray:
    """GT remap: input allele -> merged allele (invert inv_bs).  Ploidy
    and merged-allele axes are unrolled statically so every tensor stays
    [B, S] (a [B,S,A,M] one-hot costs ~4x the whole step in HBM traffic).
    Matches VariantOperations::remap_GT_field
    (variant_operations.cc:233-260): with `gt_phase`, odd slots are
    interleaved phase flags and pass through unremapped; an input allele
    absent from the merge maps to NON_REF only when the merge has one."""
    M_dim = invg.shape[-1]
    P_dim = gtg.shape[-1]
    nr_merged = jnp.where(rec_has_nr, rec_num_merged - 1, -1)[:, None]
    gt_cols = []
    for p in range(P_dim):
        a = gtg[..., p]                                 # [B, S]
        if gt_phase and p % 2 == 1:
            out_p = a                                   # phase flag slot
        else:
            merged = jnp.full_like(a, -1)
            for m in range(M_dim):
                merged = jnp.where(invg[..., m] == a, m, merged)
            ok = (a >= 0) & (a != INT_MISSING)
            out_p = jnp.where(ok, jnp.where(merged >= 0, merged,
                                            nr_merged), a)
        if gt_lens is not None:
            # slots past the call's stored GT length are VECTOR_END so
            # the renderer stops there (variable-ploidy cohorts)
            out_p = jnp.where(jnp.int32(p) < gt_lens, out_p,
                              formats.INT_VECTOR_END)
        gt_cols.append(out_p)
    return jnp.stack(gt_cols, axis=-1)


def masked_seq_sum_float(vals: jnp.ndarray, ok: jnp.ndarray):
    """Float sum over the LAST axis in ascending index order — bit-exact
    against the sequential writer's np.float32 left-fold accumulation
    (a tree-order jnp.sum may round differently).  vals: [..., S]."""
    S = vals.shape[-1]
    init = jnp.zeros(vals.shape[:-1], jnp.float32)
    if S <= 64:
        out = init
        for s in range(S):
            out = jnp.where(ok[..., s], out + vals[..., s], out)
    else:
        def body(s, acc):
            return jnp.where(ok[..., s], acc + vals[..., s], acc)
        out = jax.lax.fori_loop(0, S, body, init)
    return out, ok.any(axis=-1)


def _combine_math(plg, invg, pllg, nrg, adg, adlg, gtg, gqg, dpfg, mdpg,
                  dpig, infog, infoig, infofsg, valid, rec_num_merged,
                  rec_has_nr, gt_lens=None, med_rows=None, *,
                  max_merged: int, ploidy: int, gt_phase: bool = False,
                  mixed_ploidy: bool = False,
                  axis_name: Optional[str] = None
                  ) -> Dict[str, jnp.ndarray]:
    """The shared combine math over GATHERED (dense [B, S, ...]) inputs.

    With `axis_name` set (inside shard_map over the sample axis), the
    cross-sample reductions all_gather the full sample axis first and
    then run the identical local math — results are bit-identical to the
    unsharded path by construction.
    """
    pl_out, ad_out, gt_out = _remap_math(
        plg, invg, pllg, nrg, adg, adlg, gtg, rec_num_merged,
        rec_has_nr, gt_lens, max_merged=max_merged, ploidy=ploidy,
        gt_phase=gt_phase, mixed_ploidy=mixed_ploidy)

    if med_rows is not None:
        # INFO median/sum reductions (the only sort on the hot path)
        # restricted to the rows that carry ANY valid median/sum input
        # (meta.med_rows, a host-exact superset of device validity) —
        # outputs come back [F, len(med_rows)] and the writer scatters
        # them to full width with ok=False elsewhere, which is exactly
        # what full-width computation would have produced
        infog = infog[:, med_rows]
        infoig = infoig[:, med_rows]
        infofsg = infofsg[:, med_rows]
        med_valid = valid[med_rows]
    else:
        med_valid = valid
    out = _reduce_math(gqg, dpfg, mdpg, dpig, infog, infoig, infofsg,
                       med_valid, axis_name=axis_name)
    out.update({"pl": pl_out, "ad": ad_out, "gt": gt_out})
    return out


def _remap_math(plg, invg, pllg, nrg, adg, adlg, gtg, rec_num_merged,
                rec_has_nr, gt_lens=None, *, max_merged: int, ploidy: int,
                gt_phase: bool = False, mixed_ploidy: bool = False):
    """The allele/genotype remap part of the combine over gathered
    [B, S, ...] inputs: (pl_out, ad_out, gt_out)."""
    if mixed_ploidy and gt_lens is not None:
        # general ploidy: remap once per ploidy class (static 1..pmax)
        # and select per call by its GT-derived ploidy — the batched
        # form of the reference's per-call genotype enumeration
        # (variant_field_handler.cc:199-296)
        ploidy_bs = (gt_lens + 1) // 2 if gt_phase else gt_lens
        g_max = len(K.genotype_combo_table(max_merged, ploidy))
        pl_out = jnp.full(plg.shape[:2] + (g_max,),
                          formats.INT_VECTOR_END, jnp.int32)
        for p in range(1, ploidy + 1):
            v = K.remap_genotype_fields(plg, invg, pllg, nrg,
                                        rec_num_merged,
                                        num_merged_alleles=max_merged,
                                        ploidy=p)
            pad = g_max - v.shape[-1]
            if pad:
                v = jnp.pad(v, ((0, 0), (0, 0), (0, pad)),
                            constant_values=formats.INT_VECTOR_END)
            pl_out = jnp.where((ploidy_bs == p)[..., None], v, pl_out)
    else:
        pl_out = K.remap_genotype_fields(plg, invg, pllg, nrg,
                                         rec_num_merged,
                                         num_merged_alleles=max_merged,
                                         ploidy=ploidy)
    ad_out = K.remap_allele_fields(adg, invg, adlg, nrg, rec_num_merged,
                                   alt_only=False)
    gt_out = gt_remap_unrolled(gtg, invg, rec_num_merged, rec_has_nr,
                               gt_phase,
                               gt_lens if mixed_ploidy else None)
    return pl_out, ad_out, gt_out


def _reduce_math(gqg, dpfg, mdpg, dpig, infog, infoig, infofsg, valid, *,
                 axis_name: Optional[str] = None) -> Dict[str, jnp.ndarray]:
    """Cross-sample INFO reductions over gathered [B, S] inputs (shared
    by the single-device, dense and sharded paths)."""
    def full(x, axis):
        if axis_name is None:
            return x
        return jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)

    valid_f = full(valid, 1)
    # INFO medians over samples (valid float = payload-checked on host;
    # here invalid encoded as NaN -> excluded via isfinite)
    infog_f = full(infog, 2)
    finite = jnp.isfinite(infog_f) & valid_f[None]
    med, med_ok = jax.vmap(K.masked_median_float)(
        jnp.where(finite, infog_f, jnp.inf), finite)
    # int INFO medians (exact int32 path; float32 cannot represent all)
    infoi_f = full(infoig, 2)
    i_ok = (infoi_f != INT_MISSING) & valid_f[None]
    imed, imed_ok = jax.vmap(K.masked_median_int)(
        jnp.where(i_ok, infoi_f, jnp.iinfo(jnp.int32).max), i_ok)
    # float INFO sums, sequential accumulation order
    infofs_f = full(infofsg, 2)
    fs_ok = jnp.isfinite(infofs_f) & valid_f[None]
    fsum, fsum_ok = masked_seq_sum_float(
        jnp.where(fs_ok, infofs_f, 0), fs_ok)
    # DP logic
    dpi_f, dpf_f, mdp_f = full(dpig, 1), full(dpfg, 1), full(mdpg, 1)
    dp_sum = K.dp_combine(dpi_f, dpf_f, mdp_f, dpi_f != INT_MISSING,
                          dpf_f != INT_MISSING, mdp_f != INT_MISSING)
    return {
        "info_median": med, "info_median_ok": med_ok,
        "info_imedian": imed, "info_imedian_ok": imed_ok,
        "info_fsum": fsum, "info_fsum_ok": fsum_ok,
        "dp_info_sum": dp_sum, "gq": gqg, "dp_format": dpfg,
        "min_dp": mdpg,
    }


def gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info,
                     info_f, info_i, info_fs, live, del_rw=None):
    """Per-(record, sample) live-cell gather of the [S, C, ...] cell
    tensors -> dense [B, S, ...] inputs for _combine_math.  `del_rw`
    masks spanning-deletion-rewritten calls out of the INFO inputs."""
    valid = live >= 0
    info_ok = valid if del_rw is None else (valid & ~del_rw)

    def g(x):
        return _gather_cells(x, live)

    # plg/adg are NOT masked here: invalid slots gather garbage, but the
    # remap kernels mask their outputs via inv==-1 (combo_missing /
    # in_allele) — masking them anyway costs a full padded-lane pass each
    return {
        "plg": g(pl), "pllg": jnp.where(valid, g(pl_len), 0),
        "adg": g(ad), "adlg": jnp.where(valid, g(ad_len), 0),
        "gtg": jnp.where(valid[..., None], g(gt), INT_MISSING),
        "gqg": jnp.where(valid, g(gq), INT_MISSING),
        "dpfg": jnp.where(valid, g(dp), INT_MISSING),
        "mdpg": jnp.where(valid, g(min_dp), INT_MISSING),
        "dpig": jnp.where(valid, g(dp_info), INT_MISSING),
        "infog": jnp.where(info_ok[None],
                           jax.vmap(lambda f: _gather_cells(f, live))(
                               info_f), jnp.nan),
        "infoig": jnp.where(info_ok[None],
                            jax.vmap(lambda f: _gather_cells(f, live))(
                                info_i), INT_MISSING),
        "infofsg": jnp.where(info_ok[None],
                             jax.vmap(lambda f: _gather_cells(f, live))(
                                 info_fs), jnp.nan),
        "valid": valid,
    }


@partial(jax.jit, static_argnames=("max_merged", "ploidy", "gt_phase",
                                   "mixed_ploidy"))
def combine_step(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                 dp_info, info_f, info_i, info_fs, inv_bs, nr_bs,
                 rec_num_merged, rec_has_nr, live, del_rw=None,
                 gt_len_bs=None, med_rows=None, remap_rows=None, *,
                 max_merged: int, ploidy: int, gt_phase: bool = False,
                 mixed_ploidy: bool = False) -> Dict[str, jnp.ndarray]:
    # per-chunk args may arrive narrowed (int8/int16) to cut the
    # host->device upload (block_to_args_cached); math runs int32
    live = live.astype(jnp.int32)
    inv_bs = inv_bs.astype(jnp.int32)
    nr_bs = nr_bs.astype(jnp.int32)
    rec_num_merged = rec_num_merged.astype(jnp.int32)
    if gt_len_bs is not None:
        gt_len_bs = gt_len_bs.astype(jnp.int32)
    if remap_rows is None:
        g = gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                             dp_info, info_f, info_i, info_fs, live,
                             del_rw)
        out = _combine_math(g["plg"], inv_bs, g["pllg"], nr_bs, g["adg"],
                            g["adlg"], g["gtg"], g["gqg"], g["dpfg"],
                            g["mdpg"], g["dpig"], g["infog"], g["infoig"],
                            g["infofsg"], g["valid"], rec_num_merged,
                            rec_has_nr, gt_len_bs, med_rows,
                            max_merged=max_merged, ploidy=ploidy,
                            gt_phase=gt_phase, mixed_ploidy=mixed_ploidy)
        out["live"] = live
        return out
    # row-restricted remaps: the expensive PL/AD/GT gathers + remap
    # kernels run only on `remap_rows` (the variant records — ref-block
    # rows are identity passthroughs the HOST reconstructs,
    # host_identity_outputs); the cross-sample reductions still cover
    # every row.  ~7x less compute on gVCF-shaped cohorts where 6/7
    # records are ref blocks.
    remap_rows = remap_rows.astype(jnp.int32)
    live_r = live[remap_rows]
    valid_r = live_r >= 0

    def g_r(x):
        return _gather_cells(x, live_r)

    pl_out, ad_out, gt_out = _remap_math(
        g_r(pl), inv_bs[remap_rows],
        jnp.where(valid_r, g_r(pl_len), 0), nr_bs[remap_rows],
        g_r(ad), jnp.where(valid_r, g_r(ad_len), 0),
        jnp.where(valid_r[..., None], g_r(gt), INT_MISSING),
        rec_num_merged[remap_rows], rec_has_nr[remap_rows],
        gt_len_bs[remap_rows] if gt_len_bs is not None else None,
        max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
        mixed_ploidy=mixed_ploidy)
    # reductions over every row: DP logic + INFO medians/sums need the
    # full record axis (ref-block rows render INFO DP too)
    valid = live >= 0
    info_ok = valid if del_rw is None else (valid & ~del_rw)

    def g_f(x):
        return _gather_cells(x, live)

    gqg = jnp.where(valid_r, g_r(gq), INT_MISSING)
    dpfg = jnp.where(valid, g_f(dp), INT_MISSING)
    mdpg = jnp.where(valid, g_f(min_dp), INT_MISSING)
    dpig = jnp.where(valid, g_f(dp_info), INT_MISSING)
    infog = jnp.where(info_ok[None],
                      jax.vmap(lambda f: _gather_cells(f, live))(info_f),
                      jnp.nan)
    infoig = jnp.where(info_ok[None],
                       jax.vmap(lambda f: _gather_cells(f, live))(info_i),
                       INT_MISSING)
    infofsg = jnp.where(info_ok[None],
                        jax.vmap(lambda f: _gather_cells(f, live))(
                            info_fs), jnp.nan)
    if med_rows is not None:
        med_valid = valid[med_rows]
        infog_m, infoig_m, infofsg_m = (infog[:, med_rows],
                                        infoig[:, med_rows],
                                        infofsg[:, med_rows])
    else:
        med_valid = valid
        infog_m, infoig_m, infofsg_m = infog, infoig, infofsg
    out = _reduce_math(gqg, dpfg, mdpg, dpig, infog_m, infoig_m,
                       infofsg_m, med_valid)
    # gq / dp_format / min_dp passthroughs come back row-restricted
    # (the host identity fill covers ref rows)
    out["dp_format"] = dpfg[remap_rows]
    out["min_dp"] = mdpg[remap_rows]
    out.update({"pl": pl_out, "ad": ad_out, "gt": gt_out, "live": live})
    return out


def gather_block_host(blk: CellBlock, live: np.ndarray) -> Dict[str,
                                                                np.ndarray]:
    """Host-side live-cell gather: dense per-record inputs for
    combine_step_dense (the device then runs only the dense math)."""
    valid = live >= 0
    k = np.clip(live, 0, blk.col.shape[1] - 1)
    s_i = np.arange(blk.col.shape[0])[None, :]

    info_ok = valid if blk.del_rw is None else (valid & ~blk.del_rw)

    def g2(x, fill):
        return np.where(valid, x[s_i, k], fill)

    def g3(x, fill):
        return np.where(valid[..., None], x[s_i, k], fill)

    return {
        "plg": g3(blk.pl, INT_MISSING), "invg": blk.inv_bs,
        "pllg": g2(blk.pl_len, 0), "nrg": blk.nr_bs,
        "adg": g3(blk.ad, INT_MISSING), "adlg": g2(blk.ad_len, 0),
        "gtg": g3(blk.gt, INT_MISSING), "gqg": g2(blk.gq, INT_MISSING),
        "dpfg": g2(blk.dp, INT_MISSING), "mdpg": g2(blk.min_dp,
                                                    INT_MISSING),
        "dpig": g2(blk.dp_info, INT_MISSING),
        "infog": np.where(info_ok[None], blk.info_f[:, s_i, k], np.nan),
        "infoig": np.where(info_ok[None], blk.info_i[:, s_i, k],
                           INT_MISSING),
        "infofsg": np.where(info_ok[None], blk.info_fs[:, s_i, k],
                            np.nan),
        "valid": valid,
    }


@partial(jax.jit, static_argnames=("max_merged", "ploidy", "gt_phase",
                                   "mixed_ploidy"))
def combine_step_dense(plg, invg, pllg, nrg, adg, adlg, gtg, gqg, dpfg,
                       mdpg, dpig, infog, infoig, infofsg, valid,
                       rec_num_merged, rec_has_nr=None, gt_lens=None, *,
                       max_merged: int, ploidy: int,
                       gt_phase: bool = False,
                       mixed_ploidy: bool = False
                       ) -> Dict[str, jnp.ndarray]:
    """combine_step on HOST-pre-gathered dense inputs (gather_block_host):
    the device runs only the dense remap + reduction math."""
    if rec_has_nr is None:
        rec_has_nr = jnp.ones(rec_num_merged.shape, dtype=bool)
    return _combine_math(plg, invg, pllg, nrg, adg, adlg, gtg, gqg, dpfg,
                         mdpg, dpig, infog, infoig, infofsg, valid,
                         rec_num_merged, rec_has_nr, gt_lens,
                         max_merged=max_merged, ploidy=ploidy,
                         gt_phase=gt_phase, mixed_ploidy=mixed_ploidy)


# ---------------- device->host fetch compaction ----------------
#
# The big output tensors carry small values (PL/AD counters, allele
# codes), so the device can narrow them to int16/int8 after the
# combine (GENOMICSDB_TPU_PACK=1); the host then fetches
# the narrow copy plus a per-tensor "fits" flag and falls back to the
# (still-on-device) int32 original only when a value genuinely
# overflows.  Sentinels map to the matching BCF narrow sentinels.

PACK_SPECS = {
    # key -> (np dtype, missing, vector_end, lo, hi)
    "pl": (np.int16, -32768, -32767, -32000, 32000),
    "ad": (np.int16, -32768, -32767, -32000, 32000),
    "gt": (np.int8, -128, -127, -100, 100),
    "gq": (np.int16, -32768, -32767, -32000, 32000),
    "dp_format": (np.int16, -32768, -32767, -32000, 32000),
    "min_dp": (np.int16, -32768, -32767, -32000, 32000),
    "live": (np.int16, -32768, -32767, -32000, 32000),
}


def pack_outputs(out: Dict, rows: Optional[np.ndarray] = None
                 ) -> Optional[Dict]:
    """Dispatch the narrowing step over the device-resident packable
    outputs (host-side np entries are left alone — uploading them just
    to narrow them would defeat the purpose).  With `rows`, only those
    [B, ...] rows are kept — the variant-record-only fetch: ref-block
    rows are identity remaps the host reconstructs from block data it
    already holds (host_identity_outputs).

    The preferred form packs the ENTIRE fetch tree — narrowed tensors,
    fits flags, and every small always-full output — into one 8-byte-
    aligned uint8 blob on device (bit-exact bitcasts): jax.device_get
    fetches per LEAF, so one blob = one transfer."""
    packable = {k: v for k, v in out.items()
                if k in PACK_SPECS and k != "live"
                and not isinstance(v, np.ndarray)}
    if not packable:
        return None
    extras = {k: v for k, v in out.items()
              if k not in PACK_SPECS and not isinstance(v, np.ndarray)
              and hasattr(v, "dtype") and hasattr(v, "shape")}
    rows_a = np.asarray(rows, dtype=np.int32) if rows is not None \
        else None
    try:
        blob, layout = _pack_blob(packable, extras, rows_a)
        return {"__blob__": blob, "__layout__": layout}
    except Exception:
        # conservative fallback: per-leaf packed dict
        if rows is None:
            return _pack_outputs_step(packable)
        return _pack_outputs_rows_step(packable, rows_a)


def _blob_meta(name: str, v) -> tuple:
    """(name, np dtype str, shape, is_bool, padded nbytes)."""
    is_bool = str(v.dtype) == "bool"
    dt = np.dtype("uint8") if is_bool else np.dtype(str(v.dtype))
    nb = int(np.prod(v.shape, dtype=np.int64)) * dt.itemsize
    return (name, dt.str, tuple(v.shape), is_bool, nb + ((-nb) % 8))


def _pack_blob(packable: Dict, extras: Dict,
               rows: Optional[np.ndarray]):
    """Build (device blob, host layout) for the one-round-trip fetch."""
    layout = []
    nr = len(rows) if rows is not None else None
    for k in sorted(packable):
        dt, _, _, _, _ = PACK_SPECS[k]
        v = packable[k]
        shape = ((nr,) + tuple(v.shape[1:])) if nr is not None \
            else tuple(v.shape)
        layout.append(("fits::" + k, np.dtype("uint8").str, (1,),
                       True, 8))
        nb = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        layout.append(("data::" + k, np.dtype(dt).str, shape, False,
                       nb + ((-nb) % 8)))
    for k in sorted(extras):
        layout.append(_blob_meta("x::" + k, extras[k]))
    blob = _pack_blob_step(packable, extras, rows)
    return blob, layout


def _narrow_one(k: str, v):
    """(fits, packed) for one int32 PACK_SPECS tensor."""
    dt, miss, eov, lo, hi = PACK_SPECS[k]
    is_m = v == INT_MISSING
    is_e = v == formats.INT_VECTOR_END
    ok = jnp.all(is_m | is_e | ((v >= lo) & (v <= hi)))
    p = jnp.where(is_m, miss,
                  jnp.where(is_e, eov, jnp.clip(v, lo, hi))).astype(dt)
    return ok, p


@jax.jit
def _pack_blob_step(packable: Dict, extras: Dict,
                    rows) -> jnp.ndarray:
    parts = []

    def emit(v):
        if v.dtype == jnp.bool_:
            v = v.astype(jnp.uint8)
        b = v if v.dtype == jnp.uint8 else \
            jax.lax.bitcast_convert_type(v, jnp.uint8)
        b = b.reshape(-1)
        pad = (-b.shape[0]) % 8
        if pad:
            b = jnp.pad(b, (0, pad))
        parts.append(b)

    for k in sorted(packable):
        v = packable[k]
        if rows is not None:
            v = v[rows]
        ok, p = _narrow_one(k, v)
        emit(ok.reshape(1))
        emit(p)
    for k in sorted(extras):
        emit(extras[k])
    return jnp.concatenate(parts) if parts else jnp.zeros(0, jnp.uint8)


def _unpack_blob(blob: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """Host views over the fetched blob (zero extra copies)."""
    out = {}
    off = 0
    for name, dtstr, shape, is_bool, padded in layout:
        dt = np.dtype(dtstr)
        n = int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(blob, dtype=dt, count=n, offset=off)
        a = a.reshape(shape)
        if is_bool:
            a = a != 0
        out[name] = a
        off += padded
    return out


@jax.jit
def _pack_outputs_rows_step(out: Dict[str, jnp.ndarray],
                            rows: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    sliced = {k: v[rows] for k, v in out.items()}
    return _pack_outputs_step(sliced)


@jax.jit
def _pack_outputs_step(out: Dict[str, jnp.ndarray]
                       ) -> Dict[str, jnp.ndarray]:
    """Narrowed copies + fits-flags of the big int32 outputs (device)."""
    packed = {}
    for k in PACK_SPECS:
        v = out.get(k)
        if v is None:
            continue
        ok, p = _narrow_one(k, v)
        packed[k + "__p"] = p
        packed[k + "__fits"] = ok
    return packed


def fetch_outputs(out: Dict, packed: Optional[Dict] = None
                  ) -> Dict[str, np.ndarray]:
    """Host fetch of a combine-step output dict.  With `packed` (from
    pack_outputs), narrow tensors are fetched and widened on the host;
    an int32 original is fetched only if its values overflowed.  Two
    batched device_get round trips total (flags, then data)."""
    import jax
    if packed is None:
        # per-array np.asarray: the cheap path (device_get's tree walk
        # costs ~ms per call)
        return {k: np.asarray(v) for k, v in out.items()}
    if "__blob__" in packed:
        got, narrow = _fetch_blob_tree(out, packed)
    else:
        fits = jax.device_get({k: v for k, v in packed.items()
                               if k.endswith("__fits")})
        tree = {}
        narrow = set()
        for k, v in out.items():
            if k in PACK_SPECS and (k + "__p") in packed \
                    and bool(fits[k + "__fits"]):
                tree[k] = packed[k + "__p"]
                narrow.add(k)
            else:
                tree[k] = v
        got = jax.device_get(tree)
    dev: Dict[str, np.ndarray] = {}
    for k, v in got.items():
        v = np.asarray(v)
        if k in narrow:
            _, miss, eov, _, _ = PACK_SPECS[k]
            w = v.astype(np.int32)
            w[v == miss] = INT_MISSING
            w[v == eov] = formats.INT_VECTOR_END
            dev[k] = w
        else:
            dev[k] = v
    return dev


IDENT_KEYS = ("pl", "ad", "gt", "gq", "dp_format", "min_dp")


def _fetch_blob_tree(out: Dict, packed: Dict):
    """ONE device round trip for the whole fetch tree (see
    pack_outputs): unpack host views, fall back to per-leaf fetches
    only for the rare int32-overflow keys."""
    import jax
    parts = _unpack_blob(np.asarray(packed["__blob__"]),
                         packed["__layout__"])
    got: Dict[str, np.ndarray] = {}
    narrow = set()
    retry = {}
    for k, v in out.items():
        if ("data::" + k) in parts:
            if bool(parts["fits::" + k][0]):
                got[k] = parts["data::" + k]
                narrow.add(k)
            else:
                retry[k] = v
        elif ("x::" + k) in parts:
            got[k] = parts["x::" + k]
        else:
            retry[k] = v
    if retry:
        got.update(jax.device_get(retry))
    return got, narrow


def fetch_outputs_split(out: Dict, packed: Dict, var_rows: np.ndarray,
                        ref_rows: np.ndarray, ident) -> Dict[str,
                                                             np.ndarray]:
    """Assemble full-size host outputs from a variant-row-only device
    fetch (pack_outputs(rows=var_rows)) plus host-reconstructed
    ref-block rows.  `ident` is either the host_identity_outputs dict,
    or a callable `fill(full_arrays) -> bool` that writes the ref rows
    straight into the preallocated full arrays (the native scatter path
    — no intermediate [Bref, S, W] copies).  Reductions and int32
    overflow fallbacks fetch full."""
    import jax
    if "__blob__" in packed:
        got, narrow = _fetch_blob_tree(
            {k: v for k, v in out.items() if k != "live"}, packed)
    else:
        fits = jax.device_get({k: v for k, v in packed.items()
                               if k.endswith("__fits")})
        tree = {}
        narrow = set()
        for k, v in out.items():
            if k == "live":
                continue
            if k in PACK_SPECS and (k + "__p") in packed \
                    and bool(fits[k + "__fits"]):
                tree[k] = packed[k + "__p"]
                narrow.add(k)
            else:
                tree[k] = v
        got = jax.device_get(tree)
    B = out["live"].shape[0] if hasattr(out.get("live"), "shape") \
        else len(var_rows) + len(ref_rows)
    dev: Dict[str, np.ndarray] = {}
    ident_full: Dict[str, np.ndarray] = {}
    from ..runtime import native_loader
    for k, v in got.items():
        v = np.asarray(v)
        if k in narrow:
            _, miss, eov, _, _ = PACK_SPECS[k]
            if v.ndim == 2:
                # [B, S] presence columns: rows outside the scatter
                # (no live cell / bucket padding) must read MISSING
                full = np.full((B,) + v.shape[1:], INT_MISSING,
                               dtype=np.int32)
            else:
                # [B, S, W] value tensors are only read at live cells
                # of emitted rows — all covered by the scatter
                full = np.empty((B,) + v.shape[1:], dtype=np.int32)
            # widen + sentinel remap + scatter in one threaded native
            # pass (numpy fallback: five passes over the data)
            if native_loader.widen_scatter(v, var_rows, miss, eov,
                                           full) is None:
                w = v.astype(np.int32)
                w[v == miss] = INT_MISSING
                w[v == eov] = formats.INT_VECTOR_END
                full[var_rows] = w
            if k in IDENT_KEYS:
                ident_full[k] = full
            dev[k] = full
        else:
            dev[k] = v
    if ident_full:
        filled = False
        ident_dict = ident if isinstance(ident, dict) else None
        if callable(ident) and set(ident_full) == set(IDENT_KEYS):
            filled = bool(ident(ident_full))
        if not filled:
            if ident_dict is None:
                ident_dict = ident(None) if callable(ident) else {}
            for k, full in ident_full.items():
                if k in ident_dict:
                    full[ref_rows] = ident_dict[k]
    return dev


def host_identity_outputs(blk: CellBlock, rows: np.ndarray,
                          widths: Tuple[int, int, int],
                          gt_phase: bool, mixed_ploidy: bool
                          ) -> Dict[str, np.ndarray]:
    """Combine outputs for REF-BLOCK-ONLY records, computed on the host.

    For a ref-block-only record every live cell is a pure reference
    block: the allele LUT is the identity [REF, NON_REF] and the device
    remap degenerates to a masked passthrough of the raw cell values —
    which the host already holds in the block tensors.  Reproducing
    that passthrough here lets the device fetch carry ONLY variant-
    record rows (pack_outputs(rows=...)), cutting the device->host
    volume by the cohort's ref-block fraction (~90% for gVCF).

    Matches _combine_math exactly at these rows: PL slots g <= ploidy
    (genotypes over [REF, NON_REF]) gated by pl_len / ploidy-class
    (ploidy-0 calls stay INT_VECTOR_END in mixed mode, the per-class
    select's init); AD slots m < 2 gated by ad_len; GT allele slots
    pass through with absent alleles mapped to the NON_REF merged index
    1, phase slots untouched; GQ/DP/MIN_DP masked passthroughs.
    Byte-equality with the device path is pinned by the golden + fuzz
    suites with GENOMICSDB_TPU_PACK=1 forced on CPU."""
    from ..core import formats as F
    G_out, M_out, P_out = widths
    S = blk.live.shape[1]
    live = np.asarray(blk.live)[rows]
    # native form (same arithmetic at memory speed, threaded): the
    # numpy expression below costs ~1 s per 20k-record x 100-sample
    # block and dominated the end-to-end profile
    from ..runtime import native_loader
    gtl_r = np.asarray(blk.gt_len_bs)[rows] if mixed_ploidy else None
    nat = native_loader.identity_outputs(
        live, blk.pl, blk.pl_len, blk.ad, blk.ad_len, blk.gt, blk.gq,
        blk.dp, blk.min_dp, gtl_r, widths, blk.ploidy, gt_phase,
        mixed_ploidy)
    if nat is not None:
        return nat
    ok = live >= 0
    kk = np.clip(live, 0, blk.col.shape[1] - 1)
    s_i = np.arange(S)[None, :]

    def g2(x, fill, dtype=np.int32):
        return np.where(ok, x[s_i, kk], fill).astype(dtype)

    def g3(x, fill, width):
        g = np.where(ok[..., None], x[s_i, kk], fill)
        if g.shape[2] < width:
            g = np.pad(g, ((0, 0), (0, 0), (0, width - g.shape[2])),
                       constant_values=fill)
        return g[:, :, :width].astype(np.int32)

    if mixed_ploidy:
        gl = np.asarray(blk.gt_len_bs)[rows]
        p_bs = (gl + 1) // 2 if gt_phase else gl
    else:
        p_bs = np.full(ok.shape, blk.ploidy, dtype=np.int64)
    # PL: genotypes over 2 alleles at ploidy p are the first p+1 slots
    pl_raw = g3(blk.pl, INT_MISSING, G_out)
    pl_len = g2(blk.pl_len, 0)
    g_idx = np.arange(G_out)[None, None, :]
    ok_pl = (g_idx <= p_bs[..., None]) & (g_idx < pl_len[..., None]) \
        & ok[..., None]
    pl_out = np.where(ok_pl, pl_raw, INT_MISSING)
    if mixed_ploidy:
        pl_out = np.where((p_bs == 0)[..., None], F.INT_VECTOR_END,
                          pl_out)
    # AD: slots m < num_merged (=2) gated by ad_len
    ad_raw = g3(blk.ad, INT_MISSING, M_out)
    ad_len = g2(blk.ad_len, 0)
    m_idx = np.arange(M_out)[None, None, :]
    ok_ad = (m_idx < 2) & (m_idx < ad_len[..., None]) & ok[..., None]
    ad_out = np.where(ok_ad, ad_raw, INT_MISSING)
    # GT: identity allele remap with NON_REF fallback (merged idx 1)
    gt_raw = g3(blk.gt, INT_MISSING, P_out)
    gt_out = np.empty_like(gt_raw)
    for p in range(P_out):
        a = gt_raw[..., p]
        if gt_phase and p % 2 == 1:
            o = a
        else:
            oka = (a >= 0) & (a != INT_MISSING)
            o = np.where(oka, np.where(a < 2, a, 1), a)
        if mixed_ploidy:
            gl = np.asarray(blk.gt_len_bs)[rows]
            o = np.where(p < gl, o, F.INT_VECTOR_END)
        gt_out[..., p] = o
    return {
        "pl": pl_out, "ad": ad_out, "gt": gt_out,
        "gq": g2(blk.gq, INT_MISSING),
        "dp_format": g2(blk.dp, INT_MISSING),
        "min_dp": g2(blk.min_dp, INT_MISSING),
    }


def block_to_args(blk: CellBlock):
    del_rw = blk.del_rw if blk.del_rw is not None \
        else np.zeros(blk.live.shape, dtype=bool)
    has_nr = blk.rec_has_nr if blk.rec_has_nr is not None \
        else np.ones(len(blk.rec_num_merged), dtype=bool)
    gt_w = blk.gt.shape[2]
    gt_lens = blk.gt_len_bs if blk.gt_len_bs is not None \
        else np.full(blk.live.shape, gt_w, dtype=np.int32)
    return (blk.pl, blk.pl_len, blk.ad, blk.ad_len,
            blk.gt, blk.gq, blk.dp, blk.min_dp, blk.dp_info, blk.info_f,
            blk.info_i, blk.info_fs, blk.inv_bs, blk.nr_bs,
            blk.rec_num_merged, has_nr, blk.live, del_rw, gt_lens)


def block_to_args_cached(blk: CellBlock):
    """block_to_args with the 12 store-wide [S, C, ...] slab tensors
    replaced by device-resident copies cached on the block's dense
    layout: chunks and repeated queries over the same store upload the
    slabs ONCE instead of once per chunk."""
    args = list(block_to_args(blk))
    lay = getattr(blk, "_dense_layout", None)
    if lay is not None:
        dev = lay.get("_device_slabs")
        if dev is None:
            dev = lay["_device_slabs"] = [jax.device_put(a)
                                          for a in args[:12]]
        args[:12] = dev
        # per-chunk args travel narrow (combine_step upcasts in-jit)
        C = blk.col.shape[1]
        live_dt = np.int16 if C < 2**15 else np.int32
        args[12] = args[12].astype(np.int8)        # inv_bs
        args[13] = args[13].astype(np.int8)        # nr_bs
        args[14] = args[14].astype(np.int8)        # rec_num_merged
        args[16] = args[16].astype(live_dt)        # live
        args[18] = args[18].astype(np.int8)        # gt_len_bs
    return tuple(args)


def live_cells_at_host(starts: np.ndarray, col: np.ndarray,
                       end: np.ndarray) -> np.ndarray:
    """numpy twin of jax_kernels.live_cells_at ([B, S] int32)."""
    B, (S, C) = len(starts), col.shape
    live = np.full((B, S), -1, dtype=np.int32)
    for s in range(S):
        idx = np.searchsorted(col[s], starts, side="right") - 1
        ok = idx >= 0
        idxc = np.clip(idx, 0, C - 1)
        ok &= end[s, idxc] >= starts
        live[:, s] = np.where(ok, idxc, -1)
    return live


def gather_luts_host(inv_cell: np.ndarray, nr_cell: np.ndarray,
                     live: np.ndarray):
    """Per-cell LUTs [S, C, M] / [S, C] -> gathered [B, S, M] / [B, S]
    (for callers whose allele context is constant per cell, e.g. the
    synthetic bench cohort)."""
    valid = live >= 0
    k = np.clip(live, 0, inv_cell.shape[1] - 1)
    s_i = np.arange(inv_cell.shape[0])[None, :]
    inv_bs = np.where(valid[..., None], inv_cell[s_i, k], -1)
    nr_bs = np.where(valid, nr_cell[s_i, k], -1)
    return inv_bs.astype(np.int32), nr_bs.astype(np.int32)


def synthesize_cohort(num_samples: int, cells_per_sample: int,
                      region_len: int, seed: int = 0,
                      variant_fraction: float = 0.1,
                      max_merged: int = 4, ploidy: int = 2) -> CellBlock:
    """Synthetic gVCF cohort block: ref blocks + multi-allelic variant
    sites shared across samples (GVCF-shaped workload for the bench)."""
    rng = np.random.default_rng(seed)
    S, C = num_samples, cells_per_sample
    G_in = max_merged * (max_merged + 1) // 2
    A_in = max_merged
    # per-sample interval tiling of the region
    bounds = np.sort(rng.integers(0, region_len, size=(S, C - 1)), axis=1)
    col = np.concatenate([np.zeros((S, 1), np.int64), bounds], axis=1)
    end = np.concatenate([bounds - 1, np.full((S, 1), region_len - 1,
                                              np.int64)], axis=1)
    # fix zero-length collisions
    bad = end < col
    end = np.where(bad, col, end)
    is_var = rng.random((S, C)) < variant_fraction
    n_in_alleles = np.where(is_var, rng.integers(2, max_merged + 1,
                                                 size=(S, C)), 2)
    pl = rng.integers(0, 2000, size=(S, C, G_in)).astype(np.int32)
    pl_len = (n_in_alleles * (n_in_alleles + 1) // 2).astype(np.int32)
    ad = rng.integers(0, 100, size=(S, C, A_in)).astype(np.int32)
    ad_len = n_in_alleles.astype(np.int32)
    gt = rng.integers(0, 2, size=(S, C, ploidy)).astype(np.int32)
    gq = rng.integers(0, 100, size=(S, C)).astype(np.int32)
    dp = rng.integers(0, 100, size=(S, C)).astype(np.int32)
    min_dp = np.where(is_var, INT_MISSING,
                      rng.integers(0, 40, size=(S, C))).astype(np.int32)
    dp_info = np.where(is_var, rng.integers(0, 100, size=(S, C)),
                       INT_MISSING).astype(np.int32)
    F = 6  # BaseQRankSum/Clipping/MQRankSum/ReadPos/MQ + extra
    info_f = rng.normal(size=(F, S, C)).astype(np.float32)
    info_f = np.where(is_var[None], info_f, np.nan).astype(np.float32)
    info_i = np.where(is_var, rng.integers(0, 50, size=(S, C)),
                      INT_MISSING).astype(np.int32)[None]   # MQ0-like
    info_fs = np.where(is_var, rng.random((S, C)) * 100, np.nan
                       ).astype(np.float32)[None]           # RAW_MQ-like
    # LUTs mirror the real merge invariant: cell alleles 0..n_in-2 map to
    # merged 0..n_in-2, the cell's NON_REF (last input allele) maps to the
    # LAST merged allele, middle merged alleles are absent (-1).
    inv_cell = np.full((S, C, max_merged), -1, dtype=np.int32)
    inv_cell[..., 0] = 0
    for m in range(1, max_merged - 1):
        inv_cell[..., m] = np.where(m < n_in_alleles - 1, m, -1)
    inv_cell[..., max_merged - 1] = n_in_alleles - 1  # NON_REF last
    nr_cell = (n_in_alleles - 1).astype(np.int32)
    # sweep on host for the synthetic block
    events = np.unique(np.concatenate([col.ravel(), end.ravel() + 1]))
    starts = events[events < region_len]
    rec_num_merged = np.full(len(starts), max_merged, dtype=np.int32)
    live = live_cells_at_host(starts, col, end)
    inv_bs, nr_bs = gather_luts_host(inv_cell, nr_cell, live)
    return CellBlock(col=col, end=end, pl=pl, pl_len=pl_len, ad=ad,
                     ad_len=ad_len, gt=gt, gq=gq, dp=dp, min_dp=min_dp,
                     dp_info=dp_info, info_f=info_f, info_i=info_i,
                     info_fs=info_fs,
                     inv_bs=inv_bs, nr_bs=nr_bs, starts=starts,
                     rec_num_merged=rec_num_merged, live=live)
