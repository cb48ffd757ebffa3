"""ColumnarStore -> device CellBlock conversion.

Bridges the storage layer to the batched device combine: per-row dense cell
layout, padded field tensors, and the per-(interval, cell) allele LUTs.

Allele merging is query-invariant string work, done once here on the host
(ops/merge.py semantics); intervals whose live cells are all reference
blocks (the overwhelming majority in gVCF data) short-circuit to the
identity LUT, so per-interval merge cost scales with the number of variant
sites, not with genome length.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core import known_fields as kf
from ..core.config import QueryConfig
from ..store.columnar import ColumnarStore
from . import merge as M
from .combine_step import CellBlock

INT_MISSING = formats.INT_MISSING
INT64_MAX = np.iinfo(np.int64).max
# ceiling on merged alleles per record on the device path at diploid:
# the reference's 50-alt genotyping cap + REF (gt_common.h:48,
# max_diploid_alt_alleles_that_can_be_genotyped).  Records merging MORE
# splice to the sequential engine, which implements the reference's
# skip-genotype-length-fields-with-warning semantics for them
# (broad_combined_gvcf.cc too_many_alt_alleles; combine.py
# _too_many_alts) — so the two caps compose exactly.
MAX_MERGED_CAP = 51
# max per-call ploidy the batched path enumerates genotypes for; beyond
# it records splice (sex-chromosome/polyploid cohorts top out well
# below this; the genotype count explodes combinatorially past it)
PLOIDY_CAP = 6
# genotype-table budget: the block's (merged alleles, ploidy) genotype
# count must stay under this, or the padded [*, G] tensors explode
GENOTYPE_TABLE_LIMIT = 4096
# per-block PL-tensor byte budget: one wide-allele site grows the G
# axis of the WHOLE block's [B, S, G] tensors, so the cap tightens on
# huge blocks (records past it splice to the sequential engine, whose
# too-many-alts semantics then apply); interval- and fuzz-sized blocks
# keep the full 50-alt reference cap
PL_TENSOR_BUDGET = int(
    __import__("os").environ.get("GENOMICSDB_TPU_PL_BUDGET", 1 << 30))


def merged_cap(ploidy: int, block_elems: int = 0) -> int:
    """Largest merged-allele width whose genotype table for `ploidy`
    stays within GENOTYPE_TABLE_LIMIT and whose [block_elems, G] int32
    PL tensors stay within PL_TENSOR_BUDGET (never above
    MAX_MERGED_CAP).  Diploid at interval-query block sizes resolves to
    the full 51 (C(52,2)=1326 genotypes)."""
    import math
    g_limit = GENOTYPE_TABLE_LIMIT
    if block_elems > 0:
        g_limit = min(g_limit,
                      max(PL_TENSOR_BUDGET // (4 * block_elems), 16))
    m = MAX_MERGED_CAP
    while m > 2 and math.comb(m + ploidy - 1, ploidy) > g_limit:
        m -= 1
    return m


def _eff_valid_store(store, name, n_cells):
    """Store-cached effective validity for a field (a store-wide
    property, computed once across genome-scale chunks)."""
    cache = getattr(store, "_eff_valid_cache", None)
    if cache is None:
        cache = store._eff_valid_cache = {}
    ev = cache.get(name)
    if ev is None:
        from ..query.block_fields import effective_valid
        ev = effective_valid(store.fields.get(name), n_cells)
        cache[name] = ev
    return ev


def _string_codes_cached(store, name, fd):
    """Per-cell int code for a str column + the unique strings, fully
    vectorized (group cells by length, np.unique over byte rows) and
    cached on the store (codes are a store-wide property, reused across
    genome-scale chunks).  Invalid cells get code -1."""
    cache = getattr(store, "_str_code_cache", None)
    if cache is None:
        cache = store._str_code_cache = {}
    got = cache.get(name)
    if got is not None:
        return got
    n = len(fd.offsets) - 1 if fd.offsets is not None else 0
    lens = np.diff(fd.offsets) if n else np.zeros(0, dtype=np.int64)
    codes = np.full(n, -1, dtype=np.int64)
    uniq: List[str] = []
    valid = fd.valid if fd.valid is not None \
        else np.ones(n, dtype=bool)
    for L in np.unique(lens) if n else []:
        sel = np.nonzero((lens == L) & valid)[0]
        if len(sel) == 0:
            continue
        if L == 0:
            codes[sel] = len(uniq)
            uniq.append("")
            continue
        mat = fd.values[fd.offsets[sel][:, None]
                        + np.arange(int(L))]
        if L <= 8:
            # pack the bytes into one uint64: 1-D unique beats the
            # lexsort behind np.unique(axis=0) by ~10x
            padded = np.zeros((len(sel), 8), dtype=np.uint8)
            padded[:, :L] = mat
            key = padded.view(np.uint64)[:, 0]
            _, first, inv = np.unique(key, return_index=True,
                                      return_inverse=True)
        else:
            _, first, inv = np.unique(mat, axis=0, return_index=True,
                                      return_inverse=True)
        codes[sel] = len(uniq) + inv
        uniq.extend(bytes(mat[i].tobytes()).decode() for i in first)
    got = (codes, uniq)
    cache[name] = got
    return got


def record_starts(store: ColumnarStore, qc: QueryConfig,
                  interval) -> np.ndarray:
    """Record start columns for `interval` (the sweep's event set) —
    used to pick record-aligned chunk boundaries for genome-scale
    queries without building the blocks.

    The sorted event set is store-wide and query-independent (per row
    subset), so it is cached on the store: repeated small-interval
    queries — the Spark/GATK split pattern — cost two searchsorted
    probes instead of a store-wide unique/sort each."""
    rows_key = tuple(sorted(qc.rows_to_query))
    cache = getattr(store, "_events_cache", None)
    if cache is None:
        cache = store._events_cache = {}
    events_all = cache.get(rows_key)
    if events_all is None:
        sel = np.isin(store.row, list(rows_key)) if store.num_cells \
            else np.zeros(0, dtype=bool)
        col = store.col[sel]
        end = store.eff_end[sel]
        events_all = np.unique(np.concatenate([col, end + 1])) \
            if len(col) else np.zeros(0, dtype=np.int64)
        cache[rows_key] = events_all
    lo, hi = interval
    i = np.searchsorted(events_all, lo, side="left")
    j = np.searchsorted(events_all, hi, side="right")
    events = events_all[i:j]
    if len(events) == 0 or events[0] != lo:
        events = np.concatenate([[lo], events])
    return events


@dataclass
class ExtraField:
    """One gathered non-core field for the generalized block writer."""
    spec: object                   # FormatSpec / InfoSpec
    vals: Optional[np.ndarray]     # [B, S, (W)] gathered (None: host decode)
    valid: np.ndarray              # [B, S] effective validity of live cell
    lens: Optional[np.ndarray] = None   # [B, S] input lengths (VAR/ragged)


@dataclass
class BlockRecordMeta:
    """Per-record host metadata for the block-based VCF writer."""
    ends: np.ndarray               # [B] record end columns
    refs: List[Optional[str]]      # merged REF per record (None -> fasta)
    alts: List[List[str]]          # merged ALT lists ("&" = NON_REF)
    is_ref_block_only: np.ndarray  # [B] bool
    has_deletion: np.ndarray       # [B] bool
    needs_fallback: np.ndarray = None  # [B] bool: a valid queried field
    # the block path cannot realize lives here (sequential splice)
    plan: object = None            # block_fields.BlockPlan
    extras: dict = None            # name -> ExtraField
    cells_mat: np.ndarray = None   # [B, S] store cell idx of live cell
    valid_core: dict = None        # name -> [B, S] effective validity
    gt_override: dict = None       # (b, s) -> merged-space GT vector
    # (produce_GT spanning-deletion min-PL rewrites, host-computed)
    med_rows: np.ndarray = None    # [Bv] rows with any valid INFO
    # median/sum input — the combine's sorts restrict to these


def _block_ploidy(store: ColumnarStore, qc: QueryConfig,
                  ploidy: int) -> int:
    """Cohort max ploidy from stored GT lengths (store-cached)."""
    gt_fd0 = store.fields.get("GT")
    gt_info0 = qc.vid.get_field_info("GT")
    if gt_fd0 is not None and gt_info0 is not None and store.num_cells \
            and gt_fd0.valid.any():
        pl_max = getattr(store, "_gt_ploidy_max_cache", None)
        if pl_max is None:
            # distinct stored GT lengths are a handful; never loop cells
            glens0 = gt_fd0.lens()
            uniq = np.unique(glens0[gt_fd0.valid & (glens0 > 0)])
            pl_max = max((int(gt_info0.length.ploidy(int(g)))
                          for g in uniq), default=ploidy)
            store._gt_ploidy_max_cache = pl_max
        if 0 < pl_max <= PLOIDY_CAP:
            ploidy = max(ploidy, pl_max)
    return ploidy


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def dense_layout(store: ColumnarStore, qc: QueryConfig, plan,
                 gt_w: int, pad_cells_to: int) -> dict:
    """STORE-WIDE dense per-row field slabs [S, C] — built once per
    (store, row subset, queried-field set) and reused by every chunk of
    every query (cached on the store).

    This is the key to device-resident serving: chunks and repeated
    interval queries index the SAME slab arrays, so (a) the per-chunk
    host cost collapses to live-index searchsorteds + allele LUTs, and
    (b) the device-side copies (block_to_args_cached) upload once per
    store instead of once per chunk.

    PL/AD input widths are store-global maxima (pow2-bucketed): the
    remap masks (in_gt/idx < in_len) make any width >= the true max
    exact, and a store-global width keeps shapes stable across chunks.
    """
    rows = qc.rows_to_query
    key = (tuple(rows), pad_cells_to, gt_w,
           qc.is_queried("DP_FORMAT"), qc.is_queried("MIN_DP"),
           plan.dp_info_queried, tuple(plan.med_fields),
           tuple(plan.imed_fields), tuple(plan.fsum_fields))
    cache = getattr(store, "_dense_layout_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    S = len(rows)
    # row-major layout with binary-searchable per-row runs
    row_sorted, sorted_rows, col_by_row, eff_by_row = store.row_layout()
    per_row_idx: List[np.ndarray] = []
    for r in rows:
        lo_i = np.searchsorted(sorted_rows, r, side="left")
        hi_i = np.searchsorted(sorted_rows, r, side="right")
        per_row_idx.append(row_sorted[lo_i:hi_i])
    C = max((len(i) for i in per_row_idx), default=1)
    C = max(C, 1)
    if pad_cells_to > 1:
        C = -(-C // pad_cells_to) * pad_cells_to
    col = np.full((S, C), INT64_MAX, dtype=np.int64)
    end = np.full((S, C), 0, dtype=np.int64)
    cell_of = np.full((S, C), -1, dtype=np.int64)
    for s, idx in enumerate(per_row_idx):
        col[s, :len(idx)] = store.col[idx]
        end[s, :len(idx)] = store.eff_end[idx]
        cell_of[s, :len(idx)] = idx

    flat_cells = cell_of.reshape(-1)
    has_cell = flat_cells >= 0
    safe_cells = np.clip(flat_cells, 0, max(store.num_cells - 1, 0))

    def ragged_matrix(name, width, dtype=np.int32, fill=INT_MISSING):
        """Vectorized: per-cell ragged/fixed values -> [S, C, width]."""
        out = np.full((S * C, width), fill, dtype=dtype)
        lens = np.zeros(S * C, dtype=np.int32)
        fd = store.fields.get(name)
        if fd is None or store.num_cells == 0:
            return out.reshape(S, C, width), lens.reshape(S, C)
        ok = has_cell & fd.valid[safe_cells]
        if fd.kind == "fixed":
            w = min(width, fd.values.shape[1])
            sel = np.nonzero(ok)[0]
            out[sel, :w] = fd.values[safe_cells[sel], :w]
            lens[sel] = fd.values.shape[1]
        else:
            cell_lens = fd.lens()
            sel = np.nonzero(ok)[0]
            ln = np.minimum(cell_lens[safe_cells[sel]], width)
            src0 = fd.offsets[:-1][safe_cells[sel]]
            from ..store.columnar import copy_ragged_segments
            # dest rows are contiguous in the flat [S*C, width] buffer
            copy_ragged_segments(fd.values, src0, ln,
                                 sel.astype(np.int64) * width,
                                 out.reshape(-1))
            lens[sel] = cell_lens[safe_cells[sel]]
        return out.reshape(S, C, width), lens.reshape(S, C)

    def scalar_matrix(name, dtype=np.int32, fill=INT_MISSING):
        out = np.full(S * C, fill, dtype=dtype)
        fd = store.fields.get(name)
        if fd is None or store.num_cells == 0:
            return out.reshape(S, C)
        ok = has_cell & fd.valid[safe_cells]
        sel = np.nonzero(ok)[0]
        if fd.kind == "fixed":
            out[sel] = fd.values[safe_cells[sel], 0]
        else:
            cell_lens = fd.lens()
            nz = cell_lens[safe_cells[sel]] > 0
            sel = sel[nz]
            out[sel] = fd.values[fd.offsets[:-1][safe_cells[sel]]]
        return out.reshape(S, C)

    def field_max_len(name) -> int:
        fd = store.fields.get(name)
        if fd is None or store.num_cells == 0:
            return 1
        if fd.kind == "fixed":
            return int(fd.values.shape[1])
        return max(fd.max_len(), 1)

    lay = {"C": C, "col": col, "end": end, "cell_of": cell_of}
    # input widths: store-global maxima, pow2-bucketed for shape reuse
    lay["pl"], lay["pl_len"] = ragged_matrix(
        "PL", _pow2(field_max_len("PL")))
    lay["ad"], lay["ad_len"] = ragged_matrix(
        "AD", _pow2(field_max_len("AD")))
    lay["gt"], lay["gt_len_sc"] = ragged_matrix("GT", gt_w, fill=-1)
    lay["gq"] = scalar_matrix("GQ")
    # the DP fallback chain (broad_combined_gvcf.cc:690-726) only sees
    # fields the query asked for: an unqueried DP_FORMAT/MIN_DP/DP must
    # not leak into the device sum or the trailing DP column
    empty_sc = np.full((S, C), INT_MISSING, dtype=np.int32)
    lay["dp"] = scalar_matrix("DP_FORMAT") \
        if qc.is_queried("DP_FORMAT") else empty_sc
    lay["min_dp"] = scalar_matrix("MIN_DP") \
        if qc.is_queried("MIN_DP") else empty_sc
    lay["dp_info"] = scalar_matrix("DP") if plan.dp_info_queried \
        else empty_sc

    def float_scalar_stack(names):
        out = np.full((len(names), S, C), np.nan, dtype=np.float32)
        for fi, name in enumerate(names):
            m = scalar_matrix(name, dtype=np.float32,
                              fill=np.float32(np.nan))
            bits = m.view(np.uint32)
            out[fi] = np.where(bits == formats.FLOAT_MISSING_BITS,
                               np.nan, m)
        return out

    lay["info_f"] = float_scalar_stack(plan.med_fields)
    lay["info_fs"] = float_scalar_stack(plan.fsum_fields)
    lay["info_i"] = np.stack([scalar_matrix(n)
                              for n in plan.imed_fields]) \
        if plan.imed_fields else np.zeros((0, S, C), np.int32)
    store._dense_layout_cache = (key, lay)
    return lay


def store_to_block(store: ColumnarStore, qc: QueryConfig,
                   interval: Optional[Tuple[int, int]] = None,
                   max_merged: int = 8, ploidy: int = 2,
                   return_meta: bool = False,
                   pad_records: Optional[int] = None,
                   pad_cells_to: int = 1):
    """Build a CellBlock for the queried rows over `interval`.

    Field selection is vid/query-driven (query.block_fields.BlockPlan):
    the device core carries PL/AD/GT/GQ/DP(_FORMAT)/MIN_DP/DP(INFO) and
    the scalar INFO median/sum stacks; every other renderable queried
    field is gathered into `meta.extras` for the generalized writer.

    The dense [S, C] field slabs are STORE-WIDE and cached
    (dense_layout): per-chunk work is the live-index sweep, the allele
    LUT merge, and the extras gather.
    """
    from ..query.block_fields import (build_block_plan, effective_valid,
                                      remap_allele_np, remap_genotype_np)
    plan = build_block_plan(qc, qc.vid)
    rows = qc.rows_to_query
    S = len(rows)
    # general ploidy: size the block to the cohort's MAX ploidy (derived
    # from stored GT lengths); per-call ploidy rides along so haploid /
    # triploid calls remap with their own genotype enumeration
    # (variant_field_handler.cc:199-296 general-ploidy path)
    ploidy = _block_ploidy(store, qc, ploidy)
    # phased GT ("PP" descriptor) stores 2p-1 interleaved elements
    # (broad_combined_gvcf.cc:650-652); phase slots ride along unremapped
    gt_w = 2 * ploidy - 1 if plan.gt_phase else ploidy
    lay = dense_layout(store, qc, plan, gt_w, pad_cells_to)
    C = lay["C"]
    col, end, cell_of = lay["col"], lay["end"], lay["cell_of"]
    pl, pl_len = lay["pl"], lay["pl_len"]
    ad, ad_len = lay["ad"], lay["ad_len"]
    gt, gt_len_sc = lay["gt"], lay["gt_len_sc"]
    gq, dp, min_dp, dp_info = (lay["gq"], lay["dp"], lay["min_dp"],
                               lay["dp_info"])
    info_f, info_fs, info_i = (lay["info_f"], lay["info_fs"],
                               lay["info_i"])
    # --- sweep events (store-cached per row subset; two searchsorted
    # probes per chunk — record_starts) ---
    events = record_starts(store, qc,
                           interval if interval is not None
                           else (0, INT64_MAX - 1))
    # --- per-cell allele metadata, vectorized over the str-field bytes ---
    # (avoids 2 * num_cells Python-level cell_value decodes; full string
    # decode happens lazily, only for the rare variant cells)
    ref_fd = store.fields["REF"]
    alt_fd = store.fields["ALT"]
    N = store.num_cells
    am = getattr(store, "_allele_meta_cache", None)
    if am is None:
        # store-wide, query-independent: computed once, reused by every
        # chunk of a genome-scale query
        ref_len = ref_fd.lens() if N else np.zeros(0, np.int64)
        alt_len = alt_fd.lens() if N else np.zeros(0, np.int64)
        ref_ok = ref_fd.valid & (ref_len > 0)
        alt_ok = alt_fd.valid
        ref_bytes = np.asarray(ref_fd.values, dtype=np.uint8) \
            if N and ref_fd.values is not None else np.zeros(0, np.uint8)
        alt_bytes = np.asarray(alt_fd.values, dtype=np.uint8) \
            if N and alt_fd.values is not None else np.zeros(0, np.uint8)

        def _first_chars(ok, bytes_arr, offsets):
            if not len(bytes_arr):
                return np.zeros(N, np.uint8)
            idx = np.minimum(offsets[:-1], len(bytes_arr) - 1)
            return np.where(ok, bytes_arr[idx], 0).astype(np.uint8)

        ref_first = _first_chars(ref_ok, ref_bytes, ref_fd.offsets)
        alt_first = _first_chars(alt_ok & (alt_len > 0), alt_bytes,
                                 alt_fd.offsets)
        if N and len(alt_bytes):
            pipe_cum = np.concatenate(
                [[0], np.cumsum(alt_bytes == ord("|"))])
            alt_npipe = (pipe_cum[alt_fd.offsets[1:]]
                         - pipe_cum[alt_fd.offsets[:-1]])
        else:
            alt_npipe = np.zeros(N, np.int64)
        # pure ref block: 1-base REF, single ALT == NON_REF ('&')
        cell_refblock = (ref_ok & alt_ok & (ref_len == 1)
                         & (alt_npipe == 0) & (alt_first == ord("&")))
        am = (ref_len, alt_len, ref_ok, alt_ok, ref_bytes, alt_bytes,
              ref_first, alt_first, cell_refblock)
        store._allele_meta_cache = am
    (ref_len, alt_len, ref_ok, alt_ok, ref_bytes, alt_bytes, ref_first,
     alt_first, cell_refblock) = am
    # deletions require multi-base REF: decode just those cells
    cell_hasdel = np.zeros(N, dtype=bool)
    # per-cell REF/ALT string codes (store-cached, vectorized): the
    # allele merge depends only on the (REF, ALT, starting) pattern, so
    # records sharing a pattern compute the merge ONCE via sig_cache
    ref_codes, ref_uniq = _string_codes_cached(store, "REF", ref_fd)
    alt_codes, alt_uniq = _string_codes_cached(store, "ALT", alt_fd)
    alt_parsed = [a.split("|") for a in alt_uniq]

    def get_ref(ci: int) -> Optional[str]:
        c = ref_codes[ci]
        return ref_uniq[c] if c >= 0 else None

    def get_alts(ci: int) -> Optional[List[str]]:
        c = alt_codes[ci]
        return alt_parsed[c] if c >= 0 else None

    # per-deletion-cell rewrite state (handle_deletions,
    # broad_combined_gvcf.cc:912-1078): reduced-space alleles + the
    # reduced->input inverse LUT.  The "lowest deletion" choice (argmin
    # PL at the homozygous-deletion genotype) depends only on the cell,
    # so it is precomputed ONCE per (row subset, queried PL/GT) and
    # cached on the store — interval queries must not rescan all cells.
    pl_q = qc.is_queried("PL")
    gt_q = qc.is_queried("GT")
    gt_fd = store.fields.get("GT")
    pl_fd = store.fields.get("PL")
    gt_info = qc.vid.get_field_info("GT")
    _del_key = (tuple(rows), pl_q, gt_q)
    _del_cache = getattr(store, "_del_state_cache", None)
    if _del_cache is not None and _del_cache[0] == _del_key:
        cell_hasdel, del_state = _del_cache[1]
        _del_hit = True
    else:
        del_state = {}
        _del_hit = False
    present = np.zeros(N, dtype=bool)
    if N and not _del_hit:
        present[cell_of[cell_of >= 0]] = True
    cand = np.nonzero(present & ref_ok & alt_ok & (ref_len > 1))[0] \
        if not _del_hit else np.zeros(0, dtype=np.int64)
    if len(cand):
        # Candidate cells are grouped by their (REF, ALT) byte signature
        # — cohorts carry few distinct allele strings, so each signature
        # is parsed ONCE and only the per-cell min-PL deletion choice is
        # computed, vectorized.  (A deletion-heavy 100-sample cohort has
        # ~N_samples identical cells per deletion site; the old per-cell
        # loop dominated store_to_block.)
        ploidy_cell = np.zeros(N, dtype=np.int64)
        if gt_q and gt_fd is not None and gt_info is not None:
            glens_all = gt_fd.lens()
            uniq_gl = np.unique(glens_all)
            pu = np.array([gt_info.length.ploidy(int(g)) if g else 0
                           for g in uniq_gl], dtype=np.int64)
            ploidy_cell = np.where(
                gt_fd.valid, pu[np.searchsorted(uniq_gl, glens_all)], 0)
        pl_have = np.zeros(N, dtype=bool)
        if pl_q and pl_fd is not None:
            pl_have = np.asarray(pl_fd.valid, dtype=bool)
        ro, ao = ref_fd.offsets, alt_fd.offsets
        rb, ab = ref_bytes.tobytes(), alt_bytes.tobytes()
        groups: Dict[bytes, List[int]] = {}
        for ci in cand.tolist():
            key = rb[ro[ci]:ro[ci + 1]] + b"\x00" + ab[ao[ci]:ao[ci + 1]]
            groups.setdefault(key, []).append(ci)
        INT32_TOP = np.int64(2**31 - 1)
        for key, cis in groups.items():
            rs, as_ = key.split(b"\x00", 1)
            r = rs.decode()
            a = as_.decode().split("|")
            # contains_deletion (known_field_info.cc:310-319): '*' is
            # symbolic and does NOT trigger the rewrite by itself
            if not any((not M.is_symbolic_allele(x)) and len(x) < len(r)
                       for x in a):
                continue
            cia = np.asarray(cis, dtype=np.int64)
            cell_hasdel[cia] = True
            base = np.full(len(a) + 1, M.LUT_MISSING, dtype=np.int32)
            base[0] = 0
            has_nr = False
            dels: List[int] = []
            for i, alt in enumerate(a):
                if alt == "*" or (not M.is_symbolic_allele(alt)
                                  and len(alt) < len(r)):
                    dels.append(i + 1)
                elif alt.startswith("&"):
                    base[i + 1] = 2
                    has_nr = True
            new_alts = ["*", "&"] if has_nr else ["*"]
            # "lowest deletion": argmin PL at the homozygous-deletion
            # genotype, first deletion on ties / no valid PL
            lowest = np.full(len(cia), dels[0], dtype=np.int64)
            have = pl_have[cia]
            if have.any():
                pv = np.asarray(pl_fd.values)
                po = pl_fd.offsets
                dela = np.asarray(dels, dtype=np.int64)
                pls_c = ploidy_cell[cia]
                for p in np.unique(pls_c[have]).tolist():
                    sel = have & (pls_c == p)
                    rows = cia[sel]
                    gidx = np.array([M.genotype_index([d] * int(p))
                                     for d in dels], dtype=np.int64)
                    plen = po[rows + 1] - po[rows]
                    ok = gidx[None, :] < plen[:, None]
                    src = po[rows][:, None] + np.minimum(
                        gidx[None, :], np.maximum(plen[:, None] - 1, 0))
                    src = np.minimum(src, max(len(pv) - 1, 0))
                    vals = np.where(ok, pv[src].astype(np.int64),
                                    INT32_TOP)
                    pick = np.argmin(vals, axis=1)
                    upd = vals[np.arange(len(rows)), pick] < INT32_TOP
                    lowest[sel] = np.where(upd, dela[pick], dels[0])
            # one shared (alts, lut, inv) per distinct lowest-del choice
            var_cache: Dict[int, Tuple[List[str], np.ndarray,
                                       np.ndarray]] = {}
            for ci, ld in zip(cis, lowest.tolist()):
                st = var_cache.get(ld)
                if st is None:
                    row = base.copy()
                    row[ld] = 1
                    st = (new_alts, row, M.inverse_lut(row, 3))
                    var_cache[ld] = st
                del_state[ci] = st
    if not _del_hit:
        store._del_state_cache = (_del_key, (cell_hasdel, del_state))

    # --- record starts: events, expanded to SINGLE POSITIONS while any
    # live call contains a deletion (the scan's single-position stepping,
    # query_variants.cc:310 / scan.py min_end = current_start) ---
    def _live_at(sts: np.ndarray) -> np.ndarray:
        lv = np.full((len(sts), S), -1, dtype=np.int64)
        for s in range(S):
            idx = np.searchsorted(col[s], sts, side="right") - 1
            ok = idx >= 0
            idxc = np.clip(idx, 0, C - 1)
            ok &= end[s, idxc] >= sts
            lv[:, s] = np.where(ok, idxc, -1)
        return lv

    from ..runtime import native_loader as _NL
    starts = events
    if N and cell_hasdel.any() and len(events) and S:
        _sw0 = _NL.live_sweep(col, end, cell_of, events)
        if _sw0 is not None:
            live0, cells0, _, end0min = _sw0
            ok0 = live0 >= 0
        else:
            live0 = _live_at(events)
            ok0 = live0 >= 0
            k0 = np.clip(live0, 0, C - 1)
            sg0 = np.arange(S)[None, :]
            cells0 = np.where(ok0, cell_of[sg0, k0], -1)
            end0min = np.where(ok0, end[sg0, k0],
                               INT64_MAX).min(axis=1)
        rec_del0 = (ok0 & cell_hasdel[np.clip(cells0, 0, N - 1)]
                    ).any(axis=1)
        if rec_del0.any():
            nxt0 = np.empty(len(events), dtype=np.int64)
            nxt0[:-1] = events[1:] - 1
            nxt0[-1] = INT64_MAX - 2
            hi_b = interval[1] if interval is not None else INT64_MAX - 2
            end0 = np.minimum(np.minimum(nxt0, end0min), hi_b)
            seg = np.where(rec_del0, np.maximum(end0 - events + 1, 1),
                           1).astype(np.int64)
            from ..store.columnar import _ragged_arange
            starts = _ragged_arange(events, seg)
    if pad_records is not None and len(starts) < pad_records:
        # sentinel starts beyond any cell: no live cells -> the writer
        # emits nothing for them (uniform B across chunks)
        starts = np.concatenate([
            starts, np.full(pad_records - len(starts), INT64_MAX - 1,
                            dtype=np.int64)])
    B = len(starts)
    # effective merged-allele cap for this block: the reference's 50-alt
    # genotyping cap, tightened by (a) the block's ploidy × the
    # genotype-table budget, (b) the block's [B*S, G] / [S*C, G_in]
    # PL-tensor byte budget, and (c) the query's max_diploid_alt_alleles
    # knob.  Records past the cap splice to the sequential engine
    # (which skips their genotype-length fields with the reference's
    # warning semantics, combine.py _too_many_alts).
    cap = min(merged_cap(ploidy, block_elems=max(B * S, S * C)),
              qc.params.max_diploid_alt_alleles_that_can_be_genotyped
              + 1)
    # --- [B, S] live-cell views: one threaded native sweep emits the
    # live indices, store cell indices, starts-here flags, and the
    # per-record end minimum in a single O(C+B)-per-sample walk ---
    _sw = _NL.live_sweep(col, end, cell_of, starts) if S else None
    if _sw is not None:
        live, cells_mat, _start_eq, end_min = _sw
        live = live.astype(np.int64)
        live_ok = live >= 0
        live_k = np.clip(live, 0, C - 1)
        s_grid = np.arange(S)[None, :]
        safe_cm = np.clip(cells_mat, 0, max(N - 1, 0))
        col_mat = None
    else:
        live = _live_at(starts)
        live_ok = live >= 0
        live_k = np.clip(live, 0, C - 1)
        s_grid = np.arange(S)[None, :]
        cells_mat = np.where(live_ok, cell_of[s_grid, live_k], -1)
        safe_cm = np.clip(cells_mat, 0, max(N - 1, 0))
        col_mat = np.where(live_ok, col[s_grid, live_k], INT64_MAX)
        _start_eq = None
        end_min = np.where(live_ok, end[s_grid, live_k],
                           INT64_MAX).min(axis=1) if S else None
    hi_bound = interval[1] if interval is not None else INT64_MAX - 1
    nxt = np.empty(B, dtype=np.int64)
    nxt[:-1] = starts[1:] - 1
    if B:
        nxt[-1] = INT64_MAX - 1
    rec_ends = np.minimum(np.minimum(nxt, end_min)
                          if S else nxt, hi_bound)
    rec_hasdel = (live_ok & cell_hasdel[safe_cm]).any(axis=1) \
        if N else np.zeros(B, dtype=bool)
    var_mat = live_ok & ~cell_refblock[safe_cm] if N \
        else np.zeros((B, S), dtype=bool)
    rec_is_var = var_mat.any(axis=1)
    rec_refonly = ~rec_is_var
    rec_num_merged = np.where(rec_refonly, 2, 1).astype(np.int32)
    rec_has_nr = np.ones(B, dtype=bool)   # ref blocks always carry &
    # Allele LUTs per (record, sample) — the gathered form the remap
    # kernels consume.  A per-record LUT (not per-cell) is required for
    # multi-position variant cells (e.g. MNPs): the same cell can merge
    # against a different variant set in each record it spans.
    # inv_bs starts at the requested max_merged and GROWS (bucketed to
    # powers of two, capped at MAX_MERGED_CAP) when a record merges more
    # alleles — replacing the old splice-at->max_merged behaviour.
    # Only records beyond the cap still splice (the reference's own
    # too-many-alleles territory, broad_combined_gvcf.cc 50-alt cutoff).
    inv_bs = np.full((B, S, max_merged), -1, dtype=np.int32)
    nr_bs = np.full((B, S), -1, dtype=np.int32)
    # identity LUT for every live slot of a ref-only record (all such
    # cells are pure ref blocks, so [0, NON_REF] is exact)
    touch_b, touch_s = np.nonzero(live_ok & rec_refonly[:, None])
    inv_bs[touch_b, touch_s, 0] = 0
    inv_bs[touch_b, touch_s, 1] = 1
    nr_bs[touch_b, touch_s] = 1
    # merged REF of ref-only records: first row whose live cell STARTS
    # here.  rec_refs/rec_alts are object arrays so group-level results
    # scatter with one fancy-index store per signature group; records of
    # a group share ONE alts list object (the renderer memoizes on
    # identity).
    rec_refs = np.full(B, None, dtype=object)
    rec_alts = np.empty(B, dtype=object)
    rec_alts.fill(["&"])
    if col_mat is None:
        start_eq_bs = _start_eq
    else:
        start_eq_bs = live_ok & (col_mat == starts[:, None])
    start_here = (start_eq_bs & ref_ok[safe_cm]) if N \
        else np.zeros((B, S), dtype=bool)
    ref_rows = np.nonzero(rec_refonly & start_here.any(axis=1))[0]
    if len(ref_rows):
        s0 = np.argmax(start_here[ref_rows], axis=1)
        c0s = cells_mat[ref_rows, s0]
        chars = ref_first[c0s]
        single = ref_len[c0s] == 1
        if single.any():
            txt = chars[single].astype(np.uint8).tobytes() \
                .decode("latin-1")
            rec_refs[ref_rows[single]] = np.array(list(txt),
                                                  dtype=object)
        for b, c0 in zip(ref_rows[~single].tolist(),
                         c0s[~single].tolist()):
            rec_refs[b] = get_ref(int(c0))
    # --- variant records: per-record allele merge (host strings) ---
    # The merged REF only includes calls STARTING at the record
    # (GA4GHOperator skips col < variant.start, variant_operations.cc
    # refs collection); the ALT merge includes every live variant call.
    # merge results keyed by (REF, ALT, starting) pattern — STORE-WIDE:
    # real cohorts repeat allele patterns across records and queries, so
    # interval queries reuse prior merges instead of re-running the
    # host-string merge (the dense layout is invalidated with the store).
    # Deletion-rewritten records key by cell identity and fold in
    # del_state, which depends on the queried attribute set — those
    # entries stay per-query.
    sig_cache: Dict[Tuple, Tuple] = lay.setdefault("_sig_cache", {})
    sig_cache_local: Dict[Tuple, Tuple] = {}
    rec_overflow: List[int] = []
    del_rw = np.zeros((B, S), dtype=bool)
    gt_override: Dict[Tuple[int, int], np.ndarray] = {}
    var_bs = np.nonzero(rec_is_var)[0]
    fast_done = np.zeros(B, dtype=bool)
    if len(var_bs) and N:
        # --- vectorized fast path: group variant records by their full
        # per-slot (ref_code, alt_code, starting) signature; the merge
        # runs once per group and the LUT scatter is one fancy-index op
        # per group instead of per record.  Records with any
        # deletion-rewritten call keep the per-record path below.
        start_eq = start_eq_bs
        cell_in_del = np.zeros(N, dtype=bool)
        if del_state:
            cell_in_del[np.fromiter(del_state.keys(),
                                    dtype=np.int64)] = True
        rw_any = (var_mat & cell_in_del[safe_cm] & ~start_eq
                  ).any(axis=1)
        fast_bs = var_bs[~rw_any[var_bs]]
        var_bs = var_bs[rw_any[var_bs]]
        if len(fast_bs):
            vm = var_mat[fast_bs]
            scm = safe_cm[fast_bs]
            sig = np.full((len(fast_bs), S, 3), -1, dtype=np.int32)
            sig[..., 0] = np.where(vm, ref_codes[scm], -1)
            sig[..., 1] = np.where(vm, alt_codes[scm], -1)
            sig[..., 2] = np.where(vm, start_eq[fast_bs], -1)
            # bytes-key groupby: np.unique(axis=0) lexsorts the 3*S-wide
            # rows (milliseconds per interval at 1000-sample width);
            # hashing each row's bytes is linear
            sig2 = np.ascontiguousarray(sig.reshape(len(fast_bs),
                                                    3 * S))
            row_bytes = sig2.view(np.uint8).reshape(len(fast_bs), -1)
            grp: Dict[bytes, List[int]] = {}
            for i in range(len(fast_bs)):
                grp.setdefault(row_bytes[i].tobytes(), []).append(i)
            groups_fast = list(grp.values())
            start_any = start_here.any(axis=1)
            for g in range(len(groups_fast)):
                idxs_g = np.asarray(groups_fast[g], dtype=np.int64)
                members = fast_bs[idxs_g]
                b0 = int(members[0])
                s_var = np.nonzero(var_mat[b0])[0]
                var_cells = [int(c) for c in cells_mat[b0, s_var]]
                starting = tuple(bool(x)
                                 for x in start_eq[b0, s_var])
                sig_key = (tuple(ref_codes[var_cells].tolist()),
                           tuple(alt_codes[var_cells].tolist()),
                           starting)
                got = sig_cache.get(sig_key)
                if got is None:
                    # dedup identical (REF, ALT, starting) calls to
                    # CLASSES before the Python-string merge: the merge
                    # is idempotent over duplicate calls (seen-dict /
                    # longest-REF updates are no-ops), so running it
                    # over class representatives in first-occurrence
                    # order is exactly equivalent — O(#classes) Python
                    # work instead of O(#samples) at cohort width
                    refc = ref_codes[var_cells].astype(np.int64)
                    altc = alt_codes[var_cells].astype(np.int64)
                    stb = np.fromiter((1 if st else 0
                                       for st in starting),
                                      dtype=np.int64,
                                      count=len(starting))
                    arr = np.stack([refc, altc, stb], axis=1)
                    _, first, invmap = np.unique(
                        arr, axis=0, return_index=True,
                        return_inverse=True)
                    order = np.argsort(first, kind="stable")
                    rank = np.empty(len(order), np.int64)
                    rank[order] = np.arange(len(order))
                    class_of = rank[invmap]       # per call, 1st-occ order
                    reps = first[order]           # representative calls
                    call_refs_u = [get_ref(var_cells[int(i)])
                                   for i in reps]
                    call_alts_u = [get_alts(var_cells[int(i)])
                                   for i in reps]
                    starting_u = [starting[int(i)] for i in reps]
                    start_refs = [r for r, st
                                  in zip(call_refs_u, starting_u) if st]
                    merged_ref = M.merge_reference_allele(start_refs) \
                        if start_refs else None
                    alt_merge_ref = merged_ref \
                        if merged_ref is not None else "N"
                    merged_alts, lut_u, non_ref = M.merge_alt_alleles(
                        call_refs_u, call_alts_u, alt_merge_ref)
                    inv_rows_u = M.inverse_lut_matrix(
                        np.asarray(lut_u), len(merged_alts) + 1)
                    inv_rows = inv_rows_u[class_of]
                    got = (merged_ref, merged_alts, non_ref, inv_rows,
                           {})
                    sig_cache[sig_key] = got
                merged_ref, merged_alts, non_ref, inv_rows, _ = got
                nm = len(merged_alts) + 1
                if inv_bs.shape[2] < nm <= cap:
                    grow = min(cap,
                               max(max_merged,
                                   1 << (nm - 1).bit_length()))
                    inv_bs = np.pad(
                        inv_bs,
                        ((0, 0), (0, 0), (0, grow - inv_bs.shape[2])),
                        constant_values=-1)
                W = min(nm, inv_bs.shape[2])
                rec_num_merged[members] = W
                rec_has_nr[members] = non_ref
                if nm > cap:
                    rec_overflow.extend(members.tolist())
                inv_w = inv_rows[:, :inv_bs.shape[2]]
                inv_bs[np.ix_(members, s_var,
                              np.arange(inv_w.shape[1]))] = inv_w[None]
                if non_ref:
                    nr_bs[np.ix_(members, s_var)] = inv_w[:, W - 1][None]
                alts_list = list(merged_alts)
                wrap = np.empty(1, dtype=object)
                wrap[0] = alts_list
                rec_alts[members] = wrap
                if merged_ref is not None:
                    wrap_r = np.empty(1, dtype=object)
                    wrap_r[0] = merged_ref
                    rec_refs[members] = wrap_r
                else:
                    for b in members.tolist():
                        if start_any[b]:
                            c0 = int(cells_mat[
                                b, int(np.argmax(start_here[b]))])
                            rec_refs[b] = (chr(ref_first[c0])
                                           if ref_len[c0] == 1
                                           else get_ref(c0))
                fast_done[members] = True
            # ref-block slots of fast-path records: identity REF +
            # NON_REF -> the record's merged last slot, one scatter
            rb_b, rb_s = np.nonzero(live_ok & ~var_mat
                                    & fast_done[:, None])
            if len(rb_b):
                inv_bs[rb_b, rb_s, 0] = 0
                ha = alt_ok[cells_mat[rb_b, rb_s]]
                hb, hs = rb_b[ha], rb_s[ha]
                inv_bs[hb, hs,
                       rec_num_merged[hb].astype(np.int64) - 1] = 1
                nr_bs[hb, hs] = 1
    for b in var_bs:
        b = int(b)
        srows = np.nonzero(live_ok[b])[0]
        var_sel = var_mat[b, srows]
        s_var = srows[var_sel]
        var_cells = [int(c) for c in cells_mat[b, s_var]]
        starting = tuple(bool(start_eq_bs[b, s]) for s in s_var)
        # spanning-deletion calls (cell has a deletion, record starts
        # past the cell): rewritten to REF=N / ALT=*,<NON_REF> before
        # the merge (handle_deletions, broad_combined_gvcf.cc:912-1078)
        rewritten = tuple(c in del_state and not st
                          for c, st in zip(var_cells, starting))
        if any(rewritten):
            # deletion-rewritten calls fold per-cell PL-argmin state
            # into the merge: key by cell identity (per-query cache —
            # del_state depends on the queried attributes)
            sig = ("c", tuple(var_cells), starting)
            cache = sig_cache_local
        else:
            # the merge depends only on the (REF, ALT) string pattern:
            # records sharing it reuse one merge + inverse-LUT result
            sig = (tuple(ref_codes[var_cells].tolist()),
                   tuple(alt_codes[var_cells].tolist()), starting)
            cache = sig_cache
        got = cache.get(sig)
        if got is None:
            call_refs, call_alts = [], []
            for c, st, rw in zip(var_cells, starting, rewritten):
                if rw:
                    call_refs.append("N")
                    call_alts.append(del_state[c][0])
                else:
                    call_refs.append(get_ref(c))
                    call_alts.append(get_alts(c))
            start_refs = [r for r, st in zip(call_refs, starting) if st]
            merged_ref = M.merge_reference_allele(start_refs) \
                if start_refs else None
            # suffix extension in the ALT merge needs a concrete REF
            alt_merge_ref = merged_ref if merged_ref is not None else "N"
            merged_alts, lut, non_ref = M.merge_alt_alleles(
                call_refs, call_alts, alt_merge_ref)
            inv_rows = M.inverse_lut_matrix(
                np.asarray(lut), len(merged_alts) + 1)
            # rewritten calls: compose merged->reduced with the cell's
            # reduced->input LUT so the batched kernels do ONE remap
            # equal to the reference's two-step rewrite+merge remap
            for i, (c, rw) in enumerate(zip(var_cells, rewritten)):
                if rw:
                    inv1 = del_state[c][2]
                    row = inv_rows[i]
                    comp = inv1[np.clip(row, 0, 2)]
                    inv_rows[i] = np.where(row >= 0, comp, -1)
            lut_rw = {i: np.asarray(lut[i]).copy()
                      for i, rw in enumerate(rewritten) if rw}
            got = (merged_ref, merged_alts, non_ref, inv_rows, lut_rw)
            cache[sig] = got
        merged_ref, merged_alts, non_ref, inv_rows, lut_rw = got
        if any(rewritten):
            del_rw[b, s_var[np.asarray(rewritten)]] = True
        rec_has_nr[b] = non_ref
        nm = len(merged_alts) + 1
        if inv_bs.shape[2] < nm <= cap:
            grow = min(cap,
                       max(max_merged, 1 << (nm - 1).bit_length()))
            inv_bs = np.pad(inv_bs,
                            ((0, 0), (0, 0), (0, grow - inv_bs.shape[2])),
                            constant_values=-1)
        rec_num_merged[b] = min(nm, inv_bs.shape[2])
        if merged_ref is not None:
            rec_refs[b] = merged_ref
        elif start_here[b].any():
            c0 = int(cells_mat[b, int(np.argmax(start_here[b]))])
            rec_refs[b] = (chr(ref_first[c0]) if ref_len[c0] == 1
                           else get_ref(c0))
        rec_alts[b] = list(merged_alts)
        if nm > cap:
            # more merged alleles than the cap: the device remap would
            # silently truncate -> sequential splice (the sequential
            # engine then applies the reference's too-many-alts skip)
            rec_overflow.append(b)
        W = min(nm, inv_bs.shape[2])
        # variant samples: their index in var_cells IS their position
        # among var-selected srows (one cell belongs to one row)
        inv_w = inv_rows[:, :inv_bs.shape[2]]
        inv_bs[b, s_var[:, None],
               np.arange(inv_w.shape[1])[None, :]] = inv_w
        if non_ref:
            nr_bs[b, s_var] = inv_w[:, W - 1]
        # ref-block samples: identity REF + NON_REF -> merged last slot
        s_rb = srows[~var_sel]
        if len(s_rb):
            inv_bs[b, s_rb, 0] = 0
            has_alt = alt_ok[cells_mat[b, s_rb]]
            inv_bs[b, s_rb[has_alt], W - 1] = 1
            nr_bs[b, s_rb[has_alt]] = 1
        # produce_GT x spanning deletion: the reference derives GT from
        # the min-PL genotype in the REDUCED space, then remaps it onto
        # the merge (broad_combined_gvcf.cc:912-1078 + GA4GH GT remap);
        # the composed device remap cannot express the argmin, so the
        # handful of rewritten calls get host-computed overrides
        if plan.produce_gt and any(rewritten) and nm <= cap:
            for i, (c, rw) in enumerate(zip(var_cells, rewritten)):
                if not rw:
                    continue
                ov = _deletion_gt_override(
                    c, del_state[c], lut_rw[i], nm, non_ref, plan,
                    gt_fd, pl_fd, gt_info, pl_q)
                if ov is not None:
                    gt_override[(b, int(s_var[i]))] = ov
    # effective block width after any allele-merge growth (the PL/AD
    # INPUT slabs are store-global maxima from dense_layout — the remap
    # masks make any width >= the true per-cell length exact)
    max_merged = inv_bs.shape[2]
    # splice decision is plan-driven: records carrying a valid queried
    # field the block path cannot realize go to the sequential engine
    handled = plan.handled
    rec_hasother = np.zeros(B, dtype=bool)
    if rec_overflow:
        rec_hasother[rec_overflow] = True
    for name, fd in store.fields.items():
        if name in handled or fd.valid is None or not fd.valid.any():
            continue
        if not qc.is_queried(name):
            # stored but unqueried fields never render (the sequential
            # writer only consumes qc.attributes) -> no splice needed
            continue
        if N:
            rec_hasother |= (live_ok & fd.valid[safe_cm]).any(axis=1)
    # ploidy beyond the batched enumeration cap: splice (the genotype
    # count explodes combinatorially; the reference's general-ploidy
    # iterative enumeration territory, variant_field_handler.cc:199-296)
    if N and gt_fd is not None and qc.is_queried("GT"):
        cell_gt_bad = getattr(store, "_gt_bad_cache", None)
        if cell_gt_bad is None:
            glens = gt_fd.lens()
            if gt_info is not None:
                # map stored length -> ploidy via the few distinct
                # lengths (searchsorted lookup; never a per-cell loop)
                uniq = np.unique(glens)
                pl_u = np.array([gt_info.length.ploidy(int(g)) if g
                                 else 0 for g in uniq], dtype=np.int64)
                pls = pl_u[np.searchsorted(uniq, glens)]
            else:
                pls = glens
            cell_gt_bad = gt_fd.valid & (pls > PLOIDY_CAP)
            store._gt_bad_cache = cell_gt_bad
        rec_hasother |= (live_ok & cell_gt_bad[safe_cm]).any(axis=1)
    gt_len_bs = np.where(live_ok, gt_len_sc[s_grid, live_k],
                         0).astype(np.int32)
    if N and gt_fd is not None:
        # invalid GT -> length 0 (renders '.', matching CallView rules)
        gt_len_bs = np.where(
            live_ok & _eff_valid_store(store, "GT", N)[safe_cm],
            gt_len_bs, 0)
    blk = CellBlock(col=col, end=end, pl=pl, pl_len=pl_len, ad=ad,
                    ad_len=ad_len, gt=gt, gq=gq, dp=dp, min_dp=min_dp,
                    dp_info=dp_info, info_f=info_f, info_i=info_i,
                    info_fs=info_fs,
                    inv_bs=inv_bs, nr_bs=nr_bs, starts=starts,
                    rec_num_merged=rec_num_merged, rec_has_nr=rec_has_nr,
                    live=live.astype(np.int32), del_rw=del_rw,
                    gt_len_bs=gt_len_bs, ploidy=ploidy,
                    gt_phase=plan.gt_phase)
    # the slab tensors come from the store-wide layout cache: the
    # combine paths key their device-resident copies on it
    blk._dense_layout = lay
    if not return_meta:
        return blk
    # --- gathered extras + effective-validity masks for the writer ---
    CORE_FMT = {"GT", "GQ", "AD", "PL", "MIN_DP", "DP_FORMAT", "DP"}
    extras: Dict[str, ExtraField] = {}
    eff_cache: Dict[str, np.ndarray] = {}

    def eff_valid_bs(name):
        if N == 0:
            return np.zeros((B, S), dtype=bool)
        return live_ok & _eff_valid_store(store, name, N)[safe_cm]

    def gather_vals(name, width, dtype=np.int32, fill=INT_MISSING):
        """Per-(record, sample) live-cell values [B, S, width] gathered
        straight from the store via the live-cell matrix — no [S, C, W]
        all-cells intermediate (that build dominated wide-cohort extras
        gathering)."""
        out = np.full((B * S, width), fill, dtype=dtype)
        lens_bs = np.zeros(B * S, dtype=np.int32)
        fd = store.fields.get(name)
        if fd is None or N == 0:
            return out.reshape(B, S, width), lens_bs.reshape(B, S)
        flat = safe_cm.reshape(-1)
        ok = live_ok.reshape(-1) & fd.valid[flat]
        sel = np.nonzero(ok)[0]
        if fd.kind == "fixed":
            w = min(width, fd.values.shape[1])
            out[sel, :w] = fd.values[flat[sel], :w]
            lens_bs[sel] = fd.values.shape[1]
        else:
            from ..store.columnar import copy_ragged_segments
            cell_lens = fd.lens()
            ln = np.minimum(cell_lens[flat[sel]], width)
            src0 = fd.offsets[:-1][flat[sel]]
            copy_ragged_segments(fd.values, src0, ln,
                                 sel.astype(np.int64) * width,
                                 out.reshape(-1))
            lens_bs[sel] = cell_lens[flat[sel]]
        return out.reshape(B, S, width), lens_bs.reshape(B, S)

    # per-call ploidy for G-length extras: derived from the stored GT
    # length exactly like the sequential engine (CombineOperator: ploidy
    # is 0 unless GT is queried AND the call's GT is valid)
    _ploidy_ext = None

    def ploidy_ext():
        nonlocal _ploidy_ext
        if _ploidy_ext is None:
            if qc.is_queried("GT") and gt_info is not None:
                gl = gt_len_bs.astype(np.int64)
                uniq = np.unique(gl)
                pl_u = np.array(
                    [gt_info.length.ploidy(int(g)) if g else 0
                     for g in uniq], dtype=np.int64)
                _ploidy_ext = pl_u[np.searchsorted(uniq, gl)]
            else:
                _ploidy_ext = np.zeros((B, S), dtype=np.int64)
        return _ploidy_ext

    def remap_g(vals, lens_bs, v_bs, fill):
        """G-length remap with the sequential operator's record rule:
        ref-block-only records render RAW values (remapping_needed is
        False there), all others the genotype-remapped view."""
        vals_r, ng = remap_genotype_np(vals, lens_bs, inv_bs, nr_bs,
                                       rec_num_merged, ploidy_ext(),
                                       fill)
        ro = rec_refonly[:, None]
        W = max(vals.shape[2], vals_r.shape[2])

        def padw(x):
            return np.pad(x, ((0, 0), (0, 0), (0, W - x.shape[2])),
                          constant_values=fill)
        out = np.where(ro[..., None], padw(vals), padw(vals_r))
        return out, np.where(v_bs, np.where(ro, lens_bs, ng), 0)

    for spec in plan.format_specs:
        if spec.name in CORE_FMT:
            continue
        fd = store.fields.get(spec.name)
        v_bs = eff_valid_bs(spec.name)
        if spec.kind == "char" or fd is None:
            extras[spec.name] = ExtraField(spec, None, v_bs)
            continue
        is_f = spec.kind == "float"
        dtype = np.float32 if is_f else np.int32
        fill = formats.FLOAT_MISSING if is_f else INT_MISSING
        if spec.wkind in ("scalar", "fixed"):
            vals, lens_bs = gather_vals(spec.name, spec.width, dtype, fill)
        elif spec.wkind in ("A", "R"):
            w_in = max_merged - (1 if spec.wkind == "A" else 0)
            vals, lens_bs = gather_vals(spec.name, max(w_in, 1), dtype,
                                        fill)
            vals = remap_allele_np(vals, lens_bs, inv_bs, nr_bs,
                                   rec_num_merged,
                                   alt_only=spec.wkind == "A",
                                   missing=fill)
        elif spec.wkind == "VAR":
            w = fd.max_len() if fd.kind == "ragged" \
                and len(fd.offsets) > 1 else 1
            vals, lens_bs = gather_vals(spec.name, max(w, 1), dtype, fill)
        elif spec.wkind == "G":   # G-length non-PL (e.g. float GL)
            w = fd.max_len() if fd.kind == "ragged" \
                and len(fd.offsets) > 1 else \
                (fd.values.shape[1] if fd.kind == "fixed" else 1)
            vals, lens_bs = gather_vals(spec.name, max(w, 1), dtype, fill)
            vals, lens_bs = remap_g(vals, lens_bs, v_bs, fill)
        else:
            continue
        extras[spec.name] = ExtraField(spec, vals, v_bs, lens_bs)
    for spec in plan.info_specs:
        if spec.source != "host":
            continue
        fd = store.fields.get(spec.name)
        v_bs = eff_valid_bs(spec.name) & ~del_rw
        if fd is None or spec.is_2d or fd.kind == "ragged2d":
            extras[spec.name] = ExtraField(spec, None, v_bs)
            continue
        dtype = np.float32 if spec.is_float else np.int32
        fill = formats.FLOAT_MISSING if spec.is_float else INT_MISSING
        if fd.kind == "fixed":
            w = fd.values.shape[1]
        else:
            w = fd.max_len() if len(fd.offsets) > 1 \
                else 1
        vals, lens_bs = gather_vals(spec.name, max(w, 1), dtype, fill)
        if spec.length_code is not None and \
                spec.length_code in (kf.VL_A, kf.VL_R):
            vals = remap_allele_np(vals, lens_bs, inv_bs, nr_bs,
                                   rec_num_merged,
                                   alt_only=spec.length_code == kf.VL_A,
                                   missing=fill)
            lens_bs = np.where(
                v_bs, rec_num_merged[:, None]
                - (1 if spec.length_code == kf.VL_A else 0), 0)
        elif spec.length_code == kf.VL_G:
            vals, lens_bs = remap_g(vals, lens_bs, v_bs, fill)
        extras[spec.name] = ExtraField(spec, vals, v_bs, lens_bs)
    for parent, bin_f, cnt_f in plan.hist_specs:
        for nm_h in (bin_f, cnt_f):
            extras[nm_h] = ExtraField(None, None,
                                      eff_valid_bs(nm_h) & ~del_rw)
    valid_core = {name: eff_valid_bs(name)
                  for name in CORE_FMT if name in store.fields}
    # rows carrying ANY valid INFO median/sum input (exact superset of
    # device-side validity): the combine restricts its cross-sample
    # sorts to these rows — on wide cohorts the [F, B, S] median sorts
    # are most of the device time, and gVCF ref bands carry none
    med_rows = np.zeros(0, dtype=np.int64)
    if info_f.shape[0] or info_i.shape[0] or info_fs.shape[0]:
        med_any = lay.get("med_any_sc")
        if med_any is None:
            med_any = np.zeros(info_f.shape[1:] if info_f.shape[0]
                               else (S, C), dtype=bool)
            if info_f.shape[0]:
                med_any |= np.isfinite(info_f).any(axis=0)
            if info_i.shape[0]:
                med_any |= (info_i != INT_MISSING).any(axis=0)
            if info_fs.shape[0]:
                med_any |= np.isfinite(info_fs).any(axis=0)
            lay["med_any_sc"] = med_any
        has_med = (live_ok & med_any[s_grid, live_k]).any(axis=1)
        med_rows = np.nonzero(has_med)[0]
    meta = BlockRecordMeta(ends=rec_ends, refs=rec_refs,
                           alts=rec_alts,
                           is_ref_block_only=rec_refonly,
                           has_deletion=rec_hasdel,
                           needs_fallback=rec_hasother,
                           plan=plan, extras=extras,
                           cells_mat=cells_mat, valid_core=valid_core,
                           gt_override=gt_override, med_rows=med_rows)
    return blk, meta


def _deletion_gt_override(ci, state, lut2_row, num_merged, non_ref,
                          plan, gt_fd, pl_fd, gt_info, pl_q):
    """Merged-space GT for a spanning-deletion-rewritten call under
    produce_GT: min-PL genotype in the reduced [REF,*,NON_REF] space
    when enabled and PL is valid, else the two-step GT remap — both then
    mapped onto the merge (CombineOperator.handle_deletions)."""
    if gt_fd is None or not gt_fd.valid[ci] or gt_info is None:
        return None
    new_alts, lut_row1, _inv1 = state
    gt_vals = np.asarray(
        gt_fd.values[gt_fd.offsets[ci]:gt_fd.offsets[ci + 1]]).copy()
    ploidy_c = gt_info.length.ploidy(len(gt_vals))
    if ploidy_c <= 0:
        return None
    n_red = len(new_alts) + 1
    has_nr_cell = len(new_alts) == 2
    done = False
    if plan.produce_min_pl_gt and pl_q and pl_fd is not None             and pl_fd.valid[ci]:
        pl_vals = pl_fd.values[pl_fd.offsets[ci]:pl_fd.offsets[ci + 1]]
        pl_red = M.remap_by_genotype(np.asarray(pl_vals), lut_row1,
                                     n_red, has_nr_cell, ploidy_c,
                                     INT_MISSING)
        combo = _min_pl_genotype(pl_red, n_red, ploidy_c)
        if combo is not None:
            step = 2 if plan.gt_phase else 1
            for j, i in enumerate(range(0, len(gt_vals), step)):
                gt_vals[i] = combo[j]
            done = True
    if not done:
        gt_vals = M.remap_gt_field(gt_vals, lut_row1, n_red,
                                   has_nr_cell, plan.gt_phase)
    return M.remap_gt_field(gt_vals, np.asarray(lut2_row), num_merged,
                            non_ref, plan.gt_phase)


def _min_pl_genotype(pl, num_alleles, ploidy):
    """Allele combination of the minimum valid PL value
    (variant_field_handler.cc:373-494)."""
    combos = M.genotype_combinations(num_alleles, ploidy)
    best, best_val = None, 2**31 - 1
    for gt_idx, combo in enumerate(combos):
        if gt_idx >= len(pl):
            continue
        v = int(pl[gt_idx])
        if formats.is_bcf_valid_int(v) and v < best_val:
            best_val = v
            best = list(combo)
    return best
