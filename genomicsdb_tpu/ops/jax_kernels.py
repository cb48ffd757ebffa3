"""Batched JAX/XLA kernels for the combine pipeline (the device compute path).

The sequential oracle in ops/merge.py processes one call at a time (as the
reference C++ does).  These kernels process a whole block of records at once
with static shapes:

  R = records (aligned sub-intervals) per block
  S = samples (rows)
  M = max merged alleles (padded)
  G = max genotypes     (padded)

Semantics mirror variant_field_handler.cc:42-420 (remaps) and
:530-700 (combine reductions); validated against ops/merge.py in
tests/test_jax_kernels.py.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..core import formats
from . import merge as M

INT_MISSING = formats.INT_MISSING
LUT_MISSING = -1


# ---------------- host-side tables (cached) ----------------

@lru_cache(maxsize=64)
def genotype_combo_table(num_alleles: int, ploidy: int) -> np.ndarray:
    """[G, ploidy] int32: allele indices (ascending) of genotype g, in
    canonical VCF enumeration order."""
    combos = M.genotype_combinations(num_alleles, ploidy)
    return np.asarray(combos, dtype=np.int32).reshape(len(combos), ploidy)


@lru_cache(maxsize=8)
def ncr_table(n_max: int) -> np.ndarray:
    """[n_max+1, n_max+2] nCr with the r=-1 column folded in at index 0:
    table[n, r+1] = C(n, r), table[n, 0] = 0."""
    t = np.zeros((n_max + 1, n_max + 2), dtype=np.int32)
    for n in range(n_max + 1):
        for r in range(n + 1):
            t[n, r + 1] = M._ncr(n, r)
    return t


# ---------------- device kernels ----------------

def _sorting_network(vals):
    """Ascending sort of a static-length list of equal-shape arrays
    (keeps the ploidy axis OUT of the tensors: each element is [R, S, G])."""
    vals = list(vals)
    n = len(vals)
    for i in range(n):
        for j in range(0, n - i - 1):
            lo = jnp.minimum(vals[j], vals[j + 1])
            hi = jnp.maximum(vals[j], vals[j + 1])
            vals[j], vals[j + 1] = lo, hi
    return vals


@partial(jax.jit, static_argnames=("num_merged_alleles", "ploidy"))
def remap_genotype_fields(values: jnp.ndarray, inv_lut: jnp.ndarray,
                          in_len: jnp.ndarray, input_nr: jnp.ndarray,
                          num_merged: jnp.ndarray,
                          num_merged_alleles: int, ploidy: int
                          ) -> jnp.ndarray:
    """Batched G-length remap (PL reorder).

    values:   [R, S, Gin]  int32, padded with INT_MISSING
    inv_lut:  [R, S, M]    merged-allele -> input-allele (-1 = absent)
    in_len:   [R, S]       #valid elements of `values` per call
    input_nr: [R, S]       input NON_REF allele idx (-1 = none)
    num_merged: [R]        actual #merged alleles per record
    Returns [R, S, G] remapped, INT_MISSING where no mapping.

    The ploidy axis is unrolled statically (a [.., G, P] tensor with a
    tiny P minor axis pads badly); per-slot tensors stay [R,S,G].
    """
    combos = genotype_combo_table(num_merged_alleles, ploidy)  # host np
    # the nCr table only feeds genotype-index terms for slots >= 4
    # (ploidy > 4, where merged_cap keeps num_merged_alleles small);
    # building it at the 51-allele diploid width would overflow int32
    ncr = jnp.asarray(ncr_table(num_merged_alleles + ploidy + 2)) \
        if ploidy > 4 else None
    G = combos.shape[0]
    Kv = values.shape[-1]
    # compute in [R, G, S]: the wide sample axis is minor, so a small
    # G or K axis never becomes the padded minor dimension
    v_t = jnp.swapaxes(values, 1, 2)                  # [R, Kv, S]
    inv_t = jnp.swapaxes(inv_lut, 1, 2)               # [R, M, S]
    nr = input_nr[:, None, :]                         # [R, 1, S]
    slot_alleles = []
    combo_missing = jnp.zeros((values.shape[0], G, values.shape[1]),
                              dtype=bool)
    for p in range(ploidy):
        a = inv_t[:, combos[:, p], :]                 # [R, G, S]
        a = jnp.where(a == LUT_MISSING,
                      jnp.where(nr >= 0, nr, LUT_MISSING), a)
        combo_missing = combo_missing | (a == LUT_MISSING)
        slot_alleles.append(jnp.maximum(a, 0))
    # canonical genotype index of the sorted allele vector:
    # gt = sum_i C(i + a_i, a_i - 1)  (variant_field_handler.cc:299-321)
    sorted_slots = _sorting_network(slot_alleles)
    in_gt = jnp.zeros_like(sorted_slots[0])
    for i, a in enumerate(sorted_slots):
        # C(i+a, a-1) = C(i+a, i+1): closed-form polynomial in a for the
        # static slot index i — pure VPU arithmetic instead of a 10M-index
        # 2-D table gather (the gather was ~40% of the remap kernel time)
        if i == 0:
            term = a
        elif i == 1:
            term = (a + 1) * a // 2
        elif i == 2:
            term = (a + 2) * (a + 1) * a // 6
        elif i == 3:
            term = (a + 3) * (a + 2) * (a + 1) * a // 24
        else:
            term = ncr[i + a, a]
        in_gt = in_gt + term
    in_range = in_gt < in_len[:, None, :]
    # sample-parallel gather: unrolled selects over the static Kv axis
    # (elementwise selects fuse; take_along_axis is a generic gather).  Past
    # ~32 source slots the unroll stops paying (and its compile cost
    # explodes at the 50-alt cap, Kv=C(52,2)=1326) — use the generic
    # gather there; wide-allele blocks are rare multi-allelic hotspots.
    if Kv <= 32:
        gathered = jnp.full_like(in_gt, INT_MISSING)
        for k in range(Kv):
            gathered = jnp.where(in_gt == k, v_t[:, k:k + 1, :],
                                 gathered)
    else:
        gathered = jnp.take_along_axis(
            v_t, jnp.clip(in_gt, 0, Kv - 1), axis=1)
    ok = (~combo_missing) & in_range
    # genotypes beyond the record's actual count stay missing
    max_allele = np.max(combos, axis=-1)              # [G] host
    in_record = jnp.asarray(max_allele)[None, :, None] \
        < num_merged[:, None, None]
    ok = ok & in_record
    return jnp.swapaxes(jnp.where(ok, gathered, INT_MISSING), 1, 2)


@partial(jax.jit, static_argnames=("alt_only",))
def remap_allele_fields(values: jnp.ndarray, inv_lut: jnp.ndarray,
                        in_len: jnp.ndarray, input_nr: jnp.ndarray,
                        num_merged: jnp.ndarray, alt_only: bool
                        ) -> jnp.ndarray:
    """Batched R/A-length remap (AD reorder).

    values: [R, S, K] padded; inv_lut: [R, S, M]; returns [R, S, M or M-1].
    """
    if alt_only:
        inv = inv_lut[..., 1:]
        offset = 1
    else:
        inv = inv_lut
        offset = 0
    # [R, M, S] layout: S on lanes (see remap_genotype_fields note)
    inv_t = jnp.swapaxes(inv, 1, 2)
    v_t = jnp.swapaxes(values, 1, 2)                  # [R, K, S]
    nr = input_nr[:, None, :]
    in_allele = jnp.where(inv_t == LUT_MISSING,
                          jnp.where(nr >= 0, nr, LUT_MISSING), inv_t)
    idx = in_allele - offset
    ok = (in_allele != LUT_MISSING) & (idx >= 0) \
        & (idx < in_len[:, None, :])
    Kv = values.shape[-1]
    if Kv <= 32:
        gathered = jnp.full_like(idx, INT_MISSING)
        for k in range(Kv):
            gathered = jnp.where(idx == k, v_t[:, k:k + 1, :], gathered)
    else:
        gathered = jnp.take_along_axis(
            v_t, jnp.clip(idx, 0, Kv - 1), axis=1)
    m = jnp.arange(inv_t.shape[1])[None, :, None]
    in_record = m < (num_merged[:, None, None] - offset)
    ok = ok & in_record
    return jnp.swapaxes(jnp.where(ok, gathered, INT_MISSING), 1, 2)


@jax.jit
def masked_median_int(values: jnp.ndarray, valid: jnp.ndarray) -> Tuple[
        jnp.ndarray, jnp.ndarray]:
    """Reference median semantics (variant_field_handler.cc:530-560):
    ascending nth_element at n_valid/2 over the sample axis.

    values: [R, S]; valid: [R, S] bool.  Returns (median [R], any_valid [R]).
    """
    big = jnp.iinfo(jnp.int32).max
    v = jnp.where(valid, values, big)
    v = jnp.sort(v, axis=-1)
    n = jnp.sum(valid, axis=-1)
    idx = n // 2
    med = jnp.take_along_axis(v, jnp.clip(idx, 0, v.shape[-1] - 1)[..., None],
                              axis=-1)[..., 0]
    return med, n > 0


@jax.jit
def masked_median_float(values: jnp.ndarray, valid: jnp.ndarray):
    v = jnp.where(valid, values, jnp.inf)
    v = jnp.sort(v, axis=-1)
    n = jnp.sum(valid, axis=-1)
    idx = n // 2
    med = jnp.take_along_axis(v, jnp.clip(idx, 0, v.shape[-1] - 1)[..., None],
                              axis=-1)[..., 0]
    return med, n > 0


@jax.jit
def masked_sum(values: jnp.ndarray, valid: jnp.ndarray):
    s = jnp.sum(jnp.where(valid, values, 0), axis=-1)
    return s, jnp.any(valid, axis=-1)


@jax.jit
def dp_combine(dp_info: jnp.ndarray, dp_format: jnp.ndarray,
               min_dp: jnp.ndarray, v_info: jnp.ndarray,
               v_format: jnp.ndarray, v_min: jnp.ndarray):
    """INFO DP logic (broad_combined_gvcf.cc:690-726), batched [R, S]."""
    dp_val = jnp.where(v_info, dp_info,
                       jnp.where(v_min, min_dp,
                                 jnp.where(v_format, dp_format, 0)))
    use = v_info | v_min | v_format
    sum_dp = jnp.sum(jnp.where(use, dp_val, 0), axis=-1)
    return sum_dp


@jax.jit
def live_cells_at(starts: jnp.ndarray, col_by_row: jnp.ndarray,
                  end_by_row: jnp.ndarray) -> jnp.ndarray:
    """Per (interval-start, row): index of the live cell, -1 if none.

    col_by_row/end_by_row: [S, C] per-row cell begins/effective-ENDs sorted
    ascending (padded with int64 max).  starts: [B].
    Replaces the left sweep + forward scan with a vectorized binary
    search: log2(C) unrolled rounds of [B, S] gathers.
    """
    S, C = col_by_row.shape
    B = starts.shape[0]
    st = starts[:, None]                          # [B, 1]
    s_idx = jnp.arange(S, dtype=jnp.int32)[None, :]
    # rightmost index with col <= start, via unrolled binary search for
    # the count of elements <= start in each row (index = count - 1)
    lo = jnp.zeros((B, S), dtype=jnp.int32)       # count in [lo, hi)
    hi = jnp.full((B, S), C + 1, dtype=jnp.int32)
    steps = max(1, int(np.ceil(np.log2(C + 2))))
    for _ in range(steps):
        mid = (lo + hi) // 2                      # candidate count
        probe = jnp.clip(mid, 1, C) - 1           # element mid-1
        v = col_by_row[s_idx, probe]              # [B, S] gather
        le = (v <= st) | (mid == 0)
        lo = jnp.where(le, mid, lo)
        hi = jnp.where(le, hi, mid)
    idx = lo - 1                                  # [-1 .. C-1]
    ok = idx >= 0
    idxc = jnp.clip(idx, 0, C - 1)
    ends = end_by_row[s_idx, idxc]
    live = ok & (ends >= st)
    return jnp.where(live, idxc, -1)
