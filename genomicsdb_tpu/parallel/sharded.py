"""Multi-chip sharded combine (jax.sharding + shard_map).

Parallelism maps the reference's two distribution strategies onto a 2-D
device mesh (SURVEY.md §2.7):
  * "pos"  axis: column partitions (the genome position axis) — the
    MPI-rank-per-partition model (tools/src/vcf2tiledb.cc:44-52) becomes
    position-sharded interval blocks; combine is partition-local.
  * "row"  axis: row/sample partitioning ("row_based_partitioning",
    genomicsdb_config_base.h:163) — INFO combine ops reduce across the
    sample axis, so sample-sharded execution uses collectives
    (all_gather, which XLA hands to NCCL on GPUs) instead of the
    reference's process-local loops.  Every card reaches every other at
    the same rate over NVLink, so the mesh shape follows the algorithm
    alone.

The per-shard step is the SAME `_combine_math` as the single-chip
combine_step — cross-sample reductions all_gather the sample axis over
"row" and then run identical local math, so sharded outputs are
bit-identical to unsharded ones (tests/test_sharded_equivalence.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import formats
from ..ops.combine_step import (CellBlock, _combine_math, block_to_args,
                                gather_on_device)

INT_MISSING = formats.INT_MISSING


def make_mesh(n_pos: int, n_row: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None
                         else jax.devices()[:n_pos * n_row])
    return Mesh(devices.reshape(n_pos, n_row), ("pos", "row"))


def sharded_combine_step(mesh: Mesh, max_merged: int, ploidy: int,
                         gt_phase: bool = False,
                         mixed_ploidy: bool = False):
    """Build the pjit-ed sharded combine step for a mesh.

    Records are sharded over "pos"; samples (cells) over "row".  Each
    (pos, row) shard gathers its local [B_loc, S_loc] slab and runs
    `_combine_math` with axis_name="row": sample-axis reductions
    all_gather the full sample axis (an NCCL collective on GPUs),
    remaps stay local.
    Input/output layout matches combine_step's block_to_args exactly.
    """

    def step(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info, info_f,
             info_i, info_fs, inv_bs, nr_bs, rec_num_merged, rec_has_nr,
             live, del_rw, gt_lens) -> Dict[str, jnp.ndarray]:
        g = gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                             dp_info, info_f, info_i, info_fs, live,
                             del_rw)
        out = _combine_math(g["plg"], inv_bs, g["pllg"], nr_bs, g["adg"],
                            g["adlg"], g["gtg"], g["gqg"], g["dpfg"],
                            g["mdpg"], g["dpig"], g["infog"], g["infoig"],
                            g["infofsg"], g["valid"], rec_num_merged,
                            rec_has_nr, gt_lens,
                            max_merged=max_merged, ploidy=ploidy,
                            gt_phase=gt_phase, mixed_ploidy=mixed_ploidy,
                            axis_name="row")
        out["live"] = live
        return out

    specs_in = _input_specs()
    bsr = P("pos", "row", None)    # [B, S_loc, *] per-sample outputs
    bs = P("pos", "row")
    specs_out = {
        "pl": bsr, "ad": bsr, "gt": bsr,
        "gq": bs, "dp_format": bs, "min_dp": bs, "live": bs,
        "info_median": P(None, "pos"), "info_median_ok": P(None, "pos"),
        "info_imedian": P(None, "pos"), "info_imedian_ok": P(None, "pos"),
        "info_fsum": P(None, "pos"), "info_fsum_ok": P(None, "pos"),
        "dp_info_sum": P("pos"),
    }
    fn = shard_map(step, mesh=mesh, in_specs=specs_in,
                   out_specs=specs_out, check_vma=False)
    return jax.jit(fn)


def _input_specs():
    cell_sc = P("row", None)       # [S, C]
    cell_sc3 = P("row", None, None)
    return (
        cell_sc3, cell_sc,                 # pl, pl_len
        cell_sc3, cell_sc,                 # ad, ad_len
        cell_sc3, cell_sc, cell_sc, cell_sc, cell_sc,  # gt,gq,dp,min_dp,dpi
        P(None, "row", None),              # info_f [F, S, C]
        P(None, "row", None),              # info_i [Fi, S, C]
        P(None, "row", None),              # info_fs [Fs, S, C]
        P("pos", "row", None),             # inv_bs [B, S, M]
        P("pos", "row"),                   # nr_bs [B, S]
        P("pos"),                          # rec_num_merged [B]
        P("pos"),                          # rec_has_nr [B]
        P("pos", "row"),                   # live [B, S]
        P("pos", "row"),                   # del_rw [B, S]
        P("pos", "row"),                   # gt_len_bs [B, S]
    )


def pad_block_for_mesh(blk: CellBlock, n_pos: int, n_row: int) -> CellBlock:
    """Pad sample count and interval count to multiples of the mesh dims.

    Padding is semantics-neutral: padded samples have live == -1
    everywhere (their gathered values are masked by the kernels), padded
    records have live == -1 for every sample (the writer emits nothing)."""
    import copy
    S = blk.col.shape[0]
    B = len(blk.starts)
    S_pad = (-S) % n_row
    B_pad = (-B) % n_pos
    out = copy.copy(blk)
    if S_pad:
        def padS(x, fill, axis=0):
            pad_width = [(0, 0)] * x.ndim
            pad_width[axis] = (0, S_pad)
            return np.pad(x, pad_width, constant_values=fill)
        out.col = padS(blk.col, np.iinfo(np.int64).max)
        out.end = padS(blk.end, 0)
        out.pl = padS(blk.pl, INT_MISSING)
        out.pl_len = padS(blk.pl_len, 0)
        out.ad = padS(blk.ad, INT_MISSING)
        out.ad_len = padS(blk.ad_len, 0)
        out.gt = padS(blk.gt, -1)
        out.gq = padS(blk.gq, INT_MISSING)
        out.dp = padS(blk.dp, INT_MISSING)
        out.min_dp = padS(blk.min_dp, INT_MISSING)
        out.dp_info = padS(blk.dp_info, INT_MISSING)
        out.info_f = padS(blk.info_f, np.nan, axis=1)
        out.info_i = padS(blk.info_i, INT_MISSING, axis=1)
        out.info_fs = padS(blk.info_fs, np.nan, axis=1)
        out.inv_bs = padS(blk.inv_bs, -1, axis=1)
        out.nr_bs = padS(blk.nr_bs, -1, axis=1)
        out.live = padS(blk.live, -1, axis=1)
        if out.del_rw is not None:
            out.del_rw = padS(blk.del_rw, False, axis=1)
        if out.gt_len_bs is not None:
            out.gt_len_bs = padS(blk.gt_len_bs, 0, axis=1)
    if B_pad:
        def padB(x, fill):
            pad_width = [(0, B_pad)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, pad_width, constant_values=fill)
        out.starts = padB(out.starts, np.iinfo(np.int64).max - 1)
        out.rec_num_merged = padB(out.rec_num_merged, 1)
        if out.rec_has_nr is not None:
            out.rec_has_nr = padB(out.rec_has_nr, True)
        out.inv_bs = padB(out.inv_bs, -1)
        out.nr_bs = padB(out.nr_bs, -1)
        out.live = padB(out.live, -1)
        if out.del_rw is not None:
            out.del_rw = padB(out.del_rw, False)
        if out.gt_len_bs is not None:
            out.gt_len_bs = padB(out.gt_len_bs, 0)
    return out


def shard_block(mesh: Mesh, blk: CellBlock):
    """Device-put block arrays with the step's input shardings."""
    args = block_to_args(blk)
    shardings = tuple(NamedSharding(mesh, s) for s in _input_specs())
    return tuple(jax.device_put(np.asarray(a), s)
                 for a, s in zip(args, shardings))
