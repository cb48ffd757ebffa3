"""Sharded (8 virtual devices) vs unsharded combine: exact equality.

The sharded step wraps the SAME `_combine_math` as combine_step; its
cross-sample reductions all_gather the sample axis and run identical
local math, so every output must be bit-identical to the single-device
path — including on real store-built blocks, not just synthetic ones.
"""

import numpy as np
import pytest

import jax

from genomicsdb_tpu.ops.combine_step import (block_to_args, combine_step,
                                             synthesize_cohort)
from genomicsdb_tpu.parallel.sharded import (make_mesh, pad_block_for_mesh,
                                             shard_block,
                                             sharded_combine_step)

ALL_KEYS = ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "live",
            "info_median", "info_median_ok", "info_imedian",
            "info_imedian_ok", "info_fsum", "info_fsum_ok",
            "dp_info_sum")


def _assert_outputs_equal(ref, out, b_lim, s_lim):
    """Compare sharded outputs (padded shapes) against unsharded ref."""
    for key in ALL_KEYS:
        a = np.asarray(ref[key])
        b = np.asarray(out[key])
        # trim mesh padding back to the unpadded block shape
        if key in ("info_median", "info_median_ok", "info_imedian",
                   "info_imedian_ok", "info_fsum", "info_fsum_ok"):
            b = b[:, :b_lim]
        elif b.ndim >= 1 and b.shape[0] >= b_lim:
            b = b[:b_lim]
        if key in ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "live"):
            b = b[:, :s_lim]
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(
                np.where(np.isnan(a), 0, a), np.where(np.isnan(b), 0, b),
                err_msg=key)
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("n_pos,n_row", [(4, 2), (8, 1), (2, 4)])
def test_sharded_equals_unsharded_synthetic(n_pos, n_row):
    if len(jax.devices()) < n_pos * n_row:
        pytest.skip("needs 8 virtual devices")
    blk = synthesize_cohort(num_samples=8, cells_per_sample=48,
                            region_len=4096, seed=11)
    ref = combine_step(*block_to_args(blk), max_merged=4, ploidy=2)
    mesh = make_mesh(n_pos, n_row)
    pblk = pad_block_for_mesh(blk, n_pos, n_row)
    args = shard_block(mesh, pblk)
    step = sharded_combine_step(mesh, max_merged=4, ploidy=2)
    out = step(*args)
    _assert_outputs_equal(ref, out, len(blk.starts), blk.col.shape[0])


def test_mesh_block_query_golden():
    """Golden-exact combined VCF from an 8-device mesh run, end to end
    through the block writer (gdb_query --mesh equivalent)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from golden_utils import (REF_TESTS, VCF_ATTRIBUTES_ORDER, golden,
                              load_setup, make_query_params)
    from genomicsdb_tpu.query import driver
    vid, store = load_setup("inputs/callsets/t0_1_2.json")
    qp = make_query_params(VCF_ATTRIBUTES_ORDER, [(0, 1000000000)])
    qc = driver.make_query_config(qp, vid)
    got = driver.run_vcf_query_block(
        store, qc, qp, vid,
        template_path=os.path.join(REF_TESTS,
                                   "inputs/template_vcf_header.vcf"),
        reference_path=os.path.join(REF_TESTS,
                                    "inputs/chr1_10MB.fasta.gz"),
        mesh=make_mesh(4, 2))
    assert got == golden("t0_1_2_vcf_at_0")


def test_mesh_block_query_golden_general_ploidy():
    """Mixed-ploidy (haploid/triploid) cohort through an 8-device mesh:
    the per-call ploidy select is shard-local, so the mesh path must be
    golden-exact too."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from golden_utils import (REF_TESTS, VCF_ATTRIBUTES_ORDER, golden,
                              load_setup, make_query_params)
    from genomicsdb_tpu.query import driver
    vid, store = load_setup(
        "inputs/callsets/t0_haploid_triploid_1_2_3_triploid_deletion.json",
        "inputs/vid_DS_ID_phased_GT.json")
    qp = make_query_params(VCF_ATTRIBUTES_ORDER, [(0, 1000000000)])
    qc = driver.make_query_config(qp, vid)
    got = driver.run_vcf_query_block(
        store, qc, qp, vid,
        template_path=os.path.join(REF_TESTS,
                                   "inputs/template_vcf_header.vcf"),
        reference_path=os.path.join(REF_TESTS,
                                    "inputs/chr1_10MB.fasta.gz"),
        mesh=make_mesh(4, 2))
    assert got == golden("t0_haploid_triploid_1_2_3_triploid_deletion_vcf")


def test_sharded_equals_unsharded_store_block():
    """Same equality on a real store-built block (golden t0_1_2 data)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from golden_utils import (VCF_ATTRIBUTES_ORDER, load_setup,
                              make_query_params)
    from genomicsdb_tpu.ops.store_block import store_to_block
    from genomicsdb_tpu.query import driver
    vid, store = load_setup("inputs/callsets/t0_1_2.json")
    qp = make_query_params(VCF_ATTRIBUTES_ORDER, [(0, 1000000000)])
    qc = driver.make_query_config(qp, vid)
    blk = store_to_block(store, qc, interval=(0, 1000000000),
                         max_merged=4, ploidy=2)
    ref = combine_step(*block_to_args(blk), max_merged=4, ploidy=2)
    mesh = make_mesh(4, 2)
    pblk = pad_block_for_mesh(blk, 4, 2)
    args = shard_block(mesh, pblk)
    step = sharded_combine_step(mesh, max_merged=4, ploidy=2)
    out = step(*args)
    _assert_outputs_equal(ref, out, len(blk.starts), blk.col.shape[0])
