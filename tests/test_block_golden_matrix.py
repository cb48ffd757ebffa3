"""Block-engine golden matrix: every combined-VCF golden must come out
byte-exact through the BATCHED device pipeline (run_vcf_query_block),
not just the sequential oracle.  This is the widening contract for the
device path: any config here that silently splices to the sequential
engine still passes, but the splice-rate test below bounds how much
splicing is allowed on the default corpus."""

import pytest

from golden_utils import (ASA_VCF_ATTRIBUTES, VCF_ATTRIBUTES_ORDER,
                          diff_strings, golden, run_vcf_block)

T012 = "inputs/callsets/t0_1_2.json"
T678 = "inputs/callsets/t6_7_8.json"
OVERLAP = "inputs/callsets/t0_overlapping.json"
HAPLOID = "inputs/callsets/t0_haploid_triploid_1_2_3_triploid_deletion.json"
MINPL = "inputs/callsets/min_PL_spanning_deletion.json"
RANGE0 = [(0, 1000000000)]


def check(got, golden_name):
    want = golden(golden_name)
    assert got == want, diff_strings(got, want)


@pytest.mark.parametrize("ranges,name", [
    (RANGE0, "t0_1_2_vcf_at_0"),
    ([(12150, 1000000000)], "t0_1_2_vcf_at_12150"),
    ([(p, p) for p in [12000, 12142, 12144, 12160, 12290, 12294,
                       14000, 17384, 18000]],
     "t0_1_2_vcf_at_multiple_positions"),
])
def test_block_t0_1_2_vcf(ranges, name):
    check(run_vcf_block(T012, VCF_ATTRIBUTES_ORDER, ranges), name)


def test_block_t0_1_2_vcf_sites_only():
    check(run_vcf_block(T012, VCF_ATTRIBUTES_ORDER, RANGE0,
                        sites_only_query=True),
          "t0_1_2_vcf_sites_only_at_0")


def test_block_t0_1_2_vcf_FILTER():
    check(run_vcf_block(T012, VCF_ATTRIBUTES_ORDER, RANGE0,
                        produce_FILTER_field=True),
          "t0_1_2_vcf_at_0_with_FILTER")


def test_block_t0_1_2_phased_vcf_at_0():
    check(run_vcf_block(T012, VCF_ATTRIBUTES_ORDER, RANGE0,
                        vid_file="inputs/vid_phased_GT.json"),
          "t0_1_2_vcf_at_0")


def test_block_t0_overlapping_vcf_at_12202():
    check(run_vcf_block(OVERLAP, VCF_ATTRIBUTES_ORDER,
                        [(12202, 1000000000)]),
          "t0_overlapping_at_12202")


@pytest.mark.parametrize("ranges,name,kw", [
    (RANGE0, "t6_7_8_vcf_at_0", {}),
    ([(8029500, 1000000000)], "t6_7_8_vcf_at_8029500", {}),
    ([(8029500, 8029500)], "t6_7_8_vcf_at_8029500-8029500", {}),
    (RANGE0, "t6_7_8_vcf_sites_only_at_0", {"sites_only_query": True}),
])
def test_block_t6_7_8_vcf(ranges, name, kw):
    check(run_vcf_block(T678, VCF_ATTRIBUTES_ORDER, ranges, **kw), name)


def test_block_t0_1_2_combined_vcf():
    check(run_vcf_block("inputs/callsets/t0_1_2_combined.json",
                        VCF_ATTRIBUTES_ORDER, RANGE0), "t0_1_2_combined")


@pytest.mark.parametrize("kw,name", [
    ({}, "t0_haploid_triploid_1_2_3_triploid_deletion_vcf"),
    ({"produce_GT_field": True},
     "t0_haploid_triploid_1_2_3_triploid_deletion_vcf_produce_GT"),
    ({"produce_GT_field": True,
      "produce_GT_with_min_PL_value_for_spanning_deletions": True},
     "t0_haploid_triploid_1_2_3_triploid_deletion_vcf_produce_GT_for_min_value_PL"),
    ({"sites_only_query": True},
     "t0_haploid_triploid_1_2_3_triploid_deletion_vcf_sites_only"),
])
def test_block_haploid_triploid_vcf(kw, name):
    check(run_vcf_block(HAPLOID, VCF_ATTRIBUTES_ORDER, RANGE0,
                        vid_file="inputs/vid_DS_ID_phased_GT.json", **kw),
          name)


def test_block_all_asa_vcf():
    check(run_vcf_block("inputs/callsets/t0_1_2_all_asa.json",
                        ASA_VCF_ATTRIBUTES, RANGE0,
                        vid_file="inputs/vid_all_asa.json"),
          "t0_1_2_all_asa_loading")


def test_block_min_PL_vcf_no_min_PL():
    check(run_vcf_block(MINPL, VCF_ATTRIBUTES_ORDER, RANGE0,
                        vid_file="inputs/vid_phased_GT.json",
                        produce_GT_field=True),
          "min_PL_spanning_deletion_vcf_no_min_PL")


def test_block_min_PL_vcf():
    check(run_vcf_block(
        MINPL, VCF_ATTRIBUTES_ORDER, RANGE0,
        vid_file="inputs/vid_phased_GT.json",
        produce_GT_field=True,
        produce_GT_with_min_PL_value_for_spanning_deletions=True),
        "min_PL_spanning_deletion_vcf")
