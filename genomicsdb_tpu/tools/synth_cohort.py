"""Seeded synthetic gVCF cohorts with self-contained mappings.

Everything a run needs is generated here from a seed: the VCF files,
the vid mapping that declares every field they carry, and the callset
mapping.  Nothing is read from a reference checkout.

Two cohort shapes:

  * `write_wide_cohort` — joint calling after GenomicsDBImport: one
    multi-sample gVCF in which every sample shares the record grid,
    GQ-banded reference blocks, and one variant site in seven.
  * `write_hard_cohort` — every branch of the device step: batches of
    samples in separate files (so allele sets merge and grow past four),
    a haploid batch (chrX in males), sites with up to six alleles,
    spanning deletions, and one hotspot site whose merged allele count
    passes the reference's 50-ALT genotyping cap (that record splices
    to the sequential engine).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# vid field table covering every field the generators write (the
# reference's vid.json layout; combine operations default by name,
# core/known_fields.py)
COHORT_FIELDS: Dict[str, dict] = {
    "PASS": {"vcf_field_class": ["FILTER"], "type": "int"},
    "GT": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "P"},
    "AD": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "R"},
    "DP": {"vcf_field_class": ["FORMAT", "INFO"], "type": "int"},
    "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
    "MIN_DP": {"vcf_field_class": ["FORMAT"], "type": "int"},
    "PL": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "G"},
    "END": {"vcf_field_class": ["INFO"], "type": "int"},
    "MQ0": {"vcf_field_class": ["INFO"], "type": "int"},
    "BaseQRankSum": {"vcf_field_class": ["INFO"], "type": "float"},
    "MQRankSum": {"vcf_field_class": ["INFO"], "type": "float"},
    "RAW_MQ": {"vcf_field_class": ["INFO"], "type": "float"},
}

CONTIG = "1"
CONTIG_LENGTH = 249250621

_HEADER = [
    "##fileformat=VCFv4.1",
    '##ALT=<ID=NON_REF,Description="Represents any possible alternative '
    'allele at this location">',
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allelic depths">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype '
    'quality">',
    '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP '
    'observed within the block">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled '
    'genotype likelihoods">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Combined depth">',
    '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="MAPQ == 0 reads">',
    '##INFO=<ID=BaseQRankSum,Number=1,Type=Float,Description="Base '
    'quality rank sum">',
    '##INFO=<ID=MQRankSum,Number=1,Type=Float,Description="Mapping '
    'quality rank sum">',
    '##INFO=<ID=RAW_MQ,Number=1,Type=Float,Description="Raw mapping '
    'quality">',
    f"##contig=<ID={CONTIG},length={CONTIG_LENGTH}>",
]

# reference-block GQ bands (GATK's default -GQB boundaries)
GQ_BANDS = np.array([0, 1, 10, 20, 30, 40, 50, 60, 99])


def header_lines(samples: Sequence[str]) -> List[str]:
    return _HEADER + ["#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                      "FORMAT\t" + "\t".join(samples)]


# allele-specific 2-D INFO annotations (GATK -G AS_StandardAnnotation):
# per-allele lists split by "|", elements by ","
AS_FIELDS: Dict[str, dict] = {
    "AS_RAW_MQ": {"vcf_field_class": ["INFO"], "type": "float",
                  "vcf_type": "string",
                  "length": ["R", "VAR"], "vcf_delimiter": ["|", ","],
                  "VCF_field_combine_operation": "element_wise_sum"},
    "AS_RAW_MQRankSum": {"vcf_field_class": ["INFO"],
                         "type": ["float", "int"],
                         "vcf_type": "string",
                         "length": ["R", "VAR"],
                         "vcf_delimiter": ["|", ","],
                         "VCF_field_combine_operation": "histogram_sum"},
}


def write_mappings(out_dir: str, files: Sequence[Tuple[str, Sequence[str]]],
                   contig_length: int = CONTIG_LENGTH,
                   allele_specific: bool = False) -> Tuple[str, str]:
    """Write vid.json + callsets.json for `files` = [(vcf path, sample
    names in file order)], rows assigned in that order.  Returns
    (vid path, callsets path)."""
    os.makedirs(out_dir, exist_ok=True)
    vid_path = os.path.join(out_dir, "vid.json")
    cs_path = os.path.join(out_dir, "callsets.json")
    fields = dict(COHORT_FIELDS, **(AS_FIELDS if allele_specific else {}))
    with open(vid_path, "w") as f:
        json.dump({"fields": fields,
                   "contigs": {CONTIG: {"length": contig_length,
                                        "tiledb_column_offset": 0}}}, f)
    callsets = {}
    row = 0
    for path, samples in files:
        for idx, name in enumerate(samples):
            callsets[name] = {"row_idx": row, "idx_in_file": idx,
                              "filename": os.path.abspath(path)}
            row += 1
    with open(cs_path, "w") as f:
        json.dump({"callsets": callsets}, f)
    return vid_path, cs_path


def load_vid(vid_path: str, callsets_path: str):
    from ..core.vid import VidMapper
    return VidMapper.from_files(vid_path, callsets_path)


def _ref_block_table(diploid: bool) -> np.ndarray:
    """Cell strings of a reference block, indexed by dp_idx * nb + band:
    DP 1..60, GQ from GQ_BANDS."""
    gt = "0/0" if diploid else "0"
    cells = []
    for dp in range(1, 61):
        for gq in GQ_BANDS:
            pl = f"0,{gq},{3 * gq}" if diploid else f"0,{gq}"
            cells.append(f"{gt}:.:{dp}:{gq}:{max(dp - 3, 0)}:{pl}")
    return np.array(cells, dtype=object)


def _ref_block_codes(rng, n: int, shape) -> np.ndarray:
    nb = len(GQ_BANDS)
    return rng.integers(0, 60, size=shape) * nb \
        + rng.integers(0, nb, size=shape)


def write_wide_cohort(path: str, n_samples: int, n_records: int,
                      seed: int = 0) -> Tuple[List[str], int]:
    """One multi-sample gVCF on a shared record grid: GQ-banded
    reference blocks of 50-400 bp, every seventh record a biallelic SNV
    site.  Returns (sample names, one past the last covered position)."""
    rng = np.random.default_rng(seed)
    samples = [f"W{i}" for i in range(n_samples)]
    table = _ref_block_table(diploid=True)
    is_var = (np.arange(n_records) % 7) == 6
    n_var = int(is_var.sum())
    lens = np.where(is_var, 1, rng.integers(50, 401, size=n_records))
    starts = np.concatenate([[1], 1 + np.cumsum(lens)[:-1]])
    ref_codes = _ref_block_codes(rng, n_records - n_var,
                                 (n_records - n_var, n_samples))
    # variant-cell fields, one [n_var, S] draw each
    g = rng.integers(0, 2, size=(n_var, n_samples))
    ad = rng.integers(1, 41, size=(n_var, n_samples, 2))
    dp = rng.integers(10, 100, size=(n_var, n_samples))
    gq = rng.integers(10, 100, size=(n_var, n_samples))
    pl = rng.integers(0, 501, size=(n_var, n_samples, 5))
    alts = rng.choice(np.array(["A", "T", "G"]), size=n_var)
    mq0 = rng.integers(0, 10, size=n_var)
    vi = ri = 0
    with open(path, "w") as f:
        f.write("\n".join(header_lines(samples)) + "\n")
        for i in range(n_records):
            pos = int(starts[i])
            if is_var[i]:
                cells = "\t".join(
                    f"0/{a}:{b},{c},0:{d}:{q}:.:{p0},0,{p1},{p2},{p3},{p4}"
                    for a, (b, c), d, q, (p0, p1, p2, p3, p4) in zip(
                        g[vi].tolist(), ad[vi].tolist(), dp[vi].tolist(),
                        gq[vi].tolist(), pl[vi].tolist()))
                f.write(f"{CONTIG}\t{pos}\t.\tC\t{alts[vi]},<NON_REF>\t.\t"
                        f".\tMQ0={mq0[vi]}\tGT:AD:DP:GQ:MIN_DP:PL\t"
                        f"{cells}\n")
                vi += 1
            else:
                end = pos + int(lens[i]) - 1
                cells = "\t".join(table[ref_codes[ri]].tolist())
                f.write(f"{CONTIG}\t{pos}\t.\tC\t<NON_REF>\t.\t.\t"
                        f"END={end}\tGT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                ri += 1
    return samples, int(starts[-1] + lens[-1])


_BASES = np.array(list("ACGT"))


def _hard_sites(rng, span: int) -> np.ndarray:
    """Shared variant-site positions, 8+ bp apart (room for a
    4-base deletion and the records it spans)."""
    gaps = rng.integers(8, 90, size=span // 8)
    sites = 20 + np.cumsum(gaps)
    return sites[sites < span - 20]


def write_hard_cohort(out_dir: str, n_samples: int, n_records: int,
                      seed: int = 0, batch: int = 16,
                      haploid_batches: int = 2
                      ) -> Tuple[List[Tuple[str, List[str]]], int]:
    """`n_samples` split into files of `batch` samples; the last
    `haploid_batches` files are haploid.  The span is sized so the
    merged cohort has about `n_records` records.  Returns
    ([(vcf path, samples)], one past the last covered position)."""
    rng = np.random.default_rng(seed)
    n_files = max(1, math.ceil(n_samples / batch))
    # each file adds ~span/62 distinct record starts to the merged grid
    span = max(400, int(n_records * 62 / max(n_files, 1)) + 200)
    refseq = _BASES[rng.integers(0, 4, size=span + 16)]
    sites = _hard_sites(rng, span)
    hotspot = int(sites[len(sites) // 2]) if len(sites) else -1
    # 4-base insertion suffixes, distinct across files at the hotspot
    suffixes = ["".join(t) for t in
                np.array(np.meshgrid(*[_BASES] * 4)).T.reshape(-1, 4)]
    suffixes = [suffixes[i] for i in rng.permutation(len(suffixes))]
    files = []
    os.makedirs(out_dir, exist_ok=True)
    for fi in range(n_files):
        samples = [f"H{fi}_{j}" for j in
                   range(min(batch, n_samples - fi * batch))]
        diploid = fi < n_files - haploid_batches or n_files == 1
        path = os.path.join(out_dir, f"batch{fi}.vcf")
        _write_hard_file(path, samples, diploid, rng, refseq, sites,
                         hotspot, suffixes[fi * 4:fi * 4 + 4], span)
        files.append((path, samples))
    return files, span


def _pl_len(n_alleles: int, diploid: bool) -> int:
    return n_alleles * (n_alleles + 1) // 2 if diploid else n_alleles


def _write_hard_file(path, samples, diploid, rng, refseq, sites, hotspot,
                     hot_suffixes, span):
    S = len(samples)
    table = _ref_block_table(diploid)
    gt_sep = "/"

    def ref_blocks(f, lo, hi):
        """Reference blocks tiling [lo, hi] in 5-120 bp pieces."""
        pos = lo
        while pos <= hi:
            end = min(hi, pos + int(rng.integers(5, 121)) - 1)
            codes = _ref_block_codes(rng, 1, S)
            f.write(f"{CONTIG}\t{pos}\t.\t{refseq[pos - 1]}\t<NON_REF>\t.\t"
                    f".\tEND={end}\tGT:AD:DP:GQ:MIN_DP:PL\t"
                    + "\t".join(table[codes].tolist()) + "\n")
            pos = end + 1

    def info():
        parts = [f"DP={int(rng.integers(10, 4000))}",
                 f"MQ0={int(rng.integers(0, 10))}"]
        if rng.random() < 0.8:
            parts.append(f"BaseQRankSum={rng.normal():.3f}")
        if rng.random() < 0.6:
            parts.append(f"MQRankSum={rng.normal():.3f}")
        parts.append(f"RAW_MQ={rng.random() * 1e5:.2f}")
        return ";".join(parts)

    def cells(n_alleles):
        k = n_alleles - 2                      # real ALTs (no NON_REF)
        out = []
        for _ in range(S):
            if diploid:
                a, b = sorted(rng.integers(0, k + 1, size=2).tolist())
                gt = f"{a}{gt_sep}{b}"
            else:
                gt = str(int(rng.integers(0, k + 1)))
            ad = ",".join(map(str, rng.integers(0, 50,
                                                size=n_alleles).tolist()))
            pl = ",".join(map(str, rng.integers(
                0, 900, size=_pl_len(n_alleles, diploid)).tolist()))
            out.append(f"{gt}:{ad}:{int(rng.integers(1, 90))}:"
                       f"{int(rng.integers(0, 99))}:.:{pl}")
        return "\t".join(out)

    with open(path, "w") as f:
        f.write("\n".join(header_lines(samples)) + "\n")
        pos = 1
        for v in sites.tolist():
            if v < pos:
                continue
            if v != hotspot and rng.random() < 0.3:
                continue                   # no call here: blocks cover it
            ref_blocks(f, pos, v - 1)
            base = refseq[v - 1]
            if v == hotspot:
                ref = base
                alts = [base + s for s in hot_suffixes]
            elif rng.random() < 0.2:
                # spanning deletion of 1-4 bases
                d = int(rng.integers(1, 5))
                ref = "".join(refseq[v - 1:v + d])
                alts = [base]
                if rng.random() < 0.5:
                    alts.append(_other_base(rng, base) + ref[1:])
            else:
                ref = base
                pool = [b for b in "ACGT" if b != base] + \
                    [base + "A", base + "TT", base + "GCA"]
                k = int(rng.integers(1, 5))
                alts = [pool[i] for i in sorted(
                    rng.choice(len(pool), size=k, replace=False).tolist())]
            n_alleles = len(alts) + 2
            f.write(f"{CONTIG}\t{v}\t.\t{ref}\t{','.join(alts)},<NON_REF>"
                    f"\t.\t.\t{info()}\tGT:AD:DP:GQ:MIN_DP:PL\t"
                    f"{cells(n_alleles)}\n")
            pos = v + len(ref)
        ref_blocks(f, pos, span - 1)


def _other_base(rng, base: str) -> str:
    return str(rng.choice([b for b in "ACGT" if b != base]))
