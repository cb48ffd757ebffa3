"""Genome-scale text-edge benchmark: millions of positions through the
record-aligned chunked block engine.

Generates an 8-sample gVCF spanning ~6M positions (~200k records), runs
the block engine twice (cold incl. XLA compile, then warm) and prints
one JSON line.

Usage: python -m genomicsdb_tpu.tools.genome_bench [--records N]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time


def make_cohort(path: str, n_samples: int, n_records: int) -> int:
    random.seed(7)
    samples = [f"S{i}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        for line in [
            '##ALT=<ID=NON_REF,Description="n">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
            '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="a">',
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
            '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="m">',
            '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
            '##contig=<ID=1,length=249250621>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 9 == 8:
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)}"
                    f",0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,{random.randint(0, 500)}"
                    f",{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t.\t.\t.\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(10, 50)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=200_000)
    args = ap.parse_args(argv)
    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.query import driver
    from genomicsdb_tpu.store.import_pipeline import import_callsets
    from genomicsdb_tpu.tools import synth_cohort

    path = os.path.join(tempfile.mkdtemp(), "genome_cohort.vcf")
    region = make_cohort(path, args.samples, args.records)
    vid = synth_cohort.load_vid(*synth_cohort.write_mappings(
        os.path.dirname(path),
        [(path, [f"S{i}" for i in range(args.samples)])]))
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t_import = time.perf_counter() - t0
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    # engine lanes: the serving index (query/serving_index.py) would
    # materialize on the warm repeat and serve a slice of itself — it
    # gets its own lane below
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
    qc = driver.make_query_config(qp, vid)
    t0 = time.perf_counter()
    text = driver.run_vcf_query_block(store, qc, qp, vid)
    t_cold = time.perf_counter() - t0
    qc2 = driver.make_query_config(qp, vid)
    t0 = time.perf_counter()
    text2 = driver.run_vcf_query_block(store, qc2, qp, vid)
    t_warm = time.perf_counter() - t0
    assert text2 == text
    # small-interval latency (the Spark/GATK many-small-queries pattern)
    import random as _r
    _r.seed(2)

    def interval_lane():
        lat = []
        for _ in range(20):
            lo = _r.randint(1, max(region - 20000, 2))
            qp_i = QueryParams()
            qp_i.column_ranges = [[(lo, lo + 10000)]]
            qp_i.attributes = []
            qc_i = driver.make_query_config(qp_i, vid)
            t0 = time.perf_counter()
            driver.run_vcf_query_block(store, qc_i, qp_i, vid)
            lat.append(time.perf_counter() - t0)
        lat.sort()
        return lat

    lat = interval_lane()
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "1"
    lat_srv = interval_lane()      # production: materialized serving
    del os.environ["GENOMICSDB_TPU_SERVING_INDEX"]
    print(json.dumps({
        "samples": args.samples, "records": args.records,
        "cells": int(store.num_cells), "positions": region,
        "import_s": round(t_import, 2),
        "query_cold_s": round(t_cold, 2),
        "query_warm_s": round(t_warm, 2),
        "warm_positions_per_sec": round(region / t_warm, 1),
        "interval_10kb_p50_ms": round(lat_srv[10] * 1000, 1),
        "interval_10kb_p90_ms": round(lat_srv[18] * 1000, 1),
        "interval_10kb_engine_p50_ms": round(lat[10] * 1000, 1),
        "interval_10kb_engine_p90_ms": round(lat[18] * 1000, 1),
        "lines": text.count("\n")}))
    os.unlink(path)


if __name__ == "__main__":
    sys.exit(main())
