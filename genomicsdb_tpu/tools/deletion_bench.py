"""Deletion-heavy worst case: block engine vs sequential engine.

Generates a cohort where ~9% of records are spanning deletions (the
reference's handle_deletions path, broad_combined_gvcf.cc:912-1078),
runs both engines on the full range, asserts byte-identical output and
prints one JSON line with the speedup.

Usage: python -m genomicsdb_tpu.tools.deletion_bench [--samples N]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time


def make_cohort(path: str, n_samples: int, n_records: int,
                del_every: int = 11) -> int:
    random.seed(3)
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
            if i % del_every == del_every - 1:
                # multi-base REF -> spanning-deletion rewrite at every
                # position the record covers past its start
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)}"
                    f",0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,{random.randint(0, 500)}"
                    f",{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tCATAT\tC,<NON_REF>\t.\t.\t.\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 5
            else:
                end = pos + random.randint(10, 60)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--records", type=int, default=1000)
    args = ap.parse_args(argv)
    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.query import driver
    from genomicsdb_tpu.store.import_pipeline import import_callsets
    from genomicsdb_tpu.tools import synth_cohort

    path = os.path.join(tempfile.mkdtemp(), "del_cohort.vcf")
    region = make_cohort(path, args.samples, args.records)
    vid = synth_cohort.load_vid(*synth_cohort.write_mappings(
        os.path.dirname(path),
        [(path, [f"S{i}" for i in range(args.samples)])]))
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    t0 = time.perf_counter()
    seq = driver.run_vcf_query(store, qc, qp, vid)
    t_seq = time.perf_counter() - t0
    qc2 = driver.make_query_config(qp, vid)
    t_blk = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        blk = driver.run_vcf_query_block(store, qc2, qp, vid)
        t_blk = min(t_blk, time.perf_counter() - t0)
    assert blk.splitlines() == seq.splitlines(), "engine mismatch"
    n_lines = blk.count("\n")
    print(json.dumps({
        "samples": args.samples, "records_in": args.records,
        "records_out": n_lines, "positions": region,
        "sequential_s": round(t_seq, 3), "block_s": round(t_blk, 3),
        "block_positions_per_sec": round(region / t_blk, 1),
        "speedup": round(t_seq / t_blk, 2)}))
    os.unlink(path)


if __name__ == "__main__":
    sys.exit(main())
