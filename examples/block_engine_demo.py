"""Batched device combine demo: 100-sample synthetic gVCF cohort ->
native import -> store->device block -> one-jit combine_step -> native
text rendering.  The scaled production path behind
`gdb_query --produce-Broad-GVCF --engine block`."""

import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from genomicsdb_tpu.core.config import QueryParams  # noqa: E402
from genomicsdb_tpu.query import driver  # noqa: E402
from genomicsdb_tpu.store.import_pipeline import (  # noqa: E402
    import_callsets)
from genomicsdb_tpu.tools import synth_cohort  # noqa: E402


def write_cohort(path, n_samples=100, n_records=500):
    random.seed(0)
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
            if i % 10 == 9:
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)}"
                    f",0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,"
                    f"{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)},{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t.\t.\t.\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(20, 200)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return samples


def main():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cohort.vcf")
        samples = write_cohort(path)
        vid = synth_cohort.load_vid(*synth_cohort.write_mappings(
            d, [(path, samples)]))
        t0 = time.time()
        store = import_callsets(vid)
        print(f"import: {store.num_cells} cells in {time.time()-t0:.2f}s")
        qp = QueryParams()
        qp.scan_full = True
        qp.attributes = []
        qc = driver.make_query_config(qp, vid)
        t0 = time.time()
        text = driver.run_vcf_query_block(store, qc, qp, vid)
        n = text.count("\n")
        print(f"block engine: {n} combined records in "
              f"{time.time()-t0:.2f}s (includes jit compile)")
        print("sample record:")
        print(" ", text.splitlines()[1][:120])


if __name__ == "__main__":
    main()
