"""Paged query-stream demo (reference
example/src/test_genomicsdb_bcf_generator.cc + Java
GenomicsDBFeatureReader): lazy byte pages from CombinedRecordStream and
interval queries through FeatureReader."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from genomicsdb_tpu.core.config import QueryParams  # noqa: E402
from genomicsdb_tpu.core.vid import VidMapper  # noqa: E402
from genomicsdb_tpu.query import driver  # noqa: E402
from genomicsdb_tpu.query.stream import (  # noqa: E402
    CombinedRecordStream, FeatureReader)
from genomicsdb_tpu.store.import_pipeline import (  # noqa: E402
    import_callsets)

REF_TESTS = "/root/reference/tests"


def main():
    vid = VidMapper.from_files(
        os.path.join(REF_TESTS, "inputs/vid.json"),
        os.path.join(REF_TESTS, "inputs/callsets/t0_1_2.json"))
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    # read_and_advance-style byte pages (GenomicsDBQueryStream analog)
    stream = CombinedRecordStream(store, qc, qp, vid, None, None)
    total = 0
    n_pages = 0
    for page in stream.pages(page_size=512):
        total += len(page)
        n_pages += 1
    print(f"streamed {total} bytes in {n_pages} pages of <=512b")
    # htsjdk FeatureReader.query(contig, begin, end) analog
    qc2 = driver.make_query_config(qp, vid)
    reader = FeatureReader(store, qc2, vid)
    records = list(reader.query("1", 12000, 13000))
    print(f"interval 1:12000-13000 -> {len(records)} records")
    for r in records[:3]:
        print(" ", str(r)[:100])


if __name__ == "__main__":
    main()
