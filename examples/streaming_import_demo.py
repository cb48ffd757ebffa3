"""Buffer-stream import demo (reference
example/src/test_genomicsdb_importer.cc): feed VCF bytes through
StreamingImporter in small chunks with import_batch back-pressure,
then query the finalized store."""

import gzip
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from genomicsdb_tpu.core.config import QueryParams  # noqa: E402
from genomicsdb_tpu.core.vid import VidMapper  # noqa: E402
from genomicsdb_tpu.query import driver  # noqa: E402
from genomicsdb_tpu.store.streaming_import import (  # noqa: E402
    StreamingImporter)

REF_TESTS = "/root/reference/tests"


def main():
    vid = VidMapper.from_files(
        os.path.join(REF_TESTS, "inputs/vid.json"),
        os.path.join(REF_TESTS, "inputs/callsets/t0_1_2.json"))
    imp = StreamingImporter(vid)
    # one named stream per input file (jniAddBufferStream)
    for cs in vid.callsets.values():
        if cs.filename not in imp.streams:
            imp.add_buffer_stream(cs.filename)
    # push each file's bytes in 4 KiB chunks (jniWriteDataToBufferStream
    # + jniImportBatch loop)
    for name in list(imp.streams):
        with gzip.open(os.path.join(REF_TESTS, name), "rb") as f:
            data = f.read()
        for i in range(0, len(data), 4096):
            imp.write(name, data[i:i + 4096])
            imp.import_batch()
    store = imp.finalize()
    print(f"imported {store.num_cells} cells, "
          f"{len(store.fields)} fields")
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    text = driver.run_vcf_query(store, qc, qp, vid)
    print("first combined records:")
    for line in text.splitlines()[:5]:
        print(" ", line[:100])


if __name__ == "__main__":
    main()
