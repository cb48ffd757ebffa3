"""v2 fragment format + out-of-core query equivalence.

Covers the reference's segment_size-granular, larger-than-RAM serving
model (variant_storage_manager.cc:478-513, gt_mpi_gather.cc:467):
roundtrip, streaming chunked writes with cross-chunk eff_end patching,
streaming consolidation, and byte-identical out-of-core window queries.
"""

import os

import numpy as np
import pytest

from golden_utils import REF_TESTS
from test_block_writer import _make_cohort

from genomicsdb_tpu.core.config import QueryParams
from genomicsdb_tpu.core.vid import VidMapper
from genomicsdb_tpu.query import driver
from genomicsdb_tpu.store import workspace as ws
from genomicsdb_tpu.store.columnar import store_take
from genomicsdb_tpu.store.fragment_v2 import (FragmentV2Writer,
                                              consolidate_v2_streaming,
                                              open_fragment_v2,
                                              slice_store,
                                              write_fragment_v2)
from genomicsdb_tpu.store.import_pipeline import import_callsets


def _bits_equal(a, b):
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _stores_equal(a, b):
    assert np.array_equal(a.row, b.row)
    assert np.array_equal(a.col, b.col)
    assert np.array_equal(a.end, b.end)
    assert np.array_equal(a.eff_end, b.eff_end)
    assert a.attribute_order == b.attribute_order
    for name, fd in a.fields.items():
        fd2 = b.fields[name]
        assert fd2.kind == fd.kind and fd2.dtype == fd.dtype, name
        assert np.array_equal(fd.valid, fd2.valid), name
        assert _bits_equal(fd.values, fd2.values), name
        if fd.offsets is not None:
            assert np.array_equal(fd.offsets, fd2.offsets), name
        if fd.outer_offsets is not None:
            assert np.array_equal(fd.outer_offsets,
                                  fd2.outer_offsets), name


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    td = tmp_path_factory.mktemp("v2cohort")
    path, samples, region = _make_cohort(td, n_samples=8, n_records=300,
                                         with_deletions=True)
    vid = VidMapper.from_files(os.path.join(REF_TESTS,
                                            "inputs/vid.json"))
    vid.parse_callsets({"callsets": {
        s: {"row_idx": i, "idx_in_file": i, "filename": path}
        for i, s in enumerate(samples)}})
    store = import_callsets(vid)
    return store, vid, region


def test_v2_roundtrip(cohort, tmp_path):
    store, vid, _ = cohort
    wsdir = str(tmp_path / "ws")
    ws.create_workspace(wsdir)
    frag = ws.write_fragment(wsdir, "A", store)
    assert frag.endswith(".gdbv2")
    st2 = ws.open_array(wsdir, "A")
    _stores_equal(store, st2)


def test_v2_chunked_append_matches_single_shot(cohort, tmp_path):
    """Cross-chunk eff_end finalization: appending in pieces must
    produce the same effective ENDs as a single write (the truncate-at-
    next-same-row-begin rule spans chunk boundaries)."""
    store, _, _ = cohort
    fm = {n: {"kind": f.kind, "dtype": f.dtype}
          for n, f in store.fields.items()}
    d = str(tmp_path / "chunked.gdbv2")
    w = FragmentV2Writer(d, store.attribute_order, fm, store.num_rows,
                         store.lb_row)
    n = store.num_cells
    # chunk boundaries snapped to column boundaries (cells col-sorted)
    cuts = sorted({0, n} | {
        int(np.searchsorted(store.col, store.col[min(c, n - 1)], "left"))
        for c in (n // 5, n // 3, n // 2, 2 * n // 3)})
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        if hi > lo:
            w.append(slice_store(store, lo, hi))
    w.close()
    st = open_fragment_v2(d)
    _stores_equal(store, st)


def test_v2_streaming_consolidation(cohort, tmp_path):
    store, _, _ = cohort
    idx_a = np.nonzero(store.col % 3 != 0)[0]
    idx_b = np.nonzero(store.col % 3 == 0)[0]
    sa, sb = store_take(store, idx_a), store_take(store, idx_b)
    da, db = str(tmp_path / "a.gdbv2"), str(tmp_path / "b.gdbv2")
    write_fragment_v2(da, sa)
    write_fragment_v2(db, sb)
    dc = str(tmp_path / "c.gdbv2")
    consolidate_v2_streaming([da, db], dc, segment_size=1 << 12)
    stc = open_fragment_v2(dc)
    ref = ws.merge_stores([sa, sb])
    _stores_equal(ref, stc)


def test_workspace_consolidation_v2(cohort, tmp_path):
    """consolidate_array on multiple v2 fragments runs the streaming
    k-way merge and open_array equals the in-RAM merge."""
    store, _, _ = cohort
    idx_a = np.nonzero(store.col % 2 == 0)[0]
    idx_b = np.nonzero(store.col % 2 == 1)[0]
    sa, sb = store_take(store, idx_a), store_take(store, idx_b)
    wsdir = str(tmp_path / "ws")
    ws.create_workspace(wsdir)
    ws.write_fragment(wsdir, "A", sa)
    ws.write_fragment(wsdir, "A", sb)
    ref = ws.open_array(wsdir, "A")   # in-RAM merge of 2 fragments
    ws.consolidate_array(wsdir, "A")
    frags = ws._fragment_paths(wsdir, "A")
    assert len(frags) == 1
    st = ws.open_array(wsdir, "A")
    _stores_equal(ref, st)


def test_ooc_query_byte_identical(cohort, tmp_path):
    """Out-of-core windowed block-engine queries (scan-full and
    intervals) are byte-identical to the in-RAM query, across window
    sizes."""
    store, vid, region = cohort
    wsdir = str(tmp_path / "ws")
    ws.create_workspace(wsdir)
    ws.write_fragment(wsdir, "A", store)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    full = driver.run_vcf_query_block(store, qc, qp, vid)
    ooc = ws.open_array_ooc(wsdir, "A", segment_size=1 << 14)
    n_windows = sum(1 for _ in ooc.windows((0, region + 10)))
    assert n_windows > 1, "window budget did not split the partition"
    qc2 = driver.make_query_config(qp, vid)
    assert driver.run_vcf_query_block(ooc, qc2, qp, vid) == full
    for rng in [(5000, 20000), (0, 100), (12345, 12999),
                (0, region + 10)]:
        qp2 = QueryParams()
        qp2.attributes = []
        qp2.column_ranges = [[rng]]
        qc3 = driver.make_query_config(qp2, vid)
        a = driver.run_vcf_query_block(store, qc3, qp2, vid)
        qc4 = driver.make_query_config(qp2, vid)
        b = driver.run_vcf_query_block(ooc, qc4, qp2, vid)
        assert a == b, rng


def test_ooc_bounded_rss_subprocess(tmp_path):
    """Serving a partition must not page the partition into RSS.  The
    engine's working set is a CONSTANT (~250 MB of XLA block buffers +
    the python/jax baseline, measured identical for 0.3 and 1 GB
    partitions — see bench.py out_of_core); an 800 MB partition must serve
    with peak RSS well below its own size."""
    import json
    import subprocess
    import sys
    r = subprocess.run(
        [sys.executable, "-m", "genomicsdb_tpu.tools.ooc_bench",
         "--target-bytes", "8e8", "--workspace",
         str(tmp_path / "ws")],
        capture_output=True, text=True, timeout=900,
        cwd="/root/repo")
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["windows"] > 10
    assert out["peak_rss_bytes"] < 0.65 * out["partition_bytes"], out
    # and the query-phase growth is the partition-size-independent
    # engine working set, not the partition
    growth = out["peak_rss_bytes"] - out["peak_rss_after_build"]
    assert growth < 450e6, out
