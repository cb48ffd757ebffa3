"""Query driver: ties configs + store + operators together.

Python equivalent of tools/src/gt_mpi_gather.cc main(): loads loader/query
JSON, imports or opens the array, and runs one of the query types
(calls / variants / Broad-combined-VCF).
"""

from __future__ import annotations

import os
from typing import List, Optional


from ..core.config import ImportParams, QueryParams, QueryConfig, INT64_MAX
from ..core.vid import VidMapper
from ..store.columnar import ColumnarStore
from ..store.import_pipeline import import_callsets
from ..vcf.fasta import ReferenceGenome
from ..vcf.header import build_header_lines, chrom_line, load_template
from . import json_output
from .scan import Variant, scan_and_operate
from .vcf_writer import CombineToVCF


def load_vid_for_query(qp: QueryParams,
                       ip: Optional[ImportParams]) -> VidMapper:
    vid_file = qp.vid_mapping_file or (ip.vid_mapping_file if ip else "")
    callset_file = qp.callset_mapping_file or (
        ip.callset_mapping_file if ip else "")
    base = qp if qp.vid_mapping_file else ip
    vid_path = (qp.resolve(vid_file) if qp.vid_mapping_file
                else ip.resolve(vid_file))
    cs_path = (qp.resolve(callset_file) if qp.callset_mapping_file
               else (ip.resolve(callset_file) if ip else callset_file))
    _ = base
    return VidMapper.from_files(vid_path, cs_path)


def build_store_from_loader(ip: ImportParams, vid: VidMapper,
                            rank: int = 0) -> ColumnarStore:
    begin, end = ip.partition_bounds(rank) if ip.column_partitions \
        else (0, None)
    return import_callsets(
        vid, base_dir=ip.base_dir,
        column_partition=(begin, end if ip.column_partitions else None),
        treat_deletions_as_intervals=ip.treat_deletions_as_intervals)


def make_query_config(qp: QueryParams, vid: VidMapper) -> QueryConfig:
    schema_attrs = vid.schema_attribute_names(import_id="ID" in vid.fields)
    return QueryConfig(vid, qp, schema_attrs)


def run_calls_query(store: ColumnarStore, qc: QueryConfig) -> str:
    return json_output.print_calls_json(store, qc)


def run_vcf_query(store: ColumnarStore, qc: QueryConfig, qp: QueryParams,
                  vid: VidMapper,
                  template_path: Optional[str] = None,
                  reference_path: Optional[str] = None) -> str:
    """--produce-Broad-GVCF: header + combined records."""
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    # any vid field can appear as a FILTER id (PASS/LowQual have no
    # vcf_field_class in the test vids); map every global field idx
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    op = CombineToVCF(qc, vid, ref_genome, sample_names,
                      filter_name_by_field_idx=filter_names)
    out_lines: List[str] = []
    if template_path:
        template = load_template(template_path)
        out_lines.extend(build_header_lines(template, vid, qc))
        out_lines.append(chrom_line(sample_names, qc.sites_only_query))
    from ..core import profile
    intervals = qc.column_intervals if qc.column_intervals else [None]
    with profile.GLOBAL_STATS.phase("Combined-gVCF-production"):
        for iv in intervals:
            scan_and_operate(store, qc, op.operate, iv,
                             handle_spanning_deletions=True)
    out_lines.extend(op.lines)
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def run_vcf_query_block(store: ColumnarStore, qc: QueryConfig,
                        qp: QueryParams, vid: VidMapper,
                        template_path: Optional[str] = None,
                        reference_path: Optional[str] = None,
                        max_merged: int = 4,
                        max_records_per_block: int = 65536,
                        mesh=None) -> str:
    """--produce-Broad-GVCF via the batched device pipeline.

    Field handling is vid-driven (query/block_fields.BlockPlan); records
    the plan cannot realize splice maximal runs of the sequential
    engine.  Byte-identical to run_vcf_query."""
    out_lines = list(iter_vcf_query_block(
        store, qc, qp, vid, template_path=template_path,
        reference_path=reference_path, max_merged=max_merged,
        max_records_per_block=max_records_per_block, mesh=mesh,
        coalesce=True))
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def iter_vcf_query_block(store, qc: QueryConfig,
                         qp: QueryParams, vid: VidMapper,
                         template_path: Optional[str] = None,
                         reference_path: Optional[str] = None,
                         max_merged: int = 4,
                         max_records_per_block: int = 65536,
                         mesh=None, coalesce: bool = False):
    """Lazy form of run_vcf_query_block: yields header + record lines
    chunk by chunk (record-aligned blocks), so streaming consumers
    (CombinedRecordStream, the socket stream server) ride the batched
    engine without materializing the whole result.

    `store` may be a ColumnarStore (in-RAM / memmapped) or an
    out-of-core fragment_v2.OocArray: then each interval is served in
    memory-bounded column windows (segment_size granularity — the
    reference's TileDB segment reads, variant_storage_manager.cc:478-513)
    and nothing store-wide is ever materialized.  Window edges fall on
    cell-start columns, so the concatenated output is byte-identical to
    an in-RAM query."""
    from ..store.fragment_v2 import OocArray
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    if template_path:
        from ..vcf.header import header_lines_cached
        yield from header_lines_cached(template_path, vid, qc)
        yield chrom_line(sample_names, qc.sites_only_query)
    intervals = qc.column_intervals if qc.column_intervals \
        else [(0, INT64_MAX - 2)]
    if isinstance(store, OocArray):
        lo0, hi0 = store.column_bounds()
        for iv in intervals:
            # clip to the data's column bounds: no record can render
            # outside them, and windows must not walk empty space
            lo, hi = max(int(iv[0]), lo0), min(int(iv[1]), hi0)
            if lo > hi:
                continue
            for wlo, whi, wstore in store.windows((lo, hi)):
                yield from _iter_interval_blocks(
                    wstore, (wlo, whi), qc, qp, vid, ref_genome,
                    reference_path, filter_names, max_merged,
                    max_records_per_block, mesh, coalesce)
        return
    # materialized serving: repeated queries of one signature against an
    # immutable store slice the full-store combined text instead of
    # recomputing (query/serving_index.py — the GATK/Spark split-serving
    # pattern).  Byte-identical by construction + fuzz
    # (tests/test_serving_index.py); build is non-reentrant, so the
    # index's own full-store build runs through the engine path below.
    idx_srv = None
    if mesh is None:
        from ..store.columnar import ColumnarStore
        from . import serving_index as si
        if isinstance(store, ColumnarStore):
            idx_srv = si.lookup_for_query(store, qc, qp, vid,
                                          template_path, reference_path)
    for iv in intervals:
        if idx_srv is not None:
            from . import serving_index as si

            def edge_fn(lo, hi):
                return si.engine_record_lines(store, qc, qp, vid,
                                              reference_path, lo, hi)
            served = idx_srv.serve_text(int(iv[0]), int(iv[1]), edge_fn,
                                        si.make_ref_base(ref_genome))
            if served is not None:
                if coalesce:
                    yield from served
                else:
                    for chunk in served:
                        yield from (ln for ln in chunk.split("\n")
                                    if ln)
                continue
        yield from _iter_interval_blocks(
            store, iv, qc, qp, vid, ref_genome, reference_path,
            filter_names, max_merged, max_records_per_block, mesh,
            coalesce)


def _iter_interval_blocks(store: ColumnarStore, iv, qc, qp, vid,
                          ref_genome, reference_path, filter_names,
                          max_merged, max_records_per_block, mesh,
                          coalesce):
    """Record lines of ONE interval on ONE (window) store — the chunked
    pipelined block-engine body shared by in-RAM and out-of-core paths."""

    def make_seq_fn():
        def seq(lo, hi):
            sub_qp = QueryParams()
            sub_qp.__dict__.update(qp.__dict__)
            sub_qp.scan_full = False
            sub_qp.column_ranges = [[(lo, hi)]]
            sub_qc = make_query_config(sub_qp, vid)
            sub_qc.rows_to_query = list(qc.rows_to_query)
            text = run_vcf_query(store, sub_qc, sub_qp, vid,
                                 template_path=None,
                                 reference_path=reference_path)
            return [ln for ln in text.splitlines() if ln]
        return seq

    from ..ops.store_block import record_starts
    # genome-scale intervals: chunk at RECORD boundaries so block
    # tensors stay bounded; sub-interval [starts[i], starts[j]-1]
    # yields exactly records i..j-1 (chunk edges are event starts,
    # so no record is split)
    starts = record_starts(store, qc, iv)
    # Width-aware chunking: cap each chunk near ~256k cells so the
    # dispatch/render software pipeline below actually overlaps — a
    # 1000-sample full-chromosome query in ONE chunk serializes the
    # device combine and the host text render.
    S_w = len(qc.rows_to_query)
    if S_w:
        max_records_per_block = min(max_records_per_block,
                                    max(1024, (1 << 18) // S_w))
    if len(starts) <= max_records_per_block:
        chunks = [iv]
        # bucket-pad small blocks to power-of-two record counts
        # (and coarse cell counts) so repeated small-interval
        # queries — the Spark/GATK split pattern — hit the XLA
        # compile cache instead of recompiling per shape: p50
        # latency on a 200k-record store drops from ~2.7 s
        # (per-shape compile) to the compile-free cost
        pad_kw = {}
        if len(starts):
            # wide cohorts: a finer record floor (32) halves the padded
            # [B, S] tensors of a typical 10 kb interval query — at
            # S >= 512 the extra compile shape is worth the latency
            bucket = 32 if S_w >= 512 else 64
            while bucket < len(starts):
                bucket *= 2
            pad_kw = {"pad_records": bucket, "pad_cells_to": 256}
    else:
        chunks = []
        for i in range(0, len(starts), max_records_per_block):
            lo = int(starts[i])
            j = i + max_records_per_block
            hi = int(starts[j]) - 1 if j < len(starts) else int(iv[1])
            chunks.append((lo, hi))
        # uniform shapes across chunks -> one compiled combine step
        pad_kw = {"pad_records": max_records_per_block,
                  "pad_cells_to": 256}
    # software pipeline: dispatch chunk k+1's device combine (async
    # under jit) before rendering chunk k's text, so the device
    # computes while the host formats
    from .block_writer import render_block_vcf_pipelined
    pending = None
    for civ in chunks:
        g = render_block_vcf_pipelined(
            store, qc, vid, civ, ref_genome=ref_genome,
            max_merged=max_merged, sequential_fn=make_seq_fn(),
            filter_name_by_field_idx=filter_names, mesh=mesh,
            coalesce=coalesce, **pad_kw)
        next(g)
        if pending is not None:
            yield from next(pending)
        pending = g
    if pending is not None:
        yield from next(pending)


def run_vcf_query_paged(store: ColumnarStore, qc: QueryConfig,
                        qp: QueryParams, vid: VidMapper,
                        page_size: int,
                        template_path: Optional[str] = None,
                        reference_path: Optional[str] = None):
    """Paged production of the combined VCF (the reference's resumable
    VariantQueryProcessorScanState + RWBuffer '-p page_size' mode,
    gt_mpi_gather.cc:349-362).  Yields byte pages lazily; their
    concatenation is byte-identical to run_vcf_query."""
    from .stream import CombinedRecordStream
    stream = CombinedRecordStream(store, qc, qp, vid, template_path,
                                  reference_path)
    yield from stream.pages(page_size)


def run_java_vcf_query(store: ColumnarStore, qc: QueryConfig,
                       qp: QueryParams, vid: VidMapper,
                       template_path: Optional[str] = None,
                       reference_path: Optional[str] = None,
                       sort_samples: bool = False,
                       transform_header: bool = True) -> str:
    """java_vcf query type: htsjdk-rendered combined VCF
    (TestGenomicsDB --query path).  sort_samples reorders sample columns
    alphabetically (the Spark reader's behavior, spark_* goldens);
    transform_header=False keeps the htslib-style header (the spark
    harness pairs the C header with htsjdk records for some configs)."""
    from ..vcf.header import build_header_lines, chrom_line, load_template
    from .java_writer import JavaCombineToVCF, transform_header_lines
    from .scan import scan_and_operate
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    if sort_samples:
        order = sorted(range(len(sample_names)),
                       key=lambda i: sample_names[i])
        qc.rows_to_query = [qc.rows_to_query[i] for i in order]
        sample_names = [sample_names[i] for i in order]
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    op = JavaCombineToVCF(qc, vid, ref_genome, sample_names,
                          filter_name_by_field_idx=filter_names)
    out_lines: List[str] = []
    if template_path:
        template = load_template(template_path)
        hdr = build_header_lines(template, vid, qc)
        if transform_header:
            hdr = transform_header_lines(hdr)
        out_lines.extend(hdr)
        out_lines.append(chrom_line(sample_names, qc.sites_only_query))
    intervals = qc.column_intervals if qc.column_intervals else [None]
    for iv in intervals:
        scan_and_operate(store, qc, op.operate, iv,
                         handle_spanning_deletions=True)
    out_lines.extend(op.lines)
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def run_variants_query(store: ColumnarStore, qc: QueryConfig) -> str:
    """Range query (gt_get_column_interval + GA4GH merge), default JSON."""
    from .variants_path import gt_get_column_interval
    variants = []
    intervals = qc.column_intervals if qc.column_intervals \
        else [(0, INT64_MAX - 1)]
    for iv in intervals:
        variants.extend(gt_get_column_interval(store, qc, iv))
    return json_output.print_variants_json(variants, qc)
