"""Socket-stream interval-serving latency benchmark (the GATK/Spark
split pattern, reference GenomicsDBInputFormat.java:65: one small
interval query per partition x query block, thousands per job).

Builds the 200k-record genome cohort (same synth as genome_bench),
persists it as a workspace on disk, starts the query-stream server
in-process, and times repeated 10 kb interval queries through the FULL
external attachment round trip: TCP connect + JSON query parse + store
open (cached) + block-engine combine + BCF2 encode + socket stream.

Usage: python -m genomicsdb_tpu.tools.stream_latency_bench \
          [--records N] [--samples N] [--queries N]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--interval", type=int, default=10_000)
    args = ap.parse_args(argv)

    from genomicsdb_tpu.core.vid import VidMapper
    from genomicsdb_tpu.query.stream_server import (QueryStreamServer,
                                                    read_query_stream)
    from genomicsdb_tpu.store import workspace as ws
    from genomicsdb_tpu.store.import_pipeline import import_callsets
    from genomicsdb_tpu.tools.genome_bench import make_cohort
    from genomicsdb_tpu.tools.synth_cohort import write_mappings

    tmp = tempfile.mkdtemp()
    vcf_path = os.path.join(tmp, "genome_cohort.vcf")
    region = make_cohort(vcf_path, args.samples, args.records)
    vid_file, callset_file = write_mappings(
        tmp, [(vcf_path, [f"S{i}" for i in range(args.samples)])])

    vid = VidMapper.from_files(vid_file, callset_file)
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t_import = time.perf_counter() - t0
    wsp = os.path.join(tmp, "workspace")
    ws.create_workspace(wsp)
    ws.write_fragment(wsp, "genome", store)

    srv = QueryStreamServer(port=0)
    srv.start_background()
    host, port = srv.address

    def doc(lo: int, hi: int) -> dict:
        return {
            "workspace": wsp, "array_name": "genome",
            "vid_mapping_file": vid_file,
            "callset_mapping_file": callset_file,
            "attributes": [],
            "query_column_ranges": [
                {"range_list": [{"low": lo, "high": hi}]}],
        }

    try:
        rng = random.Random(2)
        lo = rng.randint(1, max(region - 2 * args.interval, 2))
        for _ in range(args.warmup):
            read_query_stream(host, port, doc(lo, lo + args.interval))
        lats = []
        total_bytes = 0
        for _ in range(args.queries):
            lo = rng.randint(1, max(region - 2 * args.interval, 2))
            t0 = time.perf_counter()
            data = read_query_stream(host, port,
                                     doc(lo, lo + args.interval))
            lats.append(time.perf_counter() - t0)
            total_bytes += len(data)
            assert data[:5] == b"BCF\x02\x02"
        lats.sort()
        n = len(lats)
        # persistent-connection mode: one TCP connection serves every
        # query (framed responses) — no per-query connect/teardown
        from genomicsdb_tpu.query.stream_server import QueryStreamClient
        plats = []
        with QueryStreamClient(host, port) as cli:
            for _ in range(args.warmup):
                cli.query(doc(lo, lo + args.interval))
            for _ in range(args.queries):
                lo = rng.randint(1, max(region - 2 * args.interval, 2))
                t0 = time.perf_counter()
                data = cli.query(doc(lo, lo + args.interval))
                plats.append(time.perf_counter() - t0)
                assert data[:5] == b"BCF\x02\x02"
        plats.sort()
        # engine lane: the same persistent-connection queries with the
        # materialized serving index disabled — the per-query live
        # combine cost, reported alongside the production (served) path
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
        try:
            elats = []
            with QueryStreamClient(host, port) as cli:
                for _ in range(4):
                    cli.query(doc(lo, lo + args.interval))
                for _ in range(max(n // 2, 10)):
                    lo = rng.randint(1, max(region - 2 * args.interval,
                                            2))
                    t0 = time.perf_counter()
                    cli.query(doc(lo, lo + args.interval))
                    elats.append(time.perf_counter() - t0)
        finally:
            del os.environ["GENOMICSDB_TPU_SERVING_INDEX"]
        elats.sort()
        print(json.dumps({
            "samples": args.samples, "records": args.records,
            "cells": int(store.num_cells), "positions": region,
            "import_s": round(t_import, 2),
            "interval_bp": args.interval, "queries": n,
            "socket_p50_ms": round(lats[n // 2] * 1000, 1),
            "socket_p90_ms": round(lats[(n * 9) // 10] * 1000, 1),
            "socket_min_ms": round(lats[0] * 1000, 1),
            "persistent_p50_ms": round(plats[n // 2] * 1000, 1),
            "persistent_p90_ms": round(plats[(n * 9) // 10] * 1000, 1),
            "engine_persistent_p50_ms": round(
                elats[len(elats) // 2] * 1000, 1),
            "engine_persistent_p90_ms": round(
                elats[(len(elats) * 9) // 10] * 1000, 1),
            "mean_stream_bytes": total_bytes // n}))
    finally:
        srv.shutdown()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
