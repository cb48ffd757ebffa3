"""Query CLI (gt_mpi_gather equivalent).

Usage:
  python -m genomicsdb_tpu.tools.gdb_query -j query.json [-l loader.json]
      [--print-calls | --print-csv | --print-AC | --produce-Broad-GVCF
       | --produce-interesting-positions | --produce-histogram BIN_SIZE]
      [-p page_size] [-s segment_size] [-r rank] [--num-ranks N]

Mirrors tools/src/gt_mpi_gather.cc: default output is the variants JSON
(range query); per-rank column subsetting against loader partitions; with
--num-ranks > 1 the per-rank results are gathered and stitched in rank
order (the MPI_Gatherv equivalent, gt_mpi_gather.cc:166-263).
"""

from __future__ import annotations

import argparse
import sys

from ..core.config import ImportParams, QueryParams
from ..query import driver as qdriver
from ..query import operators as ops
from ..query.scan import scan_and_operate, iterate_cells
from ..store import workspace as ws


def load_context(args, rank: int):
    ip = ImportParams.from_file(args.loader) if args.loader else None
    if getattr(args, "query_pb", None):
        # binary ExportConfiguration (the reference's PB plane; wire-
        # compatible schemas in protos/compat/)
        from ..core import pb_compat
        with open(args.query_pb, "rb") as f:
            qp, pb_vid = pb_compat.export_config_to_query(f.read())
        vid = pb_vid if pb_vid is not None \
            else qdriver.load_vid_for_query(qp, ip)
    else:
        qp = QueryParams.from_file(args.query_json, rank)
        vid = qdriver.load_vid_for_query(qp, ip)
    if args.segment_size:
        qp.segment_size = args.segment_size
    if args.chromosome:
        # --chromosome/--begin/--end contig-interval query (TestGenomicsDB
        # java driver flags): translate to flattened columns via the vid
        lo = vid.flatten_position(args.chromosome, args.begin or 1)
        hi = vid.flatten_position(
            args.chromosome,
            args.end or vid.contigs[args.chromosome].length)
        qp.column_ranges = [[(lo, hi)]]
    workspace = qp.workspace or ""
    store = None
    if workspace and qp.array_name and ws.is_workspace(workspace):
        store = _open_store(args, qp, workspace)
    if store is None and ip is not None and ip.column_partitions:
        # inherit this rank's workspace/array from the loader JSON
        # (the reference's update_from_loader, gt_mpi_gather.cc:550-557)
        # — query the IMPORTED partition instead of re-importing
        parts = sorted(ip.column_partitions,
                       key=lambda p: int(p["begin"]))
        if rank < len(parts):
            part = parts[rank]
            w = ip.resolve(part.get("workspace", "")) \
                if part.get("workspace") else ""
            a = part.get("array_name") or part.get("array") or ""
            if w and a and ws.is_workspace(w) \
                    and ws.array_exists(w, a):
                qp.workspace, qp.array_name = w, a
                store = _open_store(args, qp, w)
    if store is None:
        if ip is not None:
            store = qdriver.build_store_from_loader(ip, vid, rank)
        elif vid.callsets:
            # inline callset mapping (PB plane): import directly
            from ..store.import_pipeline import import_callsets
            store = import_callsets(vid)
        else:
            raise SystemExit("no workspace array found and no loader JSON "
                             "given to import from")
    # subset query ranges against the rank's loader partition
    # (gt_mpi_gather.cc:556-557)
    if ip is not None and ip.column_partitions and qp.column_ranges:
        lo, hi = ip.partition_bounds(rank)
        subset = [(max(a, lo), min(b, hi))
                  for a, b in qp.column_ranges[0] if a <= hi and b >= lo]
        qp.column_ranges = [subset]
    return ip, qp, vid, store


def _open_store(args, qp, workspace):
    """Open the workspace array — out-of-core (memory-bounded column
    windows at segment_size granularity) with --ooc, or automatically
    when a single v2 fragment exceeds GENOMICSDB_TPU_OOC_THRESHOLD
    (default 4 GiB); in-RAM otherwise."""
    import os as _os
    use_ooc = getattr(args, "ooc", False)
    if not use_ooc and "://" not in workspace:
        from ..store.fragment_v2 import V2_SUFFIX, read_manifest
        frags = ws._fragment_paths(workspace, qp.array_name)
        if len(frags) == 1 and frags[0].endswith(V2_SUFFIX):
            thresh = int(_os.environ.get(
                "GENOMICSDB_TPU_OOC_THRESHOLD", 4 << 30))
            if read_manifest(frags[0])["total_bytes"] > thresh:
                use_ooc = True
    if use_ooc:
        return ws.open_array_ooc(workspace, qp.array_name,
                                 segment_size=qp.segment_size)
    return ws.open_array(workspace, qp.array_name)


def run_rank(args, rank: int) -> str:
    ip, qp, vid, store = load_context(args, rank)
    from ..store.fragment_v2 import OocArray
    if isinstance(store, OocArray) and not (
            args.produce_Broad_GVCF and args.engine == "block"
            and not args.java_vcf and args.page_size == 0):
        # only the block combine engine streams OocArray windows; the
        # other query types run on the memmap-backed store view (still
        # no .npz decompress — the OS pages in what the query touches)
        store = store.store
    qc = qdriver.make_query_config(qp, vid)
    if args.print_calls:
        return qdriver.run_calls_query(store, qc)
    if args.print_csv:
        ivs = qc.column_intervals or None
        return ops.print_csv(store, qc, ivs)
    if args.print_AC:
        op = ops.AlleleCountOperator(qc)
        for iv in (qc.column_intervals or [None]):
            for call in iterate_cells(store, qc, iv):
                op.operate(call)
        return op.render()
    if args.produce_interesting_positions:
        op = ops.InterestingLocationsPrinter()
        for iv in (qc.column_intervals or [None]):
            scan_and_operate(store, qc, op.operate, iv)
        return op.render()
    if args.produce_histogram:
        op = ops.ColumnHistogramOperator(0, 4_000_000_000, args.bin_size)
        for iv in (qc.column_intervals or [None]):
            for call in iterate_cells(store, qc, iv):
                op.operate(call)
        return op.equi_partition_and_render(args.num_equi_bins)
    if args.produce_Broad_GVCF:
        template = qp.resolve(qp.vcf_header_filename) \
            if qp.vcf_header_filename else None
        if template is None and ip is not None and ip.vcf_header_filename:
            template = ip.resolve(ip.vcf_header_filename)
        refg = qp.resolve(qp.reference_genome) if qp.reference_genome \
            else (ip.resolve(ip.reference_genome) if ip else None)
        # header only on rank 0 (partition outputs are concatenated)
        tmpl = template if rank == args.rank \
            and not getattr(args, "no_vcf_header", False) else None
        if args.page_size > 0 and not args.java_vcf:
            # batched_vcf mode: resumable byte pages whose concatenation
            # is byte-identical to the one-shot query (gt_mpi_gather.cc
            # -p page_size / RWBuffer path)
            pages = qdriver.run_vcf_query_paged(
                store, qc, qp, vid, args.page_size,
                template_path=tmpl, reference_path=refg)
            return b"".join(pages).decode()
        if args.java_vcf:
            fn = qdriver.run_java_vcf_query
        elif args.engine == "block":
            fn = qdriver.run_vcf_query_block
            if args.mesh:
                n_pos, n_row = (int(x) for x in
                                args.mesh.lower().split("x"))
                from ..parallel.sharded import make_mesh
                return fn(store, qc, qp, vid, template_path=tmpl,
                          reference_path=refg,
                          mesh=make_mesh(n_pos, n_row))
        else:
            fn = qdriver.run_vcf_query
        return fn(store, qc, qp, vid, template_path=tmpl,
                  reference_path=refg)
    if args.output_format == "Cotton-JSON":
        from ..query import json_output
        from ..query.variants_path import gt_get_column_interval
        from ..core.config import INT64_MAX
        variants = []
        for iv in (qc.column_intervals or [(0, INT64_MAX - 1)]):
            variants.extend(gt_get_column_interval(store, qc, iv))
        return json_output.print_cotton_json(variants, qc)
    if args.output_format == "Positions-JSON":
        from ..query import json_output
        from ..query.variants_path import gt_get_column_interval
        from ..core.config import INT64_MAX
        per_interval = []
        for iv in (qc.column_intervals or [(0, INT64_MAX - 1)]):
            per_interval.append((iv, gt_get_column_interval(store, qc, iv)))
        return json_output.print_positions_json(per_interval, qc)
    # default: variants JSON range query
    return qdriver.run_variants_query(store, qc)


def _parallel_rank_pieces(raw_argv, args):
    """Spawn one gdb_query worker PROCESS per rank and gather their
    stdout in rank order — the reference's MPI execution model
    (rank-per-partition processes, root MPI_Gatherv of the serialized
    results, gt_mpi_gather.cc:166-295).  Each worker gets its share of
    the card's memory (runtime/device_env.rank_env); this root process
    stays off the device."""
    import subprocess

    from ..runtime.device_env import rank_env

    base = []
    skip = False
    for a in raw_argv:
        if skip:
            skip = False
            continue
        if a in ("-r", "--rank", "--num-ranks"):
            skip = True
            continue
        if a == "--parallel-ranks":
            continue
        base.append(a)
    import os as _os
    pin = _os.environ.get("GENOMICSDB_TPU_RANK_AFFINITY") == "1"
    ncores = _os.cpu_count() or 1
    procs = []
    for i, r in enumerate(range(args.rank, args.rank + args.num_ranks)):
        cmd = [sys.executable, "-m", "genomicsdb_tpu.tools.gdb_query",
               *base, "-r", str(r), "--num-ranks", "1", "--rank-piece"]
        if i > 0:
            cmd.append("--no-vcf-header")
        pre = None
        if pin and hasattr(_os, "sched_setaffinity"):
            core = i % ncores
            pre = (lambda c: lambda: _os.sched_setaffinity(0, {c}))(core)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE,
                                      preexec_fn=pre,
                                      env=rank_env(i, args.num_ranks)))
    pieces = []
    errs = []
    for r, pr in zip(range(args.rank, args.rank + args.num_ranks),
                     procs):
        out, err = pr.communicate()
        if pr.returncode != 0:
            errs.append(f"rank {r}: exit {pr.returncode}: "
                        f"{err.decode(errors='replace')[-500:]}")
        pieces.append(out.decode())
    if errs:
        raise SystemExit("gdb_query --parallel-ranks failed:\n"
                         + "\n".join(errs))
    return pieces


def rank_output(argv) -> str:
    """Parse a gdb_query argv and return the output text (the
    rank-pool worker entry, parallel/rank_pool.py — no stdout side
    effects, no file knobs)."""
    args = _build_parser().parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    return "".join(run_rank(args, r)
                   for r in range(args.rank, args.rank + args.num_ranks))


def _build_parser():
    p = argparse.ArgumentParser(prog="gdb_query")
    p.add_argument("-j", "--query-json", dest="query_json", default=None)
    p.add_argument("--query-pb", dest="query_pb", default=None,
                   help="binary ExportConfiguration protobuf "
                        "(reference-schema wire format) instead of -j")
    p.add_argument("-l", "--loader", default=None)
    p.add_argument("-s", "--segment-size", type=int, default=0)
    p.add_argument("--ooc", action="store_true",
                   help="serve the query out-of-core: memory-bounded "
                        "column windows of segment_size bytes instead "
                        "of loading the partition into RAM (v2 "
                        "fragments; auto-enabled past "
                        "GENOMICSDB_TPU_OOC_THRESHOLD, default 4 GiB)")
    p.add_argument("-p", "--page-size", type=int, default=0)
    p.add_argument("-r", "--rank", type=int, default=0)
    p.add_argument("--num-ranks", type=int, default=1,
                   help="gather outputs of ranks [rank, rank+num_ranks)")
    p.add_argument("--parallel-ranks", action="store_true",
                   help="run each rank in its OWN worker process and "
                        "gather stdout in rank order — the reference's "
                        "MPI rank-per-partition execution model "
                        "(vcf2tiledb.cc:44-52, gt_mpi_gather.cc:166-295) "
                        "with this process as the root gatherer")
    p.add_argument("--rank-piece", action="store_true",
                   help=argparse.SUPPRESS)   # internal: worker mode
    p.add_argument("--no-vcf-header", action="store_true",
                   help=argparse.SUPPRESS)   # internal: non-first rank
    p.add_argument("--print-calls", action="store_true")
    p.add_argument("--print-csv", action="store_true")
    p.add_argument("--print-AC", dest="print_AC", action="store_true")
    p.add_argument("--produce-Broad-GVCF", dest="produce_Broad_GVCF",
                   action="store_true")
    p.add_argument("--produce-interesting-positions",
                   action="store_true")
    p.add_argument("--produce-histogram", dest="produce_histogram",
                   action="store_true")
    p.add_argument("--bin-size", type=int, default=10000)
    p.add_argument("--num-equi-bins", type=int, default=10)
    p.add_argument("--chromosome", default=None)
    p.add_argument("--begin", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--java-vcf", dest="java_vcf", action="store_true",
                   help="htsjdk-style rendering for --produce-Broad-GVCF")
    p.add_argument("--mesh", default=None, metavar="POSxROW",
                   help="run the block-engine combine sharded over an "
                        "n_pos x n_row device mesh (e.g. 4x2): position "
                        "axis = column partitions, row axis = samples; "
                        "outputs are bit-identical to single-device")
    p.add_argument("--engine", choices=["sequential", "block"],
                   default="block",
                   help="combined-VCF engine (default: block — the "
                        "batched device engine; byte-identical to "
                        "'sequential', the per-record reference-"
                        "semantics oracle, on every golden and "
                        "60k+ fuzz cases)")
    p.add_argument("-O", "--output-format", dest="output_format",
                   default="", choices=["", "Cotton-JSON",
                                        "Positions-JSON", "GA4GH"],
                   help="range-query output format (default GA4GH-like)")
    p.add_argument("--platform", default=None,
                   help="pin the jax platform (e.g. 'cpu', 'gpu'); "
                        "default: JAX's own choice")
    return p


def main(argv=None):
    p = _build_parser()
    args = p.parse_args(argv)
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    from ..runtime.device_env import init_compile_cache
    init_compile_cache()
    if not args.query_json and not args.query_pb:
        p.error("one of -j/--query-json or --query-pb is required")
    # rank fan-out + ordered gather (combine output is partition-ordered by
    # construction, gt_mpi_gather.cc:322-366)
    import json as _json
    try:
        if args.parallel_ranks and args.num_ranks > 1:
            pieces = _parallel_rank_pieces(
                list(argv) if argv is not None else sys.argv[1:], args)
        else:
            pieces = [run_rank(args, r)
                      for r in range(args.rank,
                                     args.rank + args.num_ranks)]
    except FileNotFoundError as e:
        raise SystemExit(f"gdb_query: file not found: {e.filename or e}")
    except _json.JSONDecodeError as e:
        raise SystemExit(f"gdb_query: malformed JSON in "
                         f"{args.query_json}: {e}")
    except KeyError as e:
        raise SystemExit(f"gdb_query: unknown contig or field {e} "
                         "(check --chromosome / vid mapping)")
    text = "".join(pieces)
    # vcf_output_filename / vcf_output_format knobs (VCFAdapter "z" mode)
    if args.query_pb:
        from ..core import pb_compat
        with open(args.query_pb, "rb") as f:
            qp0, _ = pb_compat.export_config_to_query(f.read())
    else:
        qp0 = QueryParams.from_file(args.query_json, args.rank)
    if args.rank_piece:
        sys.stdout.write(text)      # worker: parent owns the file knob
        return
    if qp0.vcf_output_filename and qp0.vcf_output_filename != "-":
        from ..vcf.bgzf import open_output
        with open_output(qp0.resolve(qp0.vcf_output_filename),
                         qp0.vcf_output_format,
                         index=qp0.index_output_VCF) as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    # GENOMICSDB_TPU_PROFILE=1: scan counters + timers + memory to stderr
    # (the reference's -DDO_PROFILING per-rank report, gt_mpi_gather.cc:
    # 296-316)
    from ..core import profile
    profile.maybe_report()


if __name__ == "__main__":
    main()
