#!/usr/bin/env python
"""Combine-query benchmark on one NVIDIA GPU.

Runs the batched device combine step (genomicsdb_tpu.ops.combine_step)
over a synthetic gVCF cohort (BASELINE.json config 5 shape) and the
end-to-end lanes (import, 100-sample cohort, 1000-sample wide cohort,
out-of-core partition, rank scaling, socket latency), and prints one
JSON line naming the device it ran on.  It fails when JAX finds no GPU.

Device times are host-clock windows that end in `block_until_ready`.
The lanes that run as child processes (out-of-core, wide cohort,
scaling, socket latency) run before this process opens the card, so one
process holds the card at a time; rank lanes give each rank its share
(runtime/device_env.rank_env).
"""

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

# the device's peak memory bandwidth, by device_kind (NVIDIA H100 SXM
# data sheet: 80 GB HBM3 at 3.35 TB/s)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def combine_bytes(B: int, S: int, g_in: int, a_in: int, ploidy: int,
                  m: int, n_f: int, n_fi: int, n_fs: int,
                  g_out: int) -> int:
    """Least bytes one combine_step call over a [B, S] chunk moves:
    every gathered cell value read once (PL, AD, GT, the scalar FORMAT
    fields and the INFO inputs), the per-(record, sample) LUTs and live
    index read once, every [B, S] output written once (int32/float32
    throughout).  Per-record outputs are negligible."""
    gathered = g_in + a_in + ploidy + 6 + n_f + n_fi + n_fs
    index = (m + 3) * 4 + 1              # inv_bs, nr_bs, live, gt_len, del
    outputs = g_out + m + ploidy + 4     # pl, ad, gt, gq, dp, min_dp, live
    return B * S * (4 * gathered + index + 4 * outputs)


def peak_bytes_per_s(device) -> float:
    """Published memory bandwidth of `device` (KeyError when its
    device_kind is not in the table: no default peak)."""
    return PEAK_BYTES_PER_S[device.device_kind]


def bench_device(num_samples=128, cells_per_sample=2048, region_len=262144,
                 chunk=8192, reps=5):
    """combine_step over the cohort in record chunks of `chunk`: the
    median over `reps` of one pass (all chunks dispatched, then
    block_until_ready), the bytes the step must move (combine_bytes)
    and the achieved rate.  Also times masked_seq_sum_float alone at
    the chunk shape: for S > 64 it is a loop of S serial steps."""
    import functools

    import jax
    from genomicsdb_tpu.ops import jax_kernels as K
    from genomicsdb_tpu.ops.combine_step import (combine_step,
                                                 masked_seq_sum_float,
                                                 synthesize_cohort)
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    fn = functools.partial(combine_step, max_merged=4, ploidy=2)
    fixed = tuple(jax.device_put(x) for x in (
        blk.pl, blk.pl_len, blk.ad, blk.ad_len, blk.gt, blk.gq, blk.dp,
        blk.min_dp, blk.dp_info, blk.info_f, blk.info_i, blk.info_fs))
    nb = len(blk.starts)
    pad = (-nb) % chunk

    def padB(x, fill):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill)
    n_chunks = (nb + pad) // chunk
    S = blk.col.shape[0]
    # live matrix + per-record LUTs precomputed on host, as in the
    # production path (store_to_block)
    per_chunk = [tuple(jax.device_put(x[i * chunk:(i + 1) * chunk])
                       for x in (padB(blk.inv_bs, -1), padB(blk.nr_bs, -1),
                                 padB(blk.rec_num_merged, 1),
                                 np.ones(nb + pad, dtype=bool),
                                 padB(blk.live, -1)))
                 for i in range(n_chunks)]

    def one_pass():
        outs = [fn(*fixed, *c) for c in per_chunk]
        jax.block_until_ready(outs)
        return outs

    t0 = time.perf_counter()
    one_pass()
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        one_pass()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    g_out = len(K.genotype_combo_table(4, 2))
    nbytes = n_chunks * combine_bytes(
        chunk, S, blk.pl.shape[2], blk.ad.shape[2], blk.gt.shape[2], 4,
        blk.info_f.shape[0], blk.info_i.shape[0], blk.info_fs.shape[0],
        g_out)
    # the serial float-sum loop alone at the chunk shape
    vals = jax.device_put(np.ones((1, chunk, S), np.float32))
    ok = jax.device_put(np.ones((1, chunk, S), bool))
    fsum = jax.jit(masked_seq_sum_float)
    jax.block_until_ready(fsum(vals, ok))
    fs_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fsum(vals, ok))
        fs_times.append(time.perf_counter() - t0)
    return {
        "samples": num_samples,
        "records": nb,
        "chunk": chunk,
        "chunks": n_chunks,
        "setup_s": setup_s,
        "seconds": sec,
        "seconds_min": min(times),
        "seconds_max": max(times),
        "reps": reps,
        "ms_per_chunk": sec / n_chunks * 1e3,
        "positions_per_sec": region_len / sec,
        "records_per_sec": nb / sec,
        "cells_per_sec": nb * num_samples / sec,
        "bytes": nbytes,
        "bytes_per_sec": nbytes / sec,
        "fsum_loop_ms": statistics.median(fs_times) * 1e3,
    }


def bench_device_dense(num_samples=128, cells_per_sample=2048,
                       region_len=262144, chunk=8192, reps=5):
    """Device throughput of the PRE-GATHERED path (combine_step_dense,
    GENOMICSDB_TPU_DENSE=1): the host gathers live cells
    (gather_block_host) and the device runs only the dense remap +
    reduction math.  Measures device math; the per-chunk upload is
    excluded."""
    import functools

    import copy

    import jax
    from genomicsdb_tpu.ops.combine_step import (combine_step_dense,
                                                 gather_block_host,
                                                 synthesize_cohort)
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    nb = len(blk.starts)
    recnm = blk.rec_num_merged[:chunk]
    sub = copy.copy(blk)
    sub.inv_bs = blk.inv_bs[:chunk]
    sub.nr_bs = blk.nr_bs[:chunk]
    g = gather_block_host(sub, blk.live[:chunk])
    keys = ("plg", "invg", "pllg", "nrg", "adg", "adlg", "gtg", "gqg",
            "dpfg", "mdpg", "dpig", "infog", "infoig", "infofsg",
            "valid")
    dev = [jax.device_put(g[k]) for k in keys]
    recnm_d = jax.device_put(recnm)
    fn = functools.partial(combine_step_dense, max_merged=4, ploidy=2)

    def run():
        return jax.block_until_ready(fn(*dev, recnm_d))

    run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    scale = chunk / nb
    return {
        "records_per_sec": chunk / sec,
        "positions_per_sec": region_len * scale / sec,
        "records": chunk,
        "seconds": sec,
    }


def bench_oracle(num_samples=128, cells_per_sample=32, region_len=4096):
    """Sequential semantics oracle (reference-equivalent scan) on a smaller
    slice; returns positions/sec."""
    sys.path.insert(0, "tests")
    from genomicsdb_tpu.core import formats
    from genomicsdb_tpu.ops import merge as M

    rng = np.random.default_rng(0)
    # Build a small synthetic cohort through the same semantics path the
    # golden tests use: per-sample interval cells with PL/AD remaps.
    S, C = num_samples, cells_per_sample
    bounds = np.sort(rng.integers(0, region_len, size=(S, C - 1)), axis=1)
    col = np.concatenate([np.zeros((S, 1), np.int64), bounds], axis=1)
    end = np.concatenate([bounds - 1,
                          np.full((S, 1), region_len - 1, np.int64)], axis=1)
    end = np.where(end < col, col, end)
    pl = rng.integers(0, 2000, size=(S, C, 10)).astype(np.int32)
    t0 = time.perf_counter()
    # sweep
    events = np.unique(np.concatenate([col.ravel(), end.ravel() + 1]))
    starts = events[events < region_len]
    n_rec = 0
    # per-interval sequential combine (python loop = reference's model)
    ptr = np.zeros(S, dtype=np.int64)
    for st in starts:
        lut = np.array([0, 1, 2, 3], dtype=np.int32)
        for s in range(S):
            while ptr[s] + 1 < C and col[s, ptr[s] + 1] <= st:
                ptr[s] += 1
            if col[s, ptr[s]] <= st <= end[s, ptr[s]]:
                M.remap_by_genotype(pl[s, ptr[s]], lut, 4, True, 2,
                                    formats.INT_MISSING)
        n_rec += 1
    dt = time.perf_counter() - t0
    return {"positions_per_sec": region_len / dt, "records": n_rec,
            "seconds": dt}


def bench_cpp_baseline(num_samples=128, cells_per_sample=2048,
                       region_len=262144):
    """C++-speed sequential combine on the SAME cohort as bench_device
    (runtime/native/seq_bench.cpp): the reference's per-record per-call
    hot loop at compiled speed.  This is the primary vs_baseline anchor;
    the Python oracle stays as a secondary line."""
    import ctypes

    from genomicsdb_tpu.ops.combine_step import synthesize_cohort
    from genomicsdb_tpu.runtime import native_loader
    lib = native_loader.get_lib()
    if lib is None:
        return None
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    i64 = ctypes.c_int64
    fn = lib.gdb_seq_combine_bench
    fn.restype = ctypes.c_int32
    fn.argtypes = [np.ctypeslib.ndpointer(np.int64),
                   np.ctypeslib.ndpointer(np.int64), i64, i64,
                   np.ctypeslib.ndpointer(np.int32), i64,
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int32), i64,
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int32), i64,
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int32),
                   np.ctypeslib.ndpointer(np.int64),
                   np.ctypeslib.ndpointer(np.int32), i64]
    S, C = blk.col.shape
    B = len(blk.starts)
    args = (np.ascontiguousarray(blk.col),
            np.ascontiguousarray(blk.end), S, C,
            np.ascontiguousarray(blk.pl), blk.pl.shape[2],
            np.ascontiguousarray(blk.pl_len),
            np.ascontiguousarray(blk.ad), blk.ad.shape[2],
            np.ascontiguousarray(blk.ad_len),
            np.ascontiguousarray(blk.inv_bs),
            np.ascontiguousarray(blk.nr_bs), blk.inv_bs.shape[2],
            np.ascontiguousarray(blk.dp_info),
            np.ascontiguousarray(blk.dp),
            np.ascontiguousarray(blk.min_dp),
            np.ascontiguousarray(blk.starts),
            np.ascontiguousarray(blk.rec_num_merged), B)
    chk = fn(*args)          # warm
    t0 = time.perf_counter()
    chk2 = fn(*args)
    dt = time.perf_counter() - t0
    assert chk2 == chk
    out = {
        "positions_per_sec": region_len / dt,
        "records_per_sec": B / dt,
        "records": int(B),
        "seconds": dt,
        "checksum": int(chk),
    }
    # multi-threaded variant: records range-partitioned across all
    # cores — the reference's rank-per-partition process model
    # (vcf2tiledb.cc:44-52) run thread-per-core.  Checksum must equal
    # the single-threaded run (commutative int32 wraparound sum).
    n_threads = os.cpu_count() or 1
    fn_mt = lib.gdb_seq_combine_bench_mt
    fn_mt.restype = ctypes.c_int32
    fn_mt.argtypes = fn.argtypes + [i64]
    chk_mt = fn_mt(*args, n_threads)   # warm
    t0 = time.perf_counter()
    chk_mt2 = fn_mt(*args, n_threads)
    dt_mt = time.perf_counter() - t0
    assert chk_mt == chk and chk_mt2 == chk, (chk_mt, chk)
    out["mt_threads"] = n_threads
    out["mt_positions_per_sec"] = region_len / dt_mt
    out["mt_seconds"] = dt_mt
    return out


def bench_import(n_records=20000, n_samples=8):
    """Import throughput: native columnar-direct loader vs the Python
    reference path, cells/sec."""
    import random
    random.seed(0)
    tmpdir = tempfile.mkdtemp(prefix="bench_import_")
    path = os.path.join(tmpdir, "bench_cohort.vcf")
    samples = [f"S{i}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        for line in [
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
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
            end = pos + random.randint(10, 200)
            cells = "\t".join(
                f"0/0:{random.randint(1, 60)}:0:0:0,0,0"
                for _ in range(n_samples))
            f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                    f"GT:DP:GQ:MIN_DP:PL\t{cells}\n")
            pos = end + 1
    from genomicsdb_tpu.store.fast_import import fast_import_file
    from genomicsdb_tpu.store.import_pipeline import VCFCellConverter
    from genomicsdb_tpu.tools import synth_cohort as sc
    vid = sc.load_vid(*sc.write_mappings(tmpdir, []))
    idx_to_row = {i: i for i in range(n_samples)}
    t0 = time.perf_counter()
    st = fast_import_file(path, vid, idx_to_row)
    t_fast = time.perf_counter() - t0
    n_cells = st.num_cells if st is not None else 0
    from genomicsdb_tpu.vcf.reader import VCFFile
    t0 = time.perf_counter()
    conv = VCFCellConverter(VCFFile(path), vid, idx_to_row)
    cells = conv.convert()
    t_py = time.perf_counter() - t0
    os.unlink(path)
    out = {
        "cells": n_cells,
        "native_cells_per_sec": n_cells / t_fast if t_fast else 0,
        "python_cells_per_sec": len(cells) / t_py,
        "speedup": t_py / t_fast if t_fast else 0,
    }
    out["asa"] = _bench_import_asa(n_records, n_samples, tmpdir)
    return out


def _bench_import_asa(n_records, n_samples, tmpdir):
    """Import throughput with EVERY record carrying allele-specific
    2-D INFO annotations (AS_RAW_MQ element_wise_sum + AS_RAW_MQRankSum
    histogram tuple) — the GATK-production annotation shape the round-4
    verdict flagged as silently dropping to the Python converter.
    Parses through fast_import's ragged2d path
    (genomicsdb_multid_vector_field.h:87 parity)."""
    import random
    random.seed(3)
    path = os.path.join(tmpdir, "bench_cohort_asa.vcf")
    samples = [f"S{i}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        for line in [
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
            '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="m">',
            '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
            '##INFO=<ID=AS_RAW_MQ,Number=1,Type=String,Description="a">',
            '##INFO=<ID=AS_RAW_MQRankSum,Number=1,Type=String,'
            'Description="h">',
            '##contig=<ID=1,length=249250621>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            end = pos + random.randint(10, 200)
            mq = (f"{random.random()*40:.2f},{random.random()*40:.2f}"
                  f"|{random.random()*40:.2f}")
            rs = (f"|{random.random():.1f},{random.randint(1, 9)},"
                  f"{random.random():.1f},{random.randint(1, 9)}")
            cells = "\t".join(
                f"0/0:{random.randint(1, 60)}:0:0:0,0,0"
                for _ in range(n_samples))
            f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end};"
                    f"AS_RAW_MQ={mq};AS_RAW_MQRankSum={rs}\t"
                    f"GT:DP:GQ:MIN_DP:PL\t{cells}\n")
            pos = end + 1
    from genomicsdb_tpu.store.fast_import import fast_import_file
    from genomicsdb_tpu.tools import synth_cohort as sc
    vid = sc.load_vid(*sc.write_mappings(tmpdir, [], allele_specific=True))
    idx_to_row = {i: i for i in range(n_samples)}
    st = fast_import_file(path, vid, idx_to_row)   # warm (page cache)
    if st is None:
        os.unlink(path)
        return {"error": "fast path declined the ASA cohort"}
    t_fast = None
    for _ in range(3):
        t0 = time.perf_counter()
        st = fast_import_file(path, vid, idx_to_row)
        dt = time.perf_counter() - t0
        t_fast = dt if t_fast is None else min(t_fast, dt)
    os.unlink(path)
    return {
        "cells": int(st.num_cells),
        "native_cells_per_sec": st.num_cells / t_fast if t_fast else 0,
    }


def _child_lane(args, timeout):
    """`python -m <args>` in a fresh process (its own peak RSS, the card
    to itself); its last stdout line is its JSON result.  A failed lane
    stops the bench."""
    import subprocess
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise RuntimeError(f"{args[0]} failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def bench_out_of_core(target_bytes=2e9):
    """Out-of-core serving: a ~2 GB single-fragment partition is built
    by streaming writes and queried whole in segment_size (10 MB)
    windows.  The claim recorded: peak RSS stays a small constant
    fraction of the partition (the reference's segment-granular TileDB
    serving, variant_storage_manager.cc:478-513)."""
    return _child_lane(["genomicsdb_tpu.tools.ooc_bench", "--target-bytes",
                        str(target_bytes)], timeout=1200)


def bench_wide_cohort():
    """1000-sample chromosome-scale lane (GATK joint-genotyping width):
    cells/sec, positions/sec, interval p50/p90 (tools/wide_cohort_bench.py;
    sampled-window sequential equivalence is pinned by
    tests/test_wide_cohort.py)."""
    return _child_lane(["genomicsdb_tpu.tools.wide_cohort_bench",
                        "--skip-seq"], timeout=1800)


def bench_stream_latency():
    """Socket-stream interval latency (the GATK/Spark split-serving
    pattern): p50/p90 of 10 kb interval queries against the 200k-record
    store through the external TCP attachment, one-shot and persistent
    connections (tools/stream_latency_bench.py)."""
    return _child_lane(["genomicsdb_tpu.tools.stream_latency_bench"],
                       timeout=900)


def bench_process_scaling():
    """Strong scaling across worker PROCESSES (the reference's MPI
    rank-per-partition model): 1/2/4 pinned ranks over an
    equally-partitioned workspace, each with its share of the card,
    outputs byte-identical across rank counts (tools/scaling_bench.py)."""
    return _child_lane(["genomicsdb_tpu.tools.scaling_bench", "--records",
                        "600000"], timeout=1200)


def bench_cohort_end_to_end(n_samples=100, n_records=4000):
    """Full pipeline on a 100-sample cohort (BASELINE config 5 shape):
    VCF text -> native import -> store->device block -> device combine.
    Reports per-stage seconds + end-to-end positions/sec."""
    import random
    random.seed(1)
    tmpdir = tempfile.mkdtemp(prefix="bench_cohort100_")
    path = os.path.join(tmpdir, "bench_cohort100.vcf")
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
            '##INFO=<ID=BaseQRankSum,Number=1,Type=Float,Description="b">',
            '##contig=<ID=1,length=249250621>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 20 == 19:  # variant site
                cells = "\t".join(
                    f"0/1:{random.randint(1,40)},{random.randint(1,40)},0:"
                    f"{random.randint(10,99)}:{random.randint(10,99)}:.:"
                    f"{random.randint(0,500)},0,{random.randint(0,500)},"
                    f"{random.randint(0,500)},{random.randint(0,500)},"
                    f"{random.randint(0,500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t50\t.\t"
                        f"BaseQRankSum={random.random():.3f}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(50, 400)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1,60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    region_len = pos
    import jax
    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.ops.combine_step import block_to_args, combine_step
    from genomicsdb_tpu.ops.store_block import store_to_block
    from genomicsdb_tpu.query import driver
    from genomicsdb_tpu.store.import_pipeline import import_callsets
    from genomicsdb_tpu.tools import synth_cohort as sc
    vid = sc.load_vid(*sc.write_mappings(tmpdir, [(path, samples)]))
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t_import = time.perf_counter() - t0
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    t0 = time.perf_counter()
    blk = store_to_block(store, qc, interval=(0, region_len),
                         max_merged=4, ploidy=2)
    t_block = time.perf_counter() - t0
    def _run_device():
        return jax.block_until_ready(
            combine_step(*block_to_args(blk), max_merged=4, ploidy=2))

    t0 = time.perf_counter()
    _run_device()
    t_compile_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    _run_device()
    t_device = time.perf_counter() - t0

    def _run_text():
        qc2 = driver.make_query_config(qp, vid)
        return driver.run_vcf_query_block(store, qc2, qp, vid,
                                          template_path=None,
                                          reference_path=None)

    # warm run first: cold time (compiles) is reported separately as
    # vcf_text_cold_s.  The serving index is disabled:
    # this lane measures the ENGINE (the index would materialize on the
    # warm repeat and serve a slice of itself).
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
    try:
        t0 = time.perf_counter()
        text = _run_text()
        t_text_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        text2 = _run_text()
        t_text = time.perf_counter() - t0
    finally:
        del os.environ["GENOMICSDB_TPU_SERVING_INDEX"]
    assert text2 == text, "text phase not deterministic across runs"
    n_lines = text.count("\n")
    os.unlink(path)
    # The reference splits the loader (vcf2tiledb) from the query tool
    # (gt_mpi_gather); its combine-throughput north star is QUERY-side.
    # The warm text run IS the full query pipeline — store->block,
    # device combine, and VCF text render — on a store-resident
    # workspace, so it is the apples-to-apples end-to-end figure.
    # Import cost is reported alongside (and benched in `import`).
    return {
        "samples": n_samples,
        "records": int(len(blk.starts)),
        "positions": int(region_len),
        "import_s": t_import,
        "block_build_s": t_block,
        "device_s": t_device,
        "compile_s": t_compile_run - t_device,
        "end_to_end_positions_per_sec": region_len / t_text,
        "with_import_positions_per_sec": region_len / (
            t_import + t_text),
        "vcf_text_records": n_lines,
        "vcf_text_cold_s": t_text_cold,
        "vcf_text_s": t_text,
        "vcf_text_positions_per_sec": region_len / t_text,
    }


def _device_line():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _rounded(d: dict, nd=2) -> dict:
    return {k: round(v, nd) if isinstance(v, float) else v
            for k, v in d.items()}


def _bench_impl():
    """In-process device lanes (run in a child of main)."""
    import jax
    device = _device_line()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench: no GPU, JAX runs on {device['platform']}")
    peak = peak_bytes_per_s(jax.devices()[0])
    dev = bench_device()
    dev["hbm_share"] = dev["bytes_per_sec"] / peak
    # production cohort width: 1024 samples
    wide = bench_device(num_samples=1024, cells_per_sample=256,
                        region_len=32768, reps=3)
    wide["hbm_share"] = wide["bytes_per_sec"] / peak
    dense = bench_device_dense()
    oracle = bench_oracle()
    cpp = bench_cpp_baseline()
    imp = bench_import()
    e2e = bench_cohort_end_to_end()
    print(json.dumps({
        "device": device,
        "device_combine": _rounded(dev, 6),
        "device_combine_1024_samples": _rounded(wide, 6),
        "device_dense_pregathered": _rounded(dense),
        "oracle_positions_per_sec": round(oracle["positions_per_sec"], 1),
        "cpp_sequential_baseline": _rounded(cpp or {}, 1),
        "import": _rounded(imp, 1),
        "cohort100_end_to_end": _rounded(e2e),
    }))


def main():
    """Child lanes first (each its own process, the card to itself),
    then the in-process device lanes in one more child; one JSON line."""
    import subprocess
    if os.environ.get("GENOMICSDB_TPU_BENCH_CHILD"):
        return _bench_impl()
    from genomicsdb_tpu.runtime.device_env import visible_cards
    if not visible_cards():
        raise SystemExit("bench: no GPU visible")
    lanes = {}
    for name, fn in (("out_of_core", bench_out_of_core),
                     ("wide_cohort_1000", bench_wide_cohort),
                     ("process_scaling", bench_process_scaling),
                     ("stream_latency", bench_stream_latency)):
        lanes[name] = fn()
    env = dict(os.environ, GENOMICSDB_TPU_BENCH_CHILD="1")
    r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                       capture_output=True, text=True, env=env)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:] + "\n")
        raise SystemExit(1)
    detail = json.loads(r.stdout.strip().splitlines()[-1])
    device = detail.pop("device")
    detail.update({k: _rounded(v) if isinstance(v, dict) else v
                   for k, v in lanes.items()})
    value = detail["device_combine"]["positions_per_sec"]
    cpp = detail["cpp_sequential_baseline"]
    base = cpp.get("positions_per_sec") or \
        detail["oracle_positions_per_sec"]
    mt = cpp.get("mt_positions_per_sec")
    print(json.dumps({
        "metric": "combine_positions_per_sec_per_device",
        "value": round(value, 1),
        "unit": "positions/sec",
        "vs_baseline": round(value / base, 2),
        "vs_baseline_mt": round(value / mt, 2) if mt else None,
        "device": device,
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
