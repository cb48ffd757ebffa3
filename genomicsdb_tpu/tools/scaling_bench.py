"""Process-scaling benchmark: strong scaling of the combine query
across real worker PROCESSES — the reference's execution model
(one MPI rank per column partition, vcf2tiledb.cc:44-52; root gather,
gt_mpi_gather.cc:166-295).  Real multi-chip is unavailable in this
environment, so rank-per-partition process scaling is the honest
measurable stand-in for the >=80% 1->N scaling-efficiency target
(BASELINE.md).

For K in {1, 2, 4}: the genome axis is split into K equal column
partitions, each partition imported by its own vcf2gdb worker process,
then the full-genome combined-VCF query runs as K gdb_query worker
processes (`--num-ranks K --parallel-ranks`) with this process as the
root gatherer.  Outputs must be byte-identical across K.  Efficiency =
T(1) / (K * T(K)).

Worker wall time includes interpreter + jax startup and per-process XLA
compile (reported separately as `overhead_s`, measured by a no-op
worker), mirroring how mpirun-launched reference processes pay their
own startup.

Usage: python -m genomicsdb_tpu.tools.scaling_bench [--records N]
           [--samples N] [--ranks 1,2,4]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

from ..runtime.device_env import rank_env


def _write_cohort(td: str, samples: int, records: int):
    from .genome_bench import make_cohort
    from .synth_cohort import write_mappings
    vcf_path = os.path.join(td, "cohort.vcf")
    region = make_cohort(vcf_path, samples, records)
    vid_file, callset_file = write_mappings(
        td, [(vcf_path, [f"S{i}" for i in range(samples)])])
    return region, vid_file, callset_file


def _record_starts(vcf_path: str):
    starts = []
    with open(vcf_path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            starts.append(int(line.split(b"\t", 2)[1]))
    return starts


def _loader_json(td: str, k: int, starts, vid_file: str,
                 callset_file: str) -> str:
    # partition boundaries fall ON record starts (the cohort tiles the
    # axis contiguously), so no record spans a boundary and the K-rank
    # concatenation is byte-identical to the single-partition output
    ws = os.path.join(td, f"ws_{k}")
    parts = []
    for i in range(k):
        begin = starts[(len(starts) * i) // k] - 1   # 0-based column
        parts.append({"begin": begin if i else 0, "workspace": ws,
                      "array_name": f"p{i}"})
    doc = {"column_partitions": parts,
           "callset_mapping_file": callset_file,
           "vid_mapping_file": vid_file,
           "treat_deletions_as_intervals": True}
    path = os.path.join(td, f"loader_{k}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _query_json(td: str, vid_file: str, callset_file: str) -> str:
    doc = {"workspace": "", "array_name": "",
           "query_column_ranges": [
               {"range_list": [{"low": 0, "high": 2**60}]}],
           "vid_mapping_file": vid_file,
           "callset_mapping_file": callset_file,
           "attributes": []}
    path = os.path.join(td, "query.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _import_partitions(loader: str, k: int, env) -> float:
    """K concurrent vcf2gdb worker processes, one per partition (the
    reference's mpirun import)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "genomicsdb_tpu.tools.vcf2gdb", loader,
         "--rank", str(r)], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, env=rank_env(r, k, base=env))
        for r in range(k)]
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"vcf2gdb failed: "
                               f"{err.decode(errors='replace')[-400:]}")
    return time.perf_counter() - t0


def _pool_query(td: str, k: int, query: str, loader: str,
                runs: int = 2):
    """(best wall seconds, output bytes) of the full-genome query
    against a warm persistent rank pool: the first pass initializes
    each worker's XLA client + compile cache (excluded — a serving
    pool is long-lived), later passes are the measured quantity."""
    from ..parallel.rank_pool import RankPool
    argvs = []
    for r in range(k):
        argv = ["-j", query, "-l", loader, "-r", str(r),
                "--num-ranks", "1", "--produce-Broad-GVCF"]
        if r > 0:
            argv.append("--no-vcf-header")
        argvs.append(argv)
    with RankPool(k, pin_cores=True) as pool:
        pool.run(argvs)                       # warm: XLA init + compile
        best = None
        out = b""
        for _ in range(runs):
            t0 = time.perf_counter()
            pieces = pool.run(argvs)
            dt = time.perf_counter() - t0
            out = "".join(pieces).encode()
            best = dt if best is None else min(best, dt)
    return best, out


def run(samples=8, records=300_000, ranks=(1, 2, 4), warm=True):
    td = tempfile.mkdtemp(prefix="scaling_")
    env = dict(os.environ)
    env.setdefault("PYTHONPATH",
                   os.path.dirname(os.path.dirname(
                       os.path.dirname(os.path.abspath(__file__)))))
    # every worker rank is pinned to ONE core (sched_setaffinity): a
    # single rank on this 4-core host otherwise saturates every core
    # (XLA + the native pool), so K processes would only measure
    # oversubscription.  Rank-per-core is the reference's deployment
    # shape (one single-threaded-ish MPI rank per core/partition).
    # Workers share a persistent XLA compile cache so per-process
    # recompiles don't masquerade as scaling loss.
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(td, "jaxcache")
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    # this lane measures ENGINE scaling: repeated warm queries must not
    # flip to the materialized serving index (query/serving_index.py)
    env["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
    # forked rank-pool workers inherit os.environ, not `env`
    for key in ("JAX_COMPILATION_CACHE_DIR",
                "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES",
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                "GENOMICSDB_TPU_SERVING_INDEX"):
        os.environ[key] = env[key]
    ncores = os.cpu_count() or 4
    try:
        region, vid_file, callset_file = _write_cohort(
            td, samples, records)
        rec_starts = _record_starts(os.path.join(td, "cohort.vcf"))
        # per-process fixed overhead: interpreter + imports + jax init
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import genomicsdb_tpu.query.driver"],
                       check=True, env=env)
        overhead_s = time.perf_counter() - t0

        results = {}
        checks = set()
        for k in ranks:
            loader = _loader_json(td, k, rec_starts, vid_file,
                                  callset_file)
            import_s = _import_partitions(loader, k, env)
            query = _query_json(td, vid_file, callset_file)
            runs = 2 if warm else 1
            best = None
            out = b""
            for _ in range(runs):  # spawned per-job model (mpirun)
                # this process IS the root gatherer (the mpirun parent):
                # spawn one pinned gdb_query worker per rank, gather
                # stdout in rank order (gt_mpi_gather.cc:166-295)
                t0 = time.perf_counter()
                procs = []
                for r in range(k):
                    cmd = [sys.executable, "-m",
                           "genomicsdb_tpu.tools.gdb_query",
                           "-j", query, "-l", loader, "-r", str(r),
                           "--num-ranks", "1", "--rank-piece",
                           "--produce-Broad-GVCF"]
                    if r > 0:
                        cmd.append("--no-vcf-header")
                    pre = None
                    if hasattr(os, "sched_setaffinity"):
                        core = r % ncores
                        pre = (lambda c: lambda:
                               os.sched_setaffinity(0, {c}))(core)
                    procs.append(subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE,
                        env=rank_env(r, k, base=env), preexec_fn=pre))
                pieces = []
                for r, pr in enumerate(procs):
                    o, e = pr.communicate()
                    if pr.returncode != 0:
                        raise RuntimeError(
                            f"rank {r}/{k} failed: "
                            f"{e.decode(errors='replace')[-400:]}")
                    pieces.append(o)
                dt = time.perf_counter() - t0
                out = b"".join(pieces)
                best = dt if best is None else min(best, dt)
            checks.add(hashlib.sha256(out).hexdigest()[:16])
            # persistent rank-pool model (parallel/rank_pool.py): the
            # serving deployment keeps rank daemons warm, so a query
            # costs compute + gather, not per-job interpreter + XLA
            # startup.  Workers are the SAME pinned single-rank
            # gdb_query path; output must be byte-identical.
            pool_best, pool_out = _pool_query(td, k, query, loader)
            if hashlib.sha256(pool_out).hexdigest()[:16] not in checks:
                raise RuntimeError("rank-pool output differs from the "
                                   "spawned model")
            results[k] = {"import_s": round(import_s, 2),
                          "query_wall_s": round(pool_best, 2),
                          "spawn_wall_s": round(best, 2),
                          "spawn_compute_s": round(best - overhead_s,
                                                   2)}
        if len(checks) != 1:
            raise RuntimeError(f"outputs differ across rank counts: "
                               f"{checks}")
        k0 = min(ranks)
        t1 = results[k0]["query_wall_s"]
        t1s = results[k0]["spawn_wall_s"]
        t1c = results[k0]["spawn_compute_s"]
        for k in ranks:
            scale = k / k0
            results[k]["speedup"] = round(
                t1 / results[k]["query_wall_s"], 2)
            results[k]["efficiency_pct"] = round(
                100 * t1 / (scale * results[k]["query_wall_s"]), 1)
            results[k]["efficiency_spawn_pct"] = round(
                100 * t1s / (scale * results[k]["spawn_wall_s"]), 1)
            results[k]["efficiency_compute_pct"] = round(
                100 * t1c / (scale * results[k]["spawn_compute_s"]), 1)
        return {"samples": samples, "records": records,
                "positions": region, "checksum": checks.pop(),
                "proc_overhead_s": round(overhead_s, 2),
                "ranks": {str(k): results[k] for k in ranks}}
    finally:
        import shutil
        shutil.rmtree(td, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=300_000)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--cold", action="store_true",
                    help="single timed run per K (default: best of 2)")
    args = ap.parse_args(argv)
    ranks = tuple(int(x) for x in args.ranks.split(","))
    print(json.dumps(run(args.samples, args.records, ranks,
                         warm=not args.cold)))


if __name__ == "__main__":
    sys.exit(main())
