#!/usr/bin/env python
"""Smoke run of the whole system on an NVIDIA GPU.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # mesh 4x1 and 2x2 on four cards

Drives the entry points a user calls — `tools/vcf2gdb.py` (import),
`tools/gdb_query.py --produce-Broad-GVCF` (block engine) and
`query/stream_server.py` (BCF2 socket) — on cohorts generated from
`--seed`, and checks every output byte for byte against the sequential
engine, the repo's plain reference.  Phases:

  1. set-up: the card's name and power limit (nvidia-smi, before JAX
     opens the card), the native library built from the committed
     sources, the gpu-marked test lane (tests/test_gpu_lane.py) in a
     child process;
  2. wide cohort (1,000 samples x 20,000 records, joint-calling shape):
     import, cold and warm full-region combine, sampled 3 kb windows
     against the sequential engine, chunk invariance, peak device
     memory, and the device combine step's time and byte rate;
  3. hard cohort (256 samples x ~5,000 records): mixed ploidy, allele
     growth past four, spanning deletions and a spliced record — the
     whole output byte-identical to the sequential engine;
  4. serving: interval queries over the BCF2 socket against gdb_query;
  5. ranks: `gdb_query --num-ranks 2 --parallel-ranks` (one child per
     rank, each with its share of the card) against the in-process run;
  6. the combine outputs of phases 2-3 live on a `gpu` device.

Phase 5's children and the test lane run before this process opens
JAX, so one process holds the card at a time.  Any failure exits
non-zero; the last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

# the sizes of the run (the CPU tests call the phases at tiny sizes)
WIDE_SAMPLES, WIDE_RECORDS = 1000, 20_000
HARD_SAMPLES, HARD_RECORDS = 256, 5000
WINDOWS = 4            # sampled 3 kb windows against the sequential engine
QUERIES = 8            # 10 kb socket queries


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    """`name, power.limit` of the card(s), read by nvidia-smi in a child
    so no JAX process holds the card yet."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def build_native() -> bool:
    """Rebuild the native library from the committed sources (never
    trust a .so left in the tree) and load it."""
    subprocess.run(["make", "-B", "-C",
                    os.path.join(REPO, "genomicsdb_tpu", "runtime",
                                 "native")],
                   check=True, capture_output=True, timeout=600)
    from genomicsdb_tpu.runtime import native_loader
    return native_loader.get_lib() is not None


def gpu_lane() -> str:
    """tests/test_gpu_lane.py in a child: every test must pass, none
    may skip."""
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu", "-q",
                        "-p", "no:cacheprovider",
                        os.path.join("tests", "test_gpu_lane.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=900)
    tail = (r.stdout.strip().splitlines() or [""])[-1]
    if r.returncode != 0 or "skipped" in tail or "passed" not in tail:
        raise RuntimeError(f"gpu lane failed:\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-2000:]}")
    return tail


# ---------------------------------------------------------------- entry points

def vcf2gdb_import(work: str, name: str, vid_path: str,
                   cs_path: str) -> str:
    """Import through tools/vcf2gdb into workspace `work/ws_<name>`."""
    from genomicsdb_tpu.tools import vcf2gdb
    wsp = os.path.join(work, f"ws_{name}")
    loader = os.path.join(work, f"loader_{name}.json")
    with open(loader, "w") as f:
        json.dump({"vid_mapping_file": vid_path,
                   "callset_mapping_file": cs_path,
                   "produce_tiledb_array": True,
                   "column_partitions": [{"begin": 0, "workspace": wsp,
                                          "array_name": name}]}, f)
    vcf2gdb.main([loader])
    return wsp


def query_doc(c: dict, ranges=None) -> dict:
    """gdb_query / stream-server JSON for cohort `c`; `ranges` is one
    [(lo, hi)] list per rank, None for the full region."""
    doc = {"workspace": c["workspace"], "array_name": c["array"],
           "vid_mapping_file": c["vid"],
           "callset_mapping_file": c["callsets"], "attributes": []}
    if ranges is None:
        doc["scan_full"] = True
    else:
        doc["query_column_ranges"] = [
            {"range_list": [{"low": lo, "high": hi} for lo, hi in rank]}
            for rank in ranges]
    return doc


def gdb_query(work: str, doc: dict, *extra: str) -> str:
    """tools/gdb_query main, in this process; returns its stdout."""
    from genomicsdb_tpu.tools import gdb_query as gq
    path = os.path.join(work, "query.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gq.main(["-j", path, "--produce-Broad-GVCF", *extra])
    return buf.getvalue()


def make_cohort(work: str, kind: str, n_samples: int, n_records: int,
                seed: int, batch: int = 16) -> dict:
    from genomicsdb_tpu.tools import synth_cohort as sc
    d = os.path.join(work, kind)
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    if kind == "wide":
        vcf = os.path.join(d, "wide.vcf")
        samples, region = sc.write_wide_cohort(vcf, n_samples, n_records,
                                               seed)
        files = [(vcf, samples)]
    else:
        files, region = sc.write_hard_cohort(d, n_samples, n_records,
                                             seed, batch=batch)
    gen_s = time.perf_counter() - t0
    vid_p, cs_p = sc.write_mappings(d, files)
    t0 = time.perf_counter()
    wsp = vcf2gdb_import(work, kind, vid_p, cs_p)
    return {"kind": kind, "workspace": wsp, "array": kind, "vid": vid_p,
            "callsets": cs_p, "region": region, "samples": n_samples,
            "gen_s": gen_s, "import_s": time.perf_counter() - t0}


def open_cohort(c: dict):
    """(store, vid) of an imported cohort."""
    from genomicsdb_tpu.core.vid import VidMapper
    from genomicsdb_tpu.store import workspace as ws
    return (ws.open_array(c["workspace"], c["array"]),
            VidMapper.from_files(c["vid"], c["callsets"]))


def region_query(vid, lo=None, hi=None):
    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.query import driver
    qp = QueryParams()
    qp.attributes = []
    if lo is None:
        qp.scan_full = True
    else:
        qp.column_ranges = [[(lo, hi)]]
    return qp, driver.make_query_config(qp, vid)


@contextlib.contextmanager
def record_combine_platforms(platforms: set):
    """Collect the platform of every combine_step output the block
    writer produces inside the block."""
    from genomicsdb_tpu.query import block_writer
    real = block_writer.combine_step

    def spy(*a, **kw):
        out = real(*a, **kw)
        for v in out.values():
            platforms.update(d.platform for d in v.devices())
        return out
    block_writer.combine_step = spy
    try:
        yield
    finally:
        block_writer.combine_step = real


@contextlib.contextmanager
def serving_index(enabled: bool):
    old = os.environ.get("GENOMICSDB_TPU_SERVING_INDEX")
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "1" if enabled else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["GENOMICSDB_TPU_SERVING_INDEX"]
        else:
            os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = old


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# ---------------------------------------------------------------- phases

def phase_wide(work: str, c: dict, n_windows: int, seed: int,
               platforms: set) -> dict:
    """Full-region combine cold and warm through gdb_query, chunk
    invariance, and sampled windows against the sequential engine.
    The timed text depends on every combine output, so its wall time
    includes the device work and the fetch."""
    from genomicsdb_tpu.query import driver
    out = {}
    with serving_index(False), record_combine_platforms(platforms):
        t0 = time.perf_counter()
        text = gdb_query(work, query_doc(c))
        out["cold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = gdb_query(work, query_doc(c))
        out["warm_s"] = time.perf_counter() - t0
        if warm != text:
            raise AssertionError("warm run differs from cold run")
        store, vid = open_cohort(c)
        qp, qc = region_query(vid)
        rechunked = driver.run_vcf_query_block(store, qc, qp, vid,
                                               max_records_per_block=512)
        if rechunked != text:
            raise AssertionError("max_records_per_block=512 changed the "
                                 "output")
        rng = random.Random(seed)
        for _ in range(n_windows):
            lo = rng.randint(1, max(c["region"] - 4000, 2))
            qp, qc = region_query(vid, lo, lo + 3000)
            seq = driver.run_vcf_query(store, qc, qp, vid)
            blk = gdb_query(work, query_doc(c, [[(lo, lo + 3000)]]))
            if blk != seq:
                raise AssertionError(f"window {lo}: block != sequential")
    out.update(lines=text.count("\n"), sha=sha(text), windows=n_windows,
               cells=int(store.num_cells))
    return out


def phase_hard(work: str, c: dict, platforms: set) -> dict:
    """Whole hard-cohort output: block engine == sequential engine, and
    the block really took the mixed-ploidy, allele-growth and splice
    branches."""
    from genomicsdb_tpu.ops.store_block import store_to_block
    store, vid = open_cohort(c)
    qp, qc = region_query(vid)
    blk, meta = store_to_block(store, qc, interval=(0, c["region"]),
                               return_meta=True)
    gt_w = blk.gt.shape[2]
    branches = {
        "mixed_ploidy": bool(blk.gt_len_bs is not None and (
            (blk.gt_len_bs != gt_w) & (blk.live >= 0)).any()),
        "merged_alleles": int(blk.inv_bs.shape[2]),
        "spliced_records": int(meta.needs_fallback.sum()),
        "spanning_deletions": int(meta.has_deletion.sum()),
    }
    if not branches["mixed_ploidy"] or branches["merged_alleles"] <= 4 \
            or not branches["spanning_deletions"] \
            or not branches["spliced_records"]:
        raise AssertionError(f"hard cohort misses a branch: {branches}")
    with serving_index(False), record_combine_platforms(platforms):
        t0 = time.perf_counter()
        block = gdb_query(work, query_doc(c))
        block_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = gdb_query(work, query_doc(c), "--engine", "sequential")
    seq_s = time.perf_counter() - t0
    if block != seq:
        raise AssertionError("hard cohort: block != sequential")
    return dict(branches, lines=block.count("\n"), block_s=block_s,
                sequential_s=seq_s)


def phase_serving(work: str, c: dict, n_queries: int, seed: int,
                  width: int = 10_000) -> dict:
    """QueryStreamServer in this process; each socket answer (BCF2,
    decoded) equals gdb_query's records for the same interval."""
    from genomicsdb_tpu.query.stream_server import (QueryStreamServer,
                                                    read_query_stream)
    from genomicsdb_tpu.vcf import bcf
    srv = QueryStreamServer(port=0)
    srv.start_background()
    rng = random.Random(seed + 1)
    lats = []
    try:
        host, port = srv.address
        for _ in range(n_queries):
            lo = rng.randint(1, max(c["region"] - width - 1, 2))
            doc = query_doc(c, [[(lo, lo + width)]])
            t0 = time.perf_counter()
            data = read_query_stream(host, port, doc, timeout=600)
            lats.append(time.perf_counter() - t0)
            got = [ln for ln in bcf.bcf_to_text(data).splitlines()
                   if ln and not ln.startswith("#")]
            want = [ln for ln in gdb_query(work, doc).splitlines()
                    if ln and not ln.startswith("#")]
            if got != want:
                raise AssertionError(f"socket answer for [{lo}, "
                                     f"{lo + width}] != gdb_query")
    finally:
        srv.shutdown()
    lats.sort()
    return {"queries": n_queries, "socket_p50_ms":
            lats[len(lats) // 2] * 1e3, "socket_max_ms": lats[-1] * 1e3}


def rank_ranges(c: dict):
    mid = c["region"] // 2
    return [[(0, mid)], [(mid + 1, c["region"] + 1)]]


def phase_ranks_spawn(work: str, c: dict) -> str:
    """gdb_query --num-ranks 2 --parallel-ranks as a child: the root
    stays off the device, each rank worker gets its memory share."""
    path = os.path.join(work, "ranks.json")
    with open(path, "w") as f:
        json.dump(query_doc(c, rank_ranges(c)), f)
    r = subprocess.run([sys.executable, "-m",
                        "genomicsdb_tpu.tools.gdb_query", "-j", path,
                        "--produce-Broad-GVCF", "--num-ranks", "2",
                        "--parallel-ranks"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"--parallel-ranks failed: {r.stderr[-3000:]}")
    return r.stdout


def phase_ranks_check(work: str, c: dict, spawned: str) -> dict:
    inproc = gdb_query(work, query_doc(c, rank_ranges(c)),
                       "--num-ranks", "2")
    if spawned != inproc:
        raise AssertionError("--parallel-ranks output != in-process "
                             "--num-ranks 2 output")
    return {"lines": inproc.count("\n")}


def phase_mesh(work: str, c: dict, n_windows: int, seed: int) -> dict:
    """The wide cohort through gdb_query --mesh 4x1 and 2x2: equal to
    the one-device block output and to the sequential engine on
    windows."""
    from genomicsdb_tpu.query import driver
    shapes = ((4, 1), (2, 2))
    with serving_index(False):
        one = gdb_query(work, query_doc(c))
        out = {}
        for n_pos, n_row in shapes:
            t0 = time.perf_counter()
            got = gdb_query(work, query_doc(c), "--mesh",
                            f"{n_pos}x{n_row}")
            out[f"{n_pos}x{n_row}_s"] = time.perf_counter() - t0
            if got != one:
                raise AssertionError(f"mesh {n_pos}x{n_row} != one device")
        store, vid = open_cohort(c)
        rng = random.Random(seed)
        for _ in range(n_windows):
            lo = rng.randint(1, max(c["region"] - 4000, 2))
            qp, qc = region_query(vid, lo, lo + 3000)
            seq = driver.run_vcf_query(store, qc, qp, vid)
            for n_pos, n_row in shapes:
                blk = gdb_query(work, query_doc(c, [[(lo, lo + 3000)]]),
                                "--mesh", f"{n_pos}x{n_row}")
                if blk != seq:
                    raise AssertionError(f"mesh {n_pos}x{n_row} window "
                                         f"{lo} != sequential")
    out.update(lines=one.count("\n"), sha=sha(one), windows=n_windows)
    return out


def measure_combine(n_samples: int, cells: int, region: int,
                    chunk: int) -> dict:
    """bench.bench_device at one shape (time + bytes/s of the device
    combine step)."""
    sys.path.insert(0, REPO)
    import bench
    return bench.bench_device(num_samples=n_samples, cells_per_sample=cells,
                              region_len=region, chunk=chunk)


# ---------------------------------------------------------------- main

def fmt(d: dict) -> str:
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in d.items()})


def run_one_card(seed: int) -> list:
    log("card (nvidia-smi name, power.limit):")
    log(card_info())
    log(f"native library built from sources and loaded: {build_native()}")
    log(f"gpu test lane: {gpu_lane()}")
    from jax._src import xla_bridge
    wide = make_cohort(WORK, "wide", WIDE_SAMPLES, WIDE_RECORDS, seed)
    log(f"wide cohort: {WIDE_SAMPLES} samples x {WIDE_RECORDS} records "
        f"generated in {wide['gen_s']:.2f} s, imported by vcf2gdb in "
        f"{wide['import_s']:.2f} s")
    if xla_bridge.backends_are_initialized():
        raise RuntimeError("JAX opened a device before the rank phase")
    from genomicsdb_tpu.runtime.device_env import rank_env
    log("phase 5 rank workers: "
        + "; ".join(str(rank_env(i, 2, base={})) for i in range(2)))
    spawned = phase_ranks_spawn(WORK, wide)

    import jax
    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform}")

    platforms: set = set()
    r = phase_wide(WORK, wide, WINDOWS, seed, platforms)
    log(f"phase 2 wide cohort ({r['cells']} cells): cold {r['cold_s']:.3f}"
        f" s (set-up + run), warm {r['warm_s']:.3f} s on the card; "
        f"{r['lines']} records; chunk-invariant; {r['windows']} 3 kb "
        f"windows byte-identical to the sequential engine")
    log(f"peak_bytes_in_use: {devs[0].memory_stats()['peak_bytes_in_use']}")
    for shape in ((128, 2048, 262144, 8192), (1024, 256, 32768, 8192),
                  (WIDE_SAMPLES, 256, 32768, 1024)):
        log(f"combine_step {shape[0]} samples x {shape[3]}-record chunk:"
            f" {fmt(measure_combine(*shape))}")
    r = phase_hard(WORK, make_cohort(WORK, "hard", HARD_SAMPLES,
                                     HARD_RECORDS, seed), platforms)
    log(f"phase 3 hard cohort: {fmt(r)}; byte-identical to the "
        f"sequential engine")
    r = phase_serving(WORK, wide, QUERIES, seed)
    log(f"phase 4 serving: {fmt(r)}; every answer equals gdb_query")
    r = phase_ranks_check(WORK, wide, spawned)
    log(f"phase 5 ranks: --parallel-ranks == in-process --num-ranks 2 "
        f"({r['lines']} records)")
    if platforms != {"gpu"}:
        raise AssertionError(f"combine outputs on {platforms}")
    log(f"phase 6: combine outputs of phases 2-3 live on {platforms}")
    return devs


def run_four_cards(seed: int) -> list:
    log("card (nvidia-smi name, power.limit):")
    log(card_info())
    log(f"native library built from sources and loaded: {build_native()}")
    wide = make_cohort(WORK, "wide", WIDE_SAMPLES, WIDE_RECORDS, seed)
    import jax
    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    if devs[0].platform != "gpu" or len(devs) < 4:
        raise RuntimeError(f"need four GPUs, JAX sees {devs}")
    r = phase_mesh(WORK, wide, WINDOWS, seed)
    log(f"mesh 4x1 and 2x2: byte-identical to one device and to the "
        f"sequential engine: {fmt(r)}")
    return devs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the mesh phase, on four cards")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "genomicsdb_tpu")):
        log("chip_smoke: run from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    from genomicsdb_tpu.runtime.device_env import init_compile_cache
    init_compile_cache()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        devs = run_four_cards(args.seed) if args.four_cards \
            else run_one_card(args.seed)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
