"""Persistent pre-forked rank pool == spawned per-rank gdb_query,
byte-identical (parallel/rank_pool.py; the reference's MPI
rank-per-partition model, gt_mpi_gather.cc:166-295, served by warm
daemons instead of per-job launches)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, os, sys, tempfile
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
sys.path.insert(0, %(repo)r)
td = tempfile.mkdtemp()
ref = "/root/reference/tests"
query = os.path.join(td, "q.json")
json.dump({
    "workspace": "", "array_name": "",
    "vid_mapping_file": f"{ref}/inputs/vid.json",
    "callset_mapping_file": f"{ref}/inputs/callsets/t0_1_2.json",
    "vcf_header_filename": [f"{ref}/inputs/template_vcf_header.vcf"],
    "reference_genome": f"{ref}/inputs/chr1_10MB.fasta.gz",
    "attributes": [], "scan_full": True,
    "query_row_ranges": [{"range_list": [{"low": 0, "high": 3}]}],
}, open(query, "w"))
base = ["-j", query, "--produce-Broad-GVCF", "--platform", "cpu"]

# fork the pool BEFORE any XLA client exists in this process
from genomicsdb_tpu.parallel.rank_pool import RankPool
with RankPool(2, pin_cores=False) as pool:
    outs1 = pool.run([base, base + ["--no-vcf-header"]])
    outs2 = pool.run([base, base + ["--no-vcf-header"]])   # warm reuse
assert outs1 == outs2, "pool output not stable across reuse"

# reference: the in-process single-rank path
from genomicsdb_tpu.tools.gdb_query import rank_output
want0 = rank_output(base)
want1 = rank_output(base + ["--no-vcf-header"])
assert outs1[0] == want0, "rank0 differs"
assert outs1[1] == want1, "rank1 differs"
print("POOL-OK", len(outs1[0]), len(outs1[1]))
"""


def test_rank_pool_matches_in_process():
    if not hasattr(os, "fork"):
        pytest.skip("no fork")
    r = subprocess.run([sys.executable, "-c", SCRIPT % {"repo": REPO}],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "POOL-OK" in r.stdout


def test_rank_pool_error_propagates():
    if not hasattr(os, "fork"):
        pytest.skip("no fork")
    script = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, %(repo)r)
from genomicsdb_tpu.parallel.rank_pool import RankPool
with RankPool(1, pin_cores=False) as pool:
    try:
        pool.run([["-j", "/nonexistent.json", "--produce-Broad-GVCF",
                   "--platform", "cpu"]])
    except RuntimeError as e:
        assert "rank worker 0" in str(e)
        print("ERR-OK")
""" % {"repo": REPO}
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ERR-OK" in r.stdout
