"""Real 2-process jax.distributed run of the multihost driver
(the reference's MPI-rank model over DCN)."""

import os
import subprocess
import sys

WORKER = r"""
import os, sys
pid = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "/root/repo"); sys.path.insert(0, "/root/repo/tests")
import jax
from genomicsdb_tpu.parallel import multihost
multihost.initialize(coordinator="localhost:%PORT%", num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2
parts = multihost.my_partitions(4)
# each "rank query" returns a tagged blob; process 0 must see all four
# partitions' blobs in partition order
out = multihost.run_partitioned_query(
    lambda p: f"[p{p}:host{pid}]".encode(), parts)
if pid == 0:
    assert out == b"[p0:host0][p1:host0][p2:host1][p3:host1]", out
    print("GATHER_OK", out.decode())
else:
    assert out is None
"""


def test_two_process_partitioned_gather(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER.replace("%PORT%", str(port)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
    assert any("GATHER_OK" in out for _, out, _ in outs)


REAL_WORKER = r"""
import os, sys
pid = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "/root/repo"); sys.path.insert(0, "/root/repo/tests")
import jax
from golden_utils import REF_TESTS, VCF_ATTRIBUTES_ORDER, make_query_params
from genomicsdb_tpu.core.vid import VidMapper
from genomicsdb_tpu.parallel import multihost
from genomicsdb_tpu.query import driver
from genomicsdb_tpu.store.import_pipeline import import_callsets
import os.path as osp
multihost.initialize(coordinator="localhost:%PORT%", num_processes=2,
                     process_id=pid)
# boundary at column 12277 = the start of the golden's third record, so
# the stitched 2-partition output must be BYTE-IDENTICAL to the
# single-scan golden records
BOUNDS = [(0, 12276), (12277, None)]

def run_rank(p):
    vid = VidMapper.from_files(
        osp.join(REF_TESTS, "inputs/vid.json"),
        osp.join(REF_TESTS, "inputs/callsets/t0_1_2.json"))
    store = import_callsets(vid, column_partition=BOUNDS[p])
    lo, hi = BOUNDS[p]
    qp = make_query_params(VCF_ATTRIBUTES_ORDER,
                           [(lo, hi if hi is not None else 1000000000)])
    qc = driver.make_query_config(qp, vid)
    return driver.run_vcf_query(
        store, qc, qp, vid,
        reference_path=osp.join(REF_TESTS,
                                "inputs/chr1_10MB.fasta.gz")).encode()

parts = multihost.my_partitions(2)
out = multihost.run_partitioned_query(run_rank, parts)
if pid == 0:
    # stitched per-partition records must equal the golden byte-exactly
    text = out.decode()
    with open(osp.join(REF_TESTS, "golden_outputs/t0_1_2_vcf_at_0")) as f:
        golden_records = "".join(l for l in f
                                 if not l.startswith("#"))
    assert text == golden_records, (text[:400], golden_records[:400])
    print("REAL_GATHER_OK golden-exact")
"""


def test_two_process_real_partition_query(tmp_path):
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker2.py"
    script.write_text(REAL_WORKER.replace("%PORT%", str(port)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
    assert any("REAL_GATHER_OK" in out for _, out, _ in outs)
