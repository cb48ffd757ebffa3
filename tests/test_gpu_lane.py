"""GPU lane: checks that only a card can make, each run in a child
process on the GPU while the pytest process stays on the CPU.

    pytest -m gpu tests/test_gpu_lane.py      # on a machine with a card

Elsewhere every test skips; whether a card is present is decided in the
`gpu_env` fixture.  chip_smoke.py runs this lane before it opens JAX
itself, so one process holds the card at a time.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_env():
    """Environment for a child that runs on the card; skips when this
    machine has none."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    return env


def _run_child(env, check: str, timeout=900):
    r = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {os.path.dirname(__file__)!r}); "
         f"import test_gpu_lane as t; t.{check}()"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert f"{check}: ok" in r.stdout, r.stdout[-2000:]


def _gpu():
    import jax
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    assert gpus, f"no gpu device: {jax.devices()}"
    return gpus


# ---- checks (run in the child) ----

def check_combine_step_vs_cpu():
    """combine_step on the card == the same call on the CPU backend,
    array for array, NaN positions equal — across the float median and
    the ordered float sum (S > 64 takes the fori_loop), mixed ploidy and
    the row-restricted forms."""
    import jax
    from genomicsdb_tpu.ops.combine_step import (block_to_args,
                                                 combine_step,
                                                 synthesize_cohort)
    gpu, cpu = _gpu()[0], jax.devices("cpu")[0]
    for S, ploidy, mixed in ((128, 2, False), (40, 3, True),
                             (96, 2, True)):
        blk = synthesize_cohort(num_samples=S, cells_per_sample=128,
                                region_len=16384, seed=S, ploidy=ploidy)
        if mixed:
            rng = np.random.default_rng(1)
            blk.gt_len_bs = rng.integers(
                1, ploidy + 1, size=blk.live.shape).astype(np.int32)
        B = blk.live.shape[0]
        rows = np.arange(0, B, 3, dtype=np.int32)
        for kw in ({}, {"med_rows": rows}, {"remap_rows": rows}):
            outs = []
            for dev in (gpu, cpu):
                args = jax.device_put(block_to_args(blk), dev)
                kdev = jax.device_put(kw, dev)
                out = combine_step(*args, **kdev, max_merged=4,
                                   ploidy=ploidy, mixed_ploidy=mixed)
                platforms = {d.platform for v in out.values()
                             for d in v.devices()}
                assert platforms == {dev.platform}, platforms
                outs.append({k: np.asarray(v) for k, v in out.items()})
            g, c = outs
            assert g.keys() == c.keys()
            for k in g:
                a, b = g[k], c[k]
                assert a.shape == b.shape and a.dtype == b.dtype, k
                if a.dtype.kind == "f":
                    np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                                  err_msg=k)
                    a, b = np.nan_to_num(a), np.nan_to_num(b)
                np.testing.assert_array_equal(a, b, err_msg=f"{k} {kw}")
    print("check_combine_step_vs_cpu: ok")


def _hard_cohort(tmp):
    from genomicsdb_tpu.store.import_pipeline import import_callsets
    from genomicsdb_tpu.tools import synth_cohort
    files, _ = synth_cohort.write_hard_cohort(tmp, 56, 1500, seed=3,
                                              batch=4)
    vid = synth_cohort.load_vid(*synth_cohort.write_mappings(tmp, files))
    return import_callsets(vid), vid


def _full_query(vid):
    from genomicsdb_tpu.core.config import QueryParams
    from genomicsdb_tpu.query import driver
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    return qp, driver.make_query_config(qp, vid)


def check_block_query_hard_cohort():
    """Block query on the hard cohort (mixed ploidy, allele growth,
    spanning deletions, a spliced record) == the sequential engine."""
    import tempfile
    from genomicsdb_tpu.query import driver
    _gpu()
    with tempfile.TemporaryDirectory() as tmp:
        store, vid = _hard_cohort(tmp)
    qp, qc = _full_query(vid)
    seq = driver.run_vcf_query(store, qc, qp, vid)
    qp, qc = _full_query(vid)
    blk = driver.run_vcf_query_block(store, qc, qp, vid)
    assert blk == seq, "block != sequential on the card"
    print("check_block_query_hard_cohort: ok")


def check_mesh_all_cards():
    """Mesh block query over every visible card == one-device output."""
    import tempfile
    from genomicsdb_tpu.parallel.sharded import make_mesh
    from genomicsdb_tpu.query import driver
    gpus = _gpu()
    n = len(gpus)
    shapes = {(n, 1), (1, n)} | ({(n // 2, 2)} if n % 2 == 0 else set())
    with tempfile.TemporaryDirectory() as tmp:
        store, vid = _hard_cohort(tmp)
    qp, qc = _full_query(vid)
    one = driver.run_vcf_query_block(store, qc, qp, vid)
    for n_pos, n_row in sorted(shapes):
        qp, qc = _full_query(vid)
        got = driver.run_vcf_query_block(
            store, qc, qp, vid, mesh=make_mesh(n_pos, n_row, gpus))
        assert got == one, f"mesh {n_pos}x{n_row} != one device"
    print("check_mesh_all_cards: ok")


# ---- tests (pytest process, CPU) ----

def test_combine_step_gpu_equals_cpu(gpu_env):
    _run_child(gpu_env, "check_combine_step_vs_cpu")


def test_block_query_hard_cohort_on_gpu(gpu_env):
    _run_child(gpu_env, "check_block_query_hard_cohort")


def test_mesh_block_query_all_cards(gpu_env):
    _run_child(gpu_env, "check_mesh_all_cards")
