"""chip_smoke.py's phases at a tiny size on the CPU: every output byte
for byte equal to the sequential engine, plus the seeded generators and
the refusal to run without a GPU."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import chip_smoke as smoke
from genomicsdb_tpu.tools import synth_cohort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke_wide"))
    return work, smoke.make_cohort(work, "wide", 12, 300, seed=4)


def test_phase_wide_tiny(wide):
    work, c = wide
    platforms = set()
    r = smoke.phase_wide(work, c, n_windows=2, seed=4, platforms=platforms)
    assert r["lines"] == 300 and r["windows"] == 2
    assert platforms == {"cpu"}


def test_phase_hard_tiny(tmp_path):
    work = str(tmp_path)
    # 16 two-sample batches: the hotspot merges 64 ALTs and splices
    c = smoke.make_cohort(work, "hard", 32, 400, seed=4, batch=2)
    platforms = set()
    r = smoke.phase_hard(work, c, platforms)
    assert r["spliced_records"] >= 1 and r["merged_alleles"] > 4
    assert r["mixed_ploidy"] and r["spanning_deletions"]
    assert platforms == {"cpu"}


def test_phase_serving_tiny(wide):
    work, c = wide
    r = smoke.phase_serving(work, c, n_queries=2, seed=4, width=3000)
    assert r["queries"] == 2


def test_phase_ranks_tiny(wide):
    work, c = wide
    spawned = smoke.phase_ranks_spawn(work, c)
    # a record spanning the partition boundary renders in both ranks
    assert smoke.phase_ranks_check(work, c, spawned)["lines"] >= 300


def test_phase_mesh_on_virtual_devices(wide):
    """The four-card phase on four of the suite's virtual CPU devices."""
    import jax
    assert len(jax.devices()) >= 4
    work, c = wide
    r = smoke.phase_mesh(work, c, n_windows=1, seed=4)
    assert r["lines"] == 300


NO_GPU_SCRIPT = """
import sys
sys.path.insert(0, %(repo)r)
import chip_smoke as smoke
smoke.WORK = %(work)r
smoke.card_info = lambda: "stub card, 700.00 W"
smoke.build_native = lambda: True
smoke.gpu_lane = lambda: "stub lane"
smoke.make_cohort = lambda *a, **k: {"gen_s": 0.0, "import_s": 0.0}
smoke.phase_ranks_spawn = lambda *a: ""
sys.exit(smoke.main([]))
"""


def test_main_fails_without_gpu(tmp_path):
    """main() with the card-only steps stubbed reaches its own platform
    check on a CPU-only JAX and refuses to print a result."""
    script = NO_GPU_SCRIPT % {"repo": REPO, "work": str(tmp_path / "w")}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    assert "no GPU: JAX runs on cpu" in r.stderr
    assert '"ok": true' not in r.stdout


def test_main_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _write(kind, out_dir, seed):
    os.makedirs(out_dir, exist_ok=True)
    if kind == "wide":
        path = os.path.join(out_dir, "wide.vcf")
        samples, _ = synth_cohort.write_wide_cohort(path, 6, 70, seed)
        return [(path, samples)]
    files, _ = synth_cohort.write_hard_cohort(out_dir, 12, 200, seed,
                                              batch=4)
    return files


def _digest(files):
    import hashlib
    h = hashlib.sha256()
    for path, _ in files:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("kind", ["wide", "hard"])
def test_cohort_is_deterministic(kind, tmp_path):
    a = _digest(_write(kind, str(tmp_path / "a"), 7))
    b = _digest(_write(kind, str(tmp_path / "b"), 7))
    c = _digest(_write(kind, str(tmp_path / "c"), 8))
    assert a == b != c


@pytest.mark.parametrize("kind", ["wide", "hard"])
def test_vid_covers_generated_fields(kind, tmp_path):
    files = _write(kind, str(tmp_path), 1)
    vid_path, cs_path = synth_cohort.write_mappings(str(tmp_path), files)
    with open(vid_path) as f:
        fields = json.load(f)["fields"]
    declared = set()
    for path, _ in files:
        with open(path) as f:
            for line in f:
                if not line.startswith("##"):
                    break
                m = re.match(r"##(INFO|FORMAT|FILTER)=<ID=([^,>]+)", line)
                if m:
                    declared.add(m.group(2))
    assert declared and declared <= set(fields)
    vid = synth_cohort.load_vid(vid_path, cs_path)
    assert len(vid.callsets) == sum(len(s) for _, s in files)
