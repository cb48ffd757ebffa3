"""The examples/ demos run end-to-end (reference example/ programs)."""

import os
import subprocess
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


@pytest.mark.parametrize("script,needle", [
    ("streaming_import_demo.py", "first combined records"),
    ("query_stream_demo.py", "interval 1:12000-13000"),
    ("block_engine_demo.py", "block engine"),
    ("sharded_combine_demo.py", "mesh=(4 pos x 2 row)"),
])
def test_example_runs(script, needle):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(EXAMPLES, script)],
                       capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert needle in r.stdout, r.stdout
