"""Examples stay runnable: compile-check all, then subprocess-run every
one end-to-end at TRT_EXAMPLE_SIZE=64."""

import os
import py_compile
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    os.path.join(ROOT, "examples", f)
    for f in os.listdir(os.path.join(ROOT, "examples"))
    if f.endswith(".py")
)


def test_all_examples_compile():
    assert len(EXAMPLES) >= 6
    for f in EXAMPLES:
        py_compile.compile(f, doraise=True)


@pytest.mark.parametrize(
    "name", [os.path.basename(f) for f in EXAMPLES]
)
def test_example_runs(name):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["TRT_EXAMPLE_SIZE"] = "64"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name)],
        capture_output=True, text=True, timeout=840, env=env, cwd=ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "/tmp/example" in r.stdout
