"""Shared test fixtures. NOTE: no XLA_FLAGS here — the main test session
keeps its single CPU device; multi-device tests run in subprocesses
(see distributed_run)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "distributed: spawns a multi-device subprocess (deselect with "
        "-m 'not distributed' for a fast single-device pass)")
    config.addinivalue_line(
        "markers",
        "card: runs a CUDA kernel of the port, so it needs a card and skips "
        "without one (a CUDA kernel has no CPU or interpret mode); on the "
        "card: PYTHONPATH=src python -m pytest -q -m card tests/")


@pytest.fixture(scope="session")
def tiny_shape():
    from repro.configs import ShapeConfig
    return ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")


# Every snippet gets the version-portable sharding helpers; snippets must
# never spell the version-dependent sharding API (AxisType / set_mesh /
# shard_map) via jax directly — repro.compat owns those spellings, enforced
# by test_compat.py.
_PRELUDE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
import json
import jax
import numpy as np
from repro.compat import (AxisType, NamedSharding, PartitionSpec,
                          make_mesh, use_mesh)
P = PartitionSpec
"""


def distributed_run(code: str, devices: int = 8, timeout: int = 300) -> dict:
    """Run `code` in a subprocess with N fake devices; the snippet must
    print a single json line prefixed with RESULT:."""
    prelude = textwrap.dedent(_PRELUDE.format(devices=devices))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=env)
    if proc.returncode != 0:
        # full traceback — a truncated tail used to hide the actual import
        # error behind "assert 1 == 0"
        pytest.fail(
            f"distributed subprocess exited {proc.returncode}\n"
            f"--- STDOUT ---\n{proc.stdout}\n--- STDERR ---\n{proc.stderr}",
            pytrace=False)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT:"):
            return json.loads(line[len("RESULT:"):])
    raise AssertionError(f"no RESULT line in output: {proc.stdout[-2000:]}")
