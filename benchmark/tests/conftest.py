"""Fixtures of the harness's CPU tests: a checkout-like root that holds a copy
of benchmark/ and of BENCHMARK.json, with every configuration and traffic
mix cut to a few pixels and float32, so that a whole run (set-up, window,
check) takes seconds on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def shrink(root: Path) -> None:
    """Cut root's configurations and traffic mixes to CPU size in place."""
    for path in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(filters=8, model_depth=2, group_norm_groups=4, dtype="float32")
        if "ramp" in cfg:
            cfg["ramp"]["steps"] = 3  # the masks drop from the second step on
        path.write_text(json.dumps(cfg))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(height=20, width=18)
        if t["kind"] == "ensemble":
            t.update(frames=2, members=20, chunk=8, reference_rows=8)
        else:
            t.update(frames=4 * t["batch"], profile_steps=2)
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shrink(root)
    return root
