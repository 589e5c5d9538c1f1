"""scripts/epoch_time_torch.py on the CPU at a tiny size: both arms of the
training CLI (-conv_impl xla and pair) on a tiny split tree, each printing
its line and its JSON row, and a refusal without EPOCH_DATA."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL_FLAGS = ["-device", "cpu", "-filters", "4", "-model_depth", "2", "-group_norm_groups", "2"]


def _run(args, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "EPOCH_DATA"}
    env.update({"OMP_NUM_THREADS": "2", **(extra_env or {})})
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def _json_lines(out):
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def split_tree(tmp_path_factory):
    """A tiny augmented tree (tests/test_torch_cli.py's aug_data layout)."""
    root = tmp_path_factory.mktemp("aug")
    rng = np.random.default_rng(0)
    for split, n, with_targets in [("train", 3, True), ("val", 1, True), ("test", 1, False)]:
        d = root / split
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir()
        if with_targets:
            (d / "targets").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32)).astype(np.uint8)).save(
                d / "images" / f"{i}_image.png")
            Image.fromarray(np.full((32, 32), 255, np.uint8)).save(d / "masks" / f"{i}_mask.png")
            if with_targets:
                Image.fromarray(((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8)).save(
                    d / "targets" / f"{i}_target.png")
    return str(root)


def test_epoch_time_runs_both_arms(split_tree):
    out = _run(["scripts/epoch_time_torch.py", "1", *SMALL_FLAGS], {"EPOCH_DATA": split_tree})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[epoch_time] arm=xla total=" in out.stdout
    assert "[epoch_time] arm=pair total=" in out.stdout
    rows = _json_lines(out)
    assert [r["arm"] for r in rows] == ["xla", "pair"]
    for row in rows:
        assert row["epochs"] == 1 and len(row["epoch_s"]) == 1
        assert row["s_per_epoch_after_first"] is None
        assert np.isfinite(row["final_train_loss"]) and row["total_s"] > row["epoch_s"][0] > 0
        assert row["card"] is None and row["launches"] == {}


@pytest.mark.parametrize("data", [None, "no/such/tree"], ids=["unset", "missing"])
def test_epoch_time_needs_epoch_data(data):
    out = _run(["scripts/epoch_time_torch.py", "1", *SMALL_FLAGS],
               {} if data is None else {"EPOCH_DATA": data})
    assert out.returncode != 0
    assert "EPOCH_DATA" in out.stderr
    assert _json_lines(out) == []
