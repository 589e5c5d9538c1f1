"""The benchmark loads nothing of JAX or of the JAX package, its reference
nothing of the program, and it reads no file of the repository outside its
own folder; a run without a card, or without the program, prints no
result."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
FILES = sorted((REPO / "benchmark").rglob("*.py"))


def imported(path: Path) -> set:
    """The top-level names of the modules a file imports (the part before the
    first dot, compared whole)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "unet_research_tpu"}


@pytest.mark.parametrize("path", sorted((REPO / "benchmark" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "unet_research_tpu_torch" not in imported(path)
    assert "unet_research_tpu" not in path.read_text().replace("unet_research_tpu_torch", "")


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_reads_no_outside_script(path):
    text = path.read_text()
    for name in ("bench_gpu", "chip_smoke", "scripts/", "scripts."):
        assert name not in text, name


def test_forbidden_compares_whole_top_level_names():
    loaded = ["unet_research_tpu_torch", "unet_research_tpu_torch.models", "jaxtyping",
              "flaxy", "jax.numpy", "unet_research_tpu.models", "flax"]
    assert harness.forbidden(loaded) == ["flax", "jax.numpy", "unet_research_tpu.models"]


def _run(root: Path, *extra) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mc_drive_1000",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=root,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and benchmark/."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    done = _run(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _run(REPO)
    assert done.returncode == 2 and done.stdout.strip() == ""
