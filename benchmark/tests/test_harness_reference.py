"""The plain reference against the port's plain route on the CPU: the counter
hash bit for bit, and whole runs of every cell at a tiny size in float32,
where the two agree to rounding; the float8 control does not."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from benchmark import cells, harness
from benchmark.reference import tasks, unet as ref

REPO = Path(__file__).resolve().parents[2]
# float32 on both sides at a tiny size: the gaps are rounding (about 1e-5)
TIGHT = 1e-4


def test_hash_bits_equal_the_port():
    from unet_research_tpu_torch.ops.dropblock import hash_bits

    words = torch.tensor([0xDEADBEEF, 0x80000001])
    for shape, offset in (((2, 5, 7, 3), 0), ((3, 4, 4, 8), 5), ((1, 9, 9, 64), 1000)):
        assert torch.equal(ref.hash_bits(0xDEADBEEF, 0x80000001, shape, offset).long(),
                           hash_bits(words, shape, offset))


def test_masks_equal_the_port():
    from unet_research_tpu_torch.ops.cuda.dropblock_kernel import seed_threshold
    from unet_research_tpu_torch.ops.dropblock import dropblock_gamma_dependent, dropped_blocks

    shape, words = (2, 23, 19, 8), torch.tensor([12345, 4000000000])
    gamma = dropblock_gamma_dependent(23, 19, 7, 0.4)
    keep = ref.keep_mask(shape, 12345, 4000000000, ref.threshold(ref.gamma_of(0.4, 23, 19, 7)),
                         7, 0, None)
    assert seed_threshold(gamma) == ref.threshold(ref.gamma_of(0.4, 23, 19, 7))
    dropped = dropped_blocks(shape, words, gamma, 7).permute(0, 3, 1, 2)
    assert torch.equal(keep == 0, dropped) and bool(dropped.any())


def test_rotation_equals_the_port():
    from unet_research_tpu_torch.ops.image import rotate_bilinear

    img = torch.rand((1, 21, 17, 1), generator=torch.Generator().manual_seed(3))
    angles = torch.tensor([1.0, 45.0, 90.0, 200.5])
    assert torch.allclose(tasks.rotate(img, angles), rotate_bilinear(img, angles), atol=1e-5)


@pytest.mark.parametrize("workload", ["mc_drive_1000", "rot_drive_359", "train_drive_b1"])
def test_cell_agrees_with_the_reference(tiny_root, workload):
    spec = harness.load(tiny_root, workload)
    line = harness.run(spec, 2**31 + 99, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] < TIGHT for c in line["checks"].values()), line["checks"]


@pytest.mark.parametrize("workload", ["mc_drive_1000", "rot_drive_359", "train_drive_b1"])
def test_control_fails_the_limits(tiny_root, workload):
    spec = harness.load(tiny_root, workload)
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, 5, "cpu",
                           root=tiny_root)
    cell.inputs()
    gaps = cell.control()
    limits = spec.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mc_drive_1000", "rot_drive_359", "train_drive_b1",
                                      "train_dp4_b4"])
def test_control_fails_the_limits_at_the_cells_size(workload):
    """The control at the cell's own size, on one card (about 2 min for the
    MC cell)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.load(REPO, workload)
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, 2**31 + 17, "cuda")
    cell.inputs()
    gaps = cell.control()
    limits = spec.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps
