"""ops/cuda/launches.py's kernel-name table: every wrapper's launches are
named in KERNELS, directly or, for K3's forward and dx, through the
`path:*` counts of pair_conv.path_launches, and every name in the table is
a kernel of ops/cuda/csrc."""

import re
from pathlib import Path

import pytest

from unet_research_tpu_torch.ops.cuda import launches, pair_conv

CSRC = Path(launches.__file__).resolve().parent / "csrc"
GLOBALS = {m.group(1) for path in CSRC.glob("*.cu")
           for m in re.finditer(r"__global__\s+void\s+__launch_bounds__\([^)]*\)\s+(\w+)\(",
                                path.read_text())}


@pytest.mark.parametrize("fn", launches.WRAPPERS, ids=lambda fn: fn.__name__)
def test_every_wrapper_names_its_kernels(fn):
    if hasattr(fn, "path"):  # counted by kernel in pair_conv.path_launches
        counts = {f"path:{path}" for path in pair_conv.path_launches}
    else:
        counts = {fn.__name__}
    parts = [part for part, count in launches.KERNELS.items() if count in counts]
    assert {launches.KERNELS[part] for part in parts} == counts
    assert all(part.rstrip("<") in GLOBALS for part in parts), (parts, sorted(GLOBALS))


def test_k1_merge_mode_kernel_counts_on_k1():
    """K1's merge mode launches its own instantiation of the tile template,
    whose name the profiler's records hold against K1's launch count: one
    part of KERNELS names it, the wrapper it counts on."""
    assert "dropblock_apply_kernel_merge" in GLOBALS
    parts = [part for part in launches.KERNELS if part in "dropblock_apply_kernel_merge<3, 64>"]
    assert [launches.KERNELS[part] for part in parts] == ["dropblock_fused_apply"]
