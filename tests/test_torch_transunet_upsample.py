"""TransUNet's decoder merge (ops/cuda/upsample.py) on the CPU.

(1) The plain route (`upsample_merge` on CPU tensors) is bit-equal to the
composition the decoder ran before: the skip zero-padded at its bottom and
right to the upsampled size, x bilinearly upsampled by 2 (align_corners),
the two concatenated; in bf16 and float32, at TransUNet's four decoder
shapes at small widths, a skip one row and column short (147x143 into
148x144) and no skip. (2) The gradients of x and the skip, through the plain
route and through the kernel route's Function (whose forward is the kernel's
plain version on the CPU), equal autograd's through that composition, bit
for bit. (3) Route selection: a CPU call, C not a multiple of 8 or under
16, and an output other than x2 take the plain route and count `up:plain`;
the kernel's gate, checked on stand-ins for card tensors. (4) A TransUNet
forward on the CPU takes the plain route at each of its four merges. The
kernel itself is held against the plain route on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import pytest
import torch
import torch.nn.functional as F

from unet_research_tpu_torch.models import DropBlockConfig, TransUNetConfig, build_model
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.cuda import upsample as up

# (x (N, h, w, C), skip (N, hs, ws, Cs) or None): TransUNet's four decoder
# merges at 592x576 with their channels cut, a short skip, and a tiny grid
CASES = {
    "block0": ((2, 37, 36, 32), (2, 74, 72, 32)),
    "block1": ((2, 74, 72, 16), (2, 147, 143, 16)),
    "block2": ((1, 148, 144, 8), (1, 296, 288, 8)),
    "block3": ((1, 296, 288, 8), None),
    "short_skip": ((1, 74, 72, 8), (1, 147, 143, 8)),
    "tiny": ((3, 1, 2, 8), (3, 1, 3, 16)),
}
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(case, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs, ss = CASES[case]
    x = torch.randn(xs, generator=g).to(dtype)
    skip = None if ss is None else torch.randn(ss, generator=g).to(dtype)
    return x, skip


def old_merge(x, skip):
    """The decoder's merge before the kernel: the encoder padded the skip,
    the decoder upsampled and concatenated."""
    n, h, w, _ = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                      align_corners=True).permute(0, 2, 3, 1).contiguous()
    if skip is None:
        return y
    skip = F.pad(skip, (0, 0, 0, 2 * w - skip.shape[2], 0, 2 * h - skip.shape[1]))
    return torch.cat([y, skip.to(y.dtype)], dim=-1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_route_is_the_old_composition(case, dtype):
    x, skip = _inputs(case, dtype)
    got = up.upsample_merge(x, skip)
    want = old_merge(x, skip)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(up.upsample_concat(x, skip), want)  # the wrapper's CPU version


@pytest.mark.parametrize("route", ["plain", "function"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["block1", "block3", "tiny"])
def test_gradients_match_the_old_composition(case, dtype, route):
    x, skip = _inputs(case, dtype, seed=1)
    merge = up.upsample_merge if route == "plain" else up._UpsampleConcat.apply
    grads = []
    for fn in (merge, old_merge):
        xi = x.clone().requires_grad_()
        si = None if skip is None else skip.clone().requires_grad_()
        out = fn(xi, si)
        gy = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
        out.backward(gy)
        grads.append((xi.grad, None if si is None else si.grad))
    (gx, gs), (wx, ws) = grads
    assert torch.equal(gx, wx)
    assert (gs is None and ws is None) or torch.equal(gs, ws)


@pytest.mark.parametrize("x_shape,skip_shape,size", [
    ((1, 4, 5, 16), (1, 8, 9, 8), None),     # a CPU call the kernel would take on a card
    ((1, 4, 5, 12), (1, 8, 10, 8), None),    # C not a multiple of 8
    ((1, 4, 5, 8), (1, 8, 10, 8), None),     # C under 16
    ((1, 4, 5, 16), None, (9, 10)),          # not x2
], ids=["cpu", "c12", "c8", "not_x2"])
def test_plain_route_counts_up_plain(x_shape, skip_shape, size):
    x = torch.randn(x_shape)
    skip = None if skip_shape is None else torch.randn(skip_shape)
    before = launches.snapshot()
    got = up.upsample_merge(x, skip, size)
    assert launches.since(before) == {"up:plain": 1}
    assert torch.equal(got, up.upsample_concat_plain(x, skip, size))
    if size is not None:
        assert got.shape[1:3] == size


class Card:
    """A stand-in for a card tensor, for the kernel's gate."""

    is_cuda, device = True, "cuda:0"

    def __init__(self, shape, dtype=torch.bfloat16, contiguous=True):
        self.shape, self.dtype, self.c = torch.Size(shape), dtype, contiguous

    def dim(self):
        return len(self.shape)

    def numel(self):
        return self.shape.numel()

    def is_contiguous(self):
        return self.c


@pytest.mark.parametrize("x,skip,size,ok", [
    (Card((16, 37, 36, 512)), Card((16, 74, 72, 512)), None, True),
    (Card((16, 74, 72, 256)), Card((16, 147, 143, 256)), None, True),
    (Card((16, 296, 288, 64)), None, (592, 576), True),
    (Card((2, 4, 4, 16), torch.float32), Card((2, 8, 8, 8), torch.float32), None, True),
    (Card((2, 4, 4, 12)), None, None, False),                        # C % 8
    (Card((2, 4, 4, 8)), Card((2, 8, 8, 8)), None, False),           # C under 16
    (Card((2, 4, 4, 16)), Card((2, 8, 8, 12)), None, False),         # Cs % 8
    (Card((2, 4, 4, 16)), None, (8, 9), False),                      # not x2
    (Card((2, 4, 4, 16)), Card((2, 9, 8, 8)), None, False),          # skip taller than 2h
    (Card((2, 4, 4, 16)), Card((1, 8, 8, 8)), None, False),          # another batch
    (Card((2, 4, 4, 16)), Card((2, 8, 8, 8), torch.float32), None, False),  # mixed dtypes
    (Card((2, 4, 4, 16), torch.float16), None, None, False),
    (Card((2, 4, 4, 16), contiguous=False), None, None, False),
    (Card((2, 4, 4, 16)), Card((2, 8, 8, 8), contiguous=False), None, False),
    (Card((0, 4, 4, 16)), None, None, False),
], ids=["block0", "block1", "block3", "f32", "c12", "c8", "cs12", "not_x2", "tall_skip", "batch",
        "mixed", "f16", "strided_x", "strided_skip", "empty"])
def test_kernel_gate(x, skip, size, ok):
    assert up.upsample_concat_supported(x, skip, size) == ok


def test_transunet_cpu_forward_takes_the_plain_merges():
    """Four merges a forward (three skips and the last block's), all plain on
    the CPU, and no kernel launch."""
    cfg = TransUNetConfig(width=8, units=(1, 1, 1), hidden=16, layers=1, heads=2, mlp=32,
                          head_channels=16, decoder=(16, 8, 8, 8), grid=(4, 3), gn_groups=4,
                          dropblock=DropBlockConfig(kind="dependent", block_size=3))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand((2, 60, 45, 1), generator=torch.Generator().manual_seed(1))
    before = launches.snapshot()
    with torch.no_grad():
        model(x)
    got = launches.since(before)
    assert got.get("up:plain") == 4 and "up:kernel" not in got and "upsample_concat" not in got
