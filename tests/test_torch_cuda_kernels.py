"""The hand-written CUDA kernels against their plain versions on the card, at
edge shapes the main path does not reach (ragged tiles, channel counts that
are not multiples of 64, 32 or 16, float32, the smallest and largest block
sizes, more than 64 output channels, K1/K2 at a sample offset). They skip
without a card; run them on one with

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

(`--noconftest`: the suite's conftest configures JAX, which the card's
machine need not have). Tolerances: masks, keep counts and K1 outputs exact
(same hash, same rounding steps); K3 max |y - plain| / max |plain| <= 1e-2 in
bf16 and 1e-5 in float32, sums 1e-5 relative to their largest magnitude
against the plain version in float32 (TF32 off); K3's tiling is stressed at
H not a multiple of its 2-row tile, W = 46, 70 and 576 (64-column tiles),
batch 1 and 3, C_in 16/64/128, C_out 40/64/128, and each case names the
kernel it must take ('wgmma' or 'cuda_cores'). K4 (the shear fan warp) at
odd, non-square sizes, H and W one below and one above the 31x64 tile's
multiples, 1x1 and 2x3 images, the eight ties 45 + 90k (the largest
windows), the rotational chunk (K = 16 at 584x565) in both fans, K = 1, 5
and 130 (two launch groups), single-image and batched: bit-equal
(`torch.equal`; the same float32 operations in the same order); its table
launch at both indices of a two-chunk table bit-equal to the parameter
launch. A small model's captured ensembles (MC, both warps) within 1e-5 of
their chunks from the host, in float32; a capture after a graph in a
dropped reference cycle. The fold
kernel bit-equal to its plain version. K3's backward (the fold, dx in one
K3 launch, dK by cuDNN) against autograd of the plain version at odd H/W, C_in 16/64/128 and C_out 64/128, with
nonzero cotangents on the sums: max |d - plain| / max |plain| <= 1e-2 in
bf16 and 1e-3 in float32; the dx call alone with the fold at the new
tiling's edge shapes: dx within 1e-2, the folded g within one bf16
rounding of the plain fold, and with a zero dy and large ds1/ds2, where a
padding ring of g at ds1 would be the whole error; one train step of a small model, kernel route against plain route in
float32: gradients within 1e-3 of the plain ones relative to the largest
magnitude of each. GroupNorm's epilogue (ops/cuda/group_norm.py) at the
cells' shapes, (1, 592, 576, 64), (1, 37, 36, 1024) and (16, 592, 576, 64):
each launch against its plain version (tolerances at the test), the
Function against float32 autograd of GroupNorm -> mask -> scale -> relu,
with its own statistics and with K3's sums; a captured bf16 train step
replayed twice, bit-identical, with the epilogue's launches credited per
replay; the canonical model's launches per train step, rotational and MC
forward, and no GroupNorm site on the plain route (`gn:plain`). K1's merge
mode (ops/cuda/dropblock_kernel.py::dropblock_merge_apply) bit-equal, values
and keep counts, to the four launches it replaces (gn_apply with ReLU, the
skip's bf16 scale, torch.cat, K1's bare site) at the canonical U-Net's four
merges at chunk 16, at batch 1, a ragged size, with and without a scale and
at a sample offset; the canonical model's forward with it against the same
forward with it refused, bit for bit. TransUNet's
upsampling merge (ops/cuda/upsample.py) bit-equal to its plain route in bf16
and float32 at odd sizes, a 1x1 input, a short skip, no skip and more than
65535 row blocks; its Function's gradients against the plain route's in
float32 (x's within 1e-6 of the largest magnitude: aten's bilinear backward
adds with atomics; the skip's equal)."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _key(dev, words=(0xFFFFFFF0, 0x80000001)):
    return torch.tensor(words, dtype=torch.int64, device=dev)


@pytest.mark.parametrize("shape,dtype,b,act,affine", [
    ((2, 37, 45, 20), torch.float32, 7, "leaky_relu", True),
    ((3, 40, 33, 70), torch.float32, 3, "relu", True),
    ((1, 50, 70, 33), torch.bfloat16, 17, "none", False),
    ((2, 31, 64, 96), torch.bfloat16, 5, "relu", True),
    ((2, 70, 131, 64), torch.bfloat16, 7, "relu", True),
    ((1, 45, 70, 20), torch.bfloat16, 3, "leaky_relu", True),
    ((2, 33, 66, 70), torch.bfloat16, 7, "relu", True),
    ((1, 40, 50, 128), torch.bfloat16, 17, "none", True),
    ((3, 20, 29, 96), torch.bfloat16, 7, "leaky_relu", False),
    ((1, 36, 72, 128), torch.bfloat16, 3, "relu", False),
    ((2, 40, 70, 64), torch.float32, 17, "relu", True),
])
def test_dropblock_kernels_match_plain(dev, shape, dtype, b, act, affine):
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    n, h, w, c = shape
    ab = torch.randn((2, n, c), device=dev, generator=g) if affine else None
    gamma = 0.2 * h * w / (b * b * (h - b + 1) * (w - b + 1))
    key = _key(dev)
    before = dbk.dropblock_fused_apply.launches
    out, keep = dbk.dropblock_fused_apply(x, ab, key, gamma, b, act)
    ref, ref_keep = dbk.dropblock_fused_apply_plain(x, ab, key, gamma, b, act)
    assert dbk.dropblock_fused_apply.launches == before + 1
    assert torch.equal(out, ref) and torch.equal(keep, ref_keep)
    mask, mkeep = dbk.dropblock_mask(shape, key, gamma, b)
    rmask, rkeep = dbk.dropblock_mask_plain(shape, key, gamma, b)
    assert torch.equal(mask, rmask) and torch.equal(mkeep, rkeep)
    assert 0 < float(keep.min()) < h * w * c


@pytest.mark.parametrize("shape,dtype,b,offsets", [
    ((4, 37, 45, 20), torch.float32, 7, ((1, 2), (3, 1))),
    ((5, 33, 66, 70), torch.bfloat16, 3, ((2, 3), (4, 1))),
    ((2, 40, 70, 64), torch.bfloat16, 17, ((1, 1),)),
])
def test_dropblock_kernels_at_a_sample_offset(dev, shape, dtype, b, offsets):
    """K1 and K2 on rows [k, k+n) at sample_offset k equal rows [k, k+n) of
    the full launch and the plain versions at offset k (a rank's rows of a
    global batch)."""
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    n, h, w, c = shape
    ab = torch.randn((2, n, c), device=dev, generator=g)
    gamma = 0.2 * h * w / (b * b * (h - b + 1) * (w - b + 1))
    key = _key(dev)
    out, keep = dbk.dropblock_fused_apply(x, ab, key, gamma, b)
    mask, mkeep = dbk.dropblock_mask(shape, key, gamma, b)
    for k, m in offsets:
        xs, abs_ = x[k:k + m].contiguous(), ab[:, k:k + m].contiguous()
        o, kp = dbk.dropblock_fused_apply(xs, abs_, key, gamma, b, sample_offset=k)
        ro, rkp = dbk.dropblock_fused_apply_plain(xs, abs_, key, gamma, b, sample_offset=k)
        assert torch.equal(o, out[k:k + m]) and torch.equal(kp, keep[k:k + m])
        assert torch.equal(o, ro) and torch.equal(kp, rkp)
        part = (m, h, w, c)
        mk, mkp = dbk.dropblock_mask(part, key, gamma, b, sample_offset=k)
        rmk, rmkp = dbk.dropblock_mask_plain(part, key, gamma, b, sample_offset=k)
        assert torch.equal(mk, mask[k:k + m]) and torch.equal(mkp, mkeep[k:k + m])
        assert torch.equal(mk, rmk) and torch.equal(mkp, rmkp)


@pytest.mark.parametrize("shape,cout,dtype,path", [
    ((2, 37, 46, 32), 40, torch.bfloat16, "wgmma"),
    ((1, 20, 16, 64), 130, torch.bfloat16, "cuda_cores"),
    ((2, 37, 46, 24), 40, torch.bfloat16, "cuda_cores"),
    ((2, 19, 30, 5), 8, torch.float32, "cuda_cores"),
    ((1, 37, 70, 16), 64, torch.bfloat16, "wgmma"),
    ((3, 21, 576, 64), 64, torch.bfloat16, "wgmma"),
    ((1, 9, 46, 128), 40, torch.bfloat16, "wgmma"),
    ((3, 11, 70, 128), 128, torch.bfloat16, "wgmma"),
    ((1, 7, 576, 64), 128, torch.bfloat16, "wgmma"),
    ((3, 5, 46, 16), 128, torch.bfloat16, "wgmma"),
    ((1, 13, 576, 128), 64, torch.bfloat16, "wgmma"),
    ((1, 4, 70, 64), 256, torch.bfloat16, "wgmma"),
])
def test_conv3x3_pair_matches_plain(dev, shape, cout, dtype, path):
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    k = (0.1 * torch.randn((3, 3, shape[-1], cout), device=dev, generator=g)).to(dtype)
    y, s1, s2 = pc.conv3x3_pair(x, k, stats=True)
    assert pc.conv3x3_pair.path == path
    ry = pc.conv3x3_pair_plain(x, k)
    _, r1, r2 = pc.conv3x3_pair_plain(x.float(), k.float(), stats=True)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((y.float() - ry.float()).abs().max() / ry.float().abs().max()) <= tol
    for s, r in ((s1, r1), (s2, r2)):
        assert float((s - r).abs().max() / r.abs().max()) <= 1e-5


TIES = [45.0, 135.0, 225.0, 315.0, -45.0, -135.0, -225.0, -315.0]
# one chunk of the rotational fan, as chip_smoke.py runs it
FAN16 = [45.0, 135.0, 225.0, 315.0, 1.0, 17.0, 33.0, 60.0, 90.0, 101.0, 180.0, 200.5, 270.0,
         300.0, 333.0, 359.0]
ROTATE_CASES = [
    (1, 37, 53, [135.0]),
    (1, 61, 40, [45.0, -135.0, 7.5, 225.0, 359.0]),
    (5, 40, 61, [-45.0, 135.0, -7.5, -225.0, -359.0]),
    (1, 130, 129, [0.0, 90.0, 180.0, 270.0, 33.0]),
    (130, 20, 17, [2.75 * i - 179.0 for i in range(130)]),  # two launch groups
    # one below and one above the 31x64 tile's multiples, the ties
    (1, 30, 63, TIES + [10.0, -80.0]),
    (10, 32, 65, TIES + [0.5, 300.0]),
    (1, 61, 127, TIES),
    (8, 63, 129, TIES),
    (1, 1, 1, TIES + [0.0, 17.0]),
    (2, 2, 3, [135.0, -315.0]),
    (1, 584, 565, FAN16),
    (16, 584, 565, [-a for a in FAN16]),
    (1, 40, 33, [3.0 * i + 0.5 for i in range(130)]),  # two launch groups, one image
]


@pytest.mark.parametrize("n,h,w,angles", ROTATE_CASES)
def test_rotate_fan_matches_plain(dev, n, h, w, angles):
    from unet_research_tpu_torch.ops.cuda import shear_rotate as sr

    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.rand((n, h, w, 1), device=dev, generator=g)
    a = torch.tensor(angles)
    before = sr.rotate_fan.launches
    out = sr.rotate_fan(img, a)
    assert sr.rotate_fan.launches == before + 1
    ref = sr.rotate_fan_plain(img, a)
    assert out.shape == (len(angles), h, w, 1)
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("n,h,w,angles", [c for c in ROTATE_CASES if len(c[3]) <= 128])
def test_rotate_fan_table_matches_parameter_launch(dev, n, h, w, angles):
    """The table launch at each chunk index of a two-chunk table equals the
    parameter launch of that chunk's angles, bit for bit, in one launch."""
    from unet_research_tpu_torch.ops.cuda import shear_rotate as sr

    g = torch.Generator(device=dev).manual_seed(3)
    img = torch.rand((n, h, w, 1), device=dev, generator=g)
    chunks = [torch.tensor(angles), torch.tensor(angles) * -0.5 + 11.25]
    table = sr.member_table(chunks, h, w, dev)
    for c, a in enumerate(chunks):
        index = torch.tensor([c], device=dev)
        before = sr.rotate_fan_table.launches
        out = sr.rotate_fan_table(img, table, index)
        assert sr.rotate_fan_table.launches == before + 1
        ref = sr.rotate_fan(img, a)
        assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("warp", [None, "shear", "gather"])
def test_captured_ensemble_matches_eager(dev, warp):
    """A small model's ensemble through its CUDA graph (the chunk captured
    after one warm-up chunk, then replayed) against every chunk from the
    host, float32: the same site keys or angles; within 1e-5 (cuDNN may
    order sums differently in two runs)."""
    import numpy as np

    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine

    db = tunet.DropBlockConfig(kind="dependent" if warp is None else None, block_size=3)
    cfg = tunet.canonical_config(filters=8, model_depth=2, group_norm_groups=4, dropblock=db)
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    im = rng.random((1, 40, 36, 1), dtype=np.float32)
    mask = np.ones_like(im)
    runs = {}
    for program in (True, False):
        if warp is None:
            engine = MCDropBlockEngine(model, num_iterations=26, return_num=2, chunk=4,
                                       device=dev, program=program)
            runs[program] = [engine.predict(im, im, mask, 0.2,
                                            generator=torch.Generator().manual_seed(k))[:3]
                             for k in (1, 2)]
        else:
            engine = RotationalEngine(model, num_iterations=26, return_num=2, chunk=4,
                                      warp=warp, device=dev, program=program)
            runs[program] = [engine.predict(im, im, mask)[:3] for _ in range(2)]
        if program:
            (prog,) = engine.programs.values()
            assert prog.graph is not None and prog.capture_seconds is not None
    for got, ref in zip(runs[True], runs[False]):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_capture_survives_a_dropped_graph_in_a_cycle(dev):
    """A CUDA graph left in a reference cycle (as an engine keeps its cached
    program) and dropped just before launches.capture: the collector frees
    it before the capture, not inside it, where destroying a graph
    invalidates the capture. The step makes enough objects to start a
    collection if the collector were on."""
    from unet_research_tpu_torch.ops.cuda import launches

    class Holder:
        pass

    x = torch.arange(8, dtype=torch.float32, device=dev)
    graph = launches.capture(lambda: x * 2)[0]
    held = Holder()  # made after that capture's collection, so it is young
    held.cycle, held.graph = held, graph
    del held, graph
    out = {}

    def step():
        junk = [[i] for i in range(5000)]
        out["y"] = x * 3 + len(junk)

    graph, counts, seconds = launches.capture(step)
    graph.replay()
    torch.cuda.synchronize()
    assert counts == {} and seconds >= 0
    assert torch.equal(out["y"], x * 3 + 5000)


@pytest.mark.parametrize("cin", [16, 64, 128])
@pytest.mark.parametrize("cout", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_pair_backward_matches_plain(dev, cin, cout, dtype):
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc

    g = torch.Generator(device=dev).manual_seed(cin + cout)
    x = torch.randn((2, 37, 29, cin), device=dev, generator=g).to(dtype)
    k = (0.1 * torch.randn((3, 3, cin, cout), device=dev, generator=g)).to(dtype)
    cots = (torch.randn((2, 37, 29, cout), device=dev, generator=g).to(dtype),
            0.5 * torch.randn((2, cout), device=dev, generator=g),
            0.5 * torch.randn((2, cout), device=dev, generator=g))

    def grads(fn):
        xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
        return torch.autograd.grad(fn(xr, kr, stats=True), (xr, kr), cots)

    before = pc.conv3x3_pair_dx.launches
    got = grads(pc.conv3x3_pair)
    assert pc.conv3x3_pair_dx.launches == before + 1
    ref = grads(pc.conv3x3_pair_plain)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max() / b.float().abs().max()) <= tol


def _ulps(a, b):
    """Largest distance in bf16 units in the last place between a and b."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("shape,cin,zero_dy", [
    ((1, 37, 70, 64), 64, False),
    ((3, 21, 576, 64), 128, False),
    ((1, 9, 46, 16), 40, False),
    ((2, 11, 70, 128), 64, False),
    ((1, 37, 70, 64), 64, True),
    ((2, 9, 46, 64), 128, True),
])
def test_conv3x3_pair_dx_fold_matches_plain(dev, shape, cin, zero_dy):
    """dx with the sums' cotangents folded in (the fold kernel, then one K3
    launch): dx and the folded g against the plain fold + conv. A zero dy
    with large ds1/ds2 makes the dx conv's padding ring (zero for g, not
    ds1) the whole error."""
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc

    gen = torch.Generator(device=dev).manual_seed(shape[2] + cin)
    n, cout = shape[0], shape[-1]
    dy = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    if zero_dy:
        dy = torch.zeros_like(dy)
    y = torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)
    ds1 = 50.0 * torch.randn((n, cout), device=dev, generator=gen)
    ds2 = 20.0 * torch.randn((n, cout), device=dev, generator=gen)
    k = (0.1 * torch.randn((3, 3, cin, cout), device=dev, generator=gen)).to(torch.bfloat16)
    before = (pc.conv3x3_pair_dx.launches, pc.conv3x3_pair_fold.launches)
    dx, g = pc.conv3x3_pair_dx(dy, k, y, ds1, ds2)
    assert (pc.conv3x3_pair_dx.launches, pc.conv3x3_pair_fold.launches) == (before[0] + 1,
                                                                            before[1] + 1)
    assert pc.conv3x3_pair_dx.path == "wgmma"
    rdx, rg = pc.conv3x3_pair_dx_plain(dy, k, y, ds1, ds2)
    assert dx.shape == rdx.shape and g.shape == rg.shape
    assert _ulps(g, rg) <= 1
    assert float((dx.float() - rdx.float()).abs().max() / rdx.float().abs().max()) <= 1e-2
    # and without the fold: g is dy, dx its conv
    dx0, g0 = pc.conv3x3_pair_dx(dy, k)
    assert g0.data_ptr() == dy.data_ptr() or torch.equal(g0, dy)
    rdx0, _ = pc.conv3x3_pair_dx_plain(dy, k)
    err0 = float((dx0.float() - rdx0.float()).abs().max())
    assert err0 <= 1e-2 * max(float(rdx0.float().abs().max()), 1e-30)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 37, 29, 64), torch.bfloat16),
    ((1, 11, 70, 128), torch.bfloat16),
    ((2, 9, 13, 20), torch.bfloat16),
    ((1, 7, 9, 33), torch.float32),
])
def test_conv3x3_pair_fold_matches_plain(dev, shape, dtype):
    """The fold kernel against its plain version: bit-equal (the same
    float32 operations in the same order, rounded once), with and without
    ds2, at 16-byte vector and scalar channel counts."""
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc

    gen = torch.Generator(device=dev).manual_seed(shape[-1])
    n, c = shape[0], shape[-1]
    dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
    y = torch.randn(shape, device=dev, generator=gen).to(dtype)
    ds1 = 3.0 * torch.randn((n, c), device=dev, generator=gen)
    ds2 = 2.0 * torch.randn((n, c), device=dev, generator=gen)
    for d2 in (ds2, None):
        before = pc.conv3x3_pair_fold.launches
        g = pc.conv3x3_pair_fold(dy, y, ds1, d2)
        assert pc.conv3x3_pair_fold.launches == before + 1
        assert torch.equal(g, pc.conv3x3_pair_fold_plain(dy, y, ds1, d2))


def test_train_step_kernel_route_matches_plain(dev):
    """One train step of a 64-filter depth-1 U-Net (the three pair sites, K2
    masks, remat) in float32: kernel route against the plain route."""
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc
    from unet_research_tpu_torch.ops.losses import masked_rescaled_bce

    base = tunet.canonical_config(filters=64, model_depth=1, group_norm_groups=8, remat=True,
                                  dropblock=tunet.DropBlockConfig(kind="dependent", block_size=3))
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((2, 48, 64, 1), device=dev, generator=gen)
    gt = (torch.rand((2, 48, 64, 1), device=dev, generator=gen) > 0.8).float()
    keys = tunet.draw_site_keys(7, torch.Generator().manual_seed(4)).to(dev)
    state = tunet.UNet(base, device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    grads = {}
    for name, conv, mask in (("kernel", "pair", "kernel"), ("plain", "torch", "elementwise")):
        cfg = dataclasses.replace(base, conv_impl=conv,
                                  dropblock=dataclasses.replace(base.dropblock, mask_impl=mask))
        model = tunet.UNet(cfg, device=dev)
        model.load_state_dict(state)
        before = pc.conv3x3_pair_dx.launches
        masked_rescaled_bce(model(x, drop_prob=0.2, site_keys=keys, train=True), gt,
                            torch.ones_like(gt)).backward()
        assert pc.conv3x3_pair_dx.launches - before == (3 if name == "kernel" else 0)
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
    for n, ref in grads["plain"].items():
        err = float((grads["kernel"][n] - ref).abs().max() / ref.abs().max())
        assert err <= 1e-3, (n, err)


# --- GroupNorm's epilogue (ops/cuda/group_norm.py) ---------------------------

# the cells' shapes: batch 1 at the top and the bottom level, a chunk of 16
GN_SHAPES = [(1, 592, 576, 64), (1, 37, 36, 1024), (16, 592, 576, 64)]
GN_GROUPS = 32


def _gn_inputs(dev, shape, seed):
    """x (bf16, mean 0.5), the GroupNorm weight and bias, K2's keep mask at
    b = 7, a per-sample scale and an output cotangent (bf16)."""
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk

    g = torch.Generator(device=dev).manual_seed(seed)
    n, h, w, c = shape
    x = (1.3 * torch.randn(shape, device=dev, generator=g) + 0.5).to(torch.bfloat16)
    weight = 1.0 + 0.3 * torch.randn(c, device=dev, generator=g)
    bias = 0.2 * torch.randn(c, device=dev, generator=g)
    gamma = 0.15 * h * w / (49 * (h - 6) * (w - 6))
    mask, _ = dbk.dropblock_mask(shape, _key(dev), gamma, 7)
    scale = 0.8 + 0.4 * torch.rand(n, device=dev, generator=g)
    gy = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    return x, weight, bias, mask, scale, gy


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_kernels_match_plain(dev, shape):
    """Each of the six launches against its plain version on the card
    (float32 arithmetic): the partial sums and the finishing launches within
    1e-5 of the largest magnitude (only the order of the sums differs); the
    apply and both dx passes bit-equal (the same float32 operations in the
    same order, rounded once), under each activation, with and without the
    mask and the scale."""
    from unet_research_tpu_torch.ops.cuda import group_norm as gn

    x, weight, bias, mask, scale, gy = _gn_inputs(dev, shape, seed=shape[-1] + shape[0])
    hw = shape[1] * shape[2]
    part = gn.gn_stats(x)
    rpart = gn.gn_stats_plain(x)
    for k in range(2):
        assert _rel(part[k].sum(1), rpart[k, :, 0]) <= 1e-5
    ab, mr = gn.gn_stats_finish(part[0], part[1], hw, weight, bias, GN_GROUPS, 1e-5)
    rab, rmr = gn.gn_stats_finish_plain(rpart[0], rpart[1], hw, weight, bias, GN_GROUPS, 1e-5)
    assert _rel(ab, rab) <= 1e-5 and _rel(mr[:2], rmr[:2]) <= 1e-5
    assert torch.equal(mr[2], rmr[2])
    # K3's sums: the (N, C) sums as one partial
    ab3, _ = gn.gn_stats_finish(rpart[0, :, 0][:, None], rpart[1, :, 0][:, None], hw, weight,
                                bias, GN_GROUPS, 1e-5)
    assert _rel(ab3, rab) <= 1e-5
    for act, m, s in (("relu", mask, scale), ("leaky_relu", mask, scale[:1].reshape(())),
                      ("none", None, None), ("relu", None, scale)):
        before = gn.gn_apply.launches
        y = gn.gn_apply(x, rab, m, s, act)
        assert gn.gn_apply.launches == before + 1
        assert torch.equal(y, gn.gn_apply_plain(x, rab, m, s, act)), act
        gpart, dx = gn.gn_grad_sums(gy, x, rab, m, s, act, dx=True)
        rgpart, rdx = gn.gn_grad_sums_plain(gy, x, rab, m, s, act, dx=True)
        assert torch.equal(dx, rdx), act
        for k in range(2):
            assert _rel(gpart[k].sum(1), rgpart[k, :, 0]) <= 1e-5, act
        ds, dw, db = gn.gn_grad_finish(gpart, rab, rmr, weight, hw, GN_GROUPS)
        rds, rdw, rdb = gn.gn_grad_finish_plain(gpart, rab, rmr, weight, hw, GN_GROUPS)
        for a, b in ((ds, rds), (dw, rdw), (db, rdb)):
            assert _rel(a, b) <= 1e-5, act
        dx2 = gn.gn_grad_dx(gy, x, rab, m, s, rds, act)
        assert torch.equal(dx2, gn.gn_grad_dx_plain(gy, x, rab, m, s, rds, act)), act


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("k3", [False, True])
def test_group_norm_act_matches_float32_autograd(dev, shape, k3):
    """group_norm_act (mask, per-sample scale, relu) against float32
    autograd of GroupNorm -> mask -> scale -> relu on the same bf16 inputs:
    y within one bf16 rounding (2^-8 of |y|) plus 1e-4 of the largest |y|;
    dx within 1e-2 of its largest magnitude (rounded to bf16), the weight's
    and bias's gradients and K3's sums' cotangents within 1e-3."""
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import group_norm as gn

    x0, w0, b0, mask, scale, gy = _gn_inputs(dev, shape, seed=7 + shape[-1])
    hw = shape[1] * shape[2]
    xf = x0.float()
    sums0 = (xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2)))

    def run(fn, x):
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        x = x.clone().requires_grad_()
        leaves = [x, w, b]
        sums = None
        if k3:
            sums = tuple(s.clone().requires_grad_() for s in sums0)
            leaves += list(sums)
        y = fn(x, w, b, sums)
        return [t.detach() for t in (y, *torch.autograd.grad(y, leaves, gy.to(y.dtype)))]

    def reference(x, w, b, sums):
        if sums is None:
            z = F.group_norm(x.permute(0, 3, 1, 2), GN_GROUPS, w, b, 1e-5).permute(0, 2, 3, 1)
        else:
            a, bb = tunet.group_norm_coeffs_from_sums(sums[0], sums[1], hw, w, b, GN_GROUPS,
                                                      1e-5)
            z = x * a[:, None, None, :] + bb[:, None, None, :]
        return torch.relu(z * mask.float() * scale[:, None, None, None])

    before = {f.__name__: f.launches for f in gn.WRAPPERS}
    got = run(lambda x, w, b, sums: gn.group_norm_act(x, w, b, GN_GROUPS, 1e-5, sums, mask,
                                                      scale, "relu"), x0)
    counts = {f.__name__: f.launches - before[f.__name__] for f in gn.WRAPPERS}
    assert counts == {"gn_stats": 0 if k3 else 1, "gn_stats_finish": 1, "gn_apply": 1,
                      "gn_grad_sums": 1, "gn_grad_finish": 1, "gn_grad_dx": 0 if k3 else 1}
    ref = run(reference, xf)
    y, ry = got[0].float(), ref[0]
    assert bool(((y - ry).abs() <= 2**-8 * ry.abs() + 1e-4 * ry.abs().max()).all())
    names = ["dx", "dweight", "dbias"] + (["ds1", "ds2"] if k3 else [])
    for name, a, b in zip(names, got[1:], ref[1:]):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= (1e-2 if name == "dx" else 1e-3), (name, _rel(a, b))


def _gn_counts():
    from unet_research_tpu_torch.ops.cuda import group_norm as gn

    return {f.__name__: f.launches for f in gn.WRAPPERS}


def _gn_added(before):
    return {k: v - before[k] for k, v in _gn_counts().items() if v != before[k]}


def test_captured_train_step_replays_bit_identical(dev):
    """A bf16 train step of a 64-filter depth-1 U-Net (K2 masks at a device
    drop probability, remat; its convs through cuDNN in its deterministic
    mode, since K3's sums add with float atomics) captured as one CUDA graph:
    two replays give the same loss and gradients bit for bit; one replay is
    credited the epilogue's launches of its 8 GroupNorm sites (each forward
    twice under remat), and no site took the plain route. Then the
    epilogue alone from fixed K3 sums, captured forward and backward,
    replayed twice: bit for bit."""
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import group_norm as gn
    from unet_research_tpu_torch.ops.cuda import launches
    from unet_research_tpu_torch.ops.losses import masked_rescaled_bce

    cfg = tunet.canonical_config(filters=64, model_depth=1, group_norm_groups=8, remat=True,
                                 dtype=torch.bfloat16, conv_impl="torch",
                                 dropblock=tunet.DropBlockConfig(kind="dependent", block_size=3))
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((1, 48, 64, 1), device=dev, generator=gen)
    gt = (torch.rand((1, 48, 64, 1), device=dev, generator=gen) > 0.8).float()
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(4)).to(dev)
    drop = torch.tensor(0.2, device=dev)
    params = list(model.parameters())
    outs = [torch.zeros_like(p) for p in params] + [torch.zeros((), device=dev)]

    def step():
        loss = masked_rescaled_bce(model(x, drop_prob=drop, site_keys=keys, train=True), gt,
                                   torch.ones_like(gt))
        for o, g in zip(outs, (*torch.autograd.grad(loss, params), loss.detach())):
            o.copy_(g)

    xs, ws, bs, mask, scale, gy = _gn_inputs(dev, (1, 48, 64, 64), seed=9)
    xs = xs.requires_grad_()
    ws, bs = ws.requires_grad_(), bs.requires_grad_()
    xf = xs.detach().float()
    sums = tuple(t.requires_grad_() for t in (xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))))
    leaves = (xs, ws, bs, *sums)
    gn_outs = [torch.zeros_like(t) for t in leaves] + [torch.zeros_like(xs)]

    def epilogue():
        y = gn.group_norm_act(xs, ws, bs, GN_GROUPS, 1e-5, sums, mask, scale, "relu")
        for o, g in zip(gn_outs, (*torch.autograd.grad(y, leaves, gy), y.detach())):
            o.copy_(g)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fn, outputs, want in (
                (step, outs, {"gn_stats": 16, "gn_stats_finish": 16, "gn_apply": 16,
                              "gn_grad_sums": 8, "gn_grad_finish": 8, "gn_grad_dx": 8}),
                (epilogue, gn_outs, {"gn_stats_finish": 1, "gn_apply": 1, "gn_grad_sums": 1,
                                     "gn_grad_finish": 1})):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream(dev).wait_stream(side)
            plain = launches.HOST["gn:plain"]
            graph, counts, _ = launches.capture(fn)
            assert launches.HOST["gn:plain"] == plain
            assert {k: v for k, v in counts.items() if k.startswith("gn_")} == want
            runs = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                runs.append([o.clone() for o in outputs])
            assert all(torch.equal(a, b) for a, b in zip(*runs)), fn.__name__
            assert all(float(o.abs().max()) > 0 for o in runs[0]), fn.__name__
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_canonical_model_epilogue_launches(dev):
    """The canonical U-Net (bf16, GroupNorm(32), remat) at 64x64: a train
    step launches the counts PERF.md gives per replayed train step (26
    GroupNorm sites, 23 of their own statistics and 3 K3's, each forward
    twice under remat: 46 + 52 + 52 forward, 26 + 26 + 23 backward), a
    forward with DropBlock off (a rotational chunk) 23 + 26 + 26, and the MC
    engine's forward through K1 the 8 upconv and pool-norm sites' statistics,
    8 + 8, and the 4 pool norms' apply (the upconv norms' apply is in K1's
    merge mode, at each of the 4 merges); no site takes the plain route."""
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import launches
    from unet_research_tpu_torch.ops.losses import masked_rescaled_bce

    cfg = tunet.canonical_config(remat=True, dtype=torch.bfloat16,
                                 dropblock=tunet.DropBlockConfig(kind="dependent", block_size=7))
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((2, 64, 64, 1), device=dev, generator=gen)
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(3)).to(dev)
    plain = launches.HOST["gn:plain"]
    before = _gn_counts()
    out = model(x[:1], drop_prob=torch.tensor(0.15, device=dev), site_keys=keys, train=True)
    masked_rescaled_bce(out, (x[:1] > 0.5).float(), torch.ones_like(out)).backward()
    assert _gn_added(before) == {"gn_stats": 46, "gn_stats_finish": 52, "gn_apply": 52,
                                 "gn_grad_sums": 26, "gn_grad_finish": 26, "gn_grad_dx": 23}
    with torch.no_grad():
        before = _gn_counts()
        model(x)
        assert _gn_added(before) == {"gn_stats": 23, "gn_stats_finish": 26, "gn_apply": 26}
        before, merged = _gn_counts(), launches.snapshot()
        model(x, drop_prob=0.15, site_keys=keys)
        assert _gn_added(before) == {"gn_stats": 8, "gn_stats_finish": 8, "gn_apply": 4}
        got = launches.since(merged)
        assert got["merge:kernel"] == 4 and "merge:plain" not in got
        assert got["dropblock_fused_apply"] == model.num_mask_sites()
    assert launches.HOST["gn:plain"] == plain


def test_batch_norm_eval_sites_take_gn_apply(dev):
    """A U-Net with BatchNorm (bf16, depth 2, cuDNN's convs, 48x64, running
    statistics set away from the identity): in eval every BatchNorm site
    takes gn_apply,
    one launch a site with DropBlock's mask and whole-batch rescale and
    without, none the plain ops (`bn:plain`); the output within twice the
    plain bf16 route's distance from float32 (run_slice's gate in
    chip_smoke.py; the plain routes refused gn_apply through
    models/sites.py's `_kernel_input`). A train-mode forward takes the plain
    ops at every site and counts each in `bn:plain`."""
    import torch.nn as nn

    from unet_research_tpu_torch.models import sites, unet as tunet
    from unet_research_tpu_torch.ops.cuda import group_norm as gn
    from unet_research_tpu_torch.ops.cuda import launches

    db = tunet.DropBlockConfig(kind="dependent", block_size=3, mask_impl="kernel")

    def build(dtype):
        cfg = tunet.UNetConfig(init_channels=1, filters=16, model_depth=2, norm="batch",
                               dtype=dtype, dropblock=db, conv_impl="torch")
        model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_((torch.rand(c, generator=g) * 0.2 - 0.1).to(dev))
                mod.running_var.copy_((torch.rand(c, generator=g) + 0.5).to(dev))
        return model.eval()

    models = {"kernels": build(torch.bfloat16), "plain_bf16": build(torch.bfloat16),
              "plain_f32": build(torch.float32)}
    sites_bn = sum(isinstance(m, nn.BatchNorm2d) for m in models["kernels"].modules())
    x = torch.rand((2, 48, 64, 1), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    keys = tunet.draw_site_keys(models["kernels"].num_mask_sites(),
                                torch.Generator().manual_seed(4)).to(dev)
    outs = {}
    gate = sites._kernel_input
    for drop in (None, 0.15):
        for name, model in models.items():
            plain, applied = launches.HOST["bn:plain"], gn.gn_apply.launches
            if name != "kernels":
                sites._kernel_input = lambda t: False
            try:
                with torch.no_grad():
                    outs[name] = model(x, drop_prob=drop, site_keys=keys if drop else None)
            finally:
                sites._kernel_input = gate
            if name == "kernels":
                assert gn.gn_apply.launches - applied == sites_bn
                assert launches.HOST["bn:plain"] == plain
            else:
                assert gn.gn_apply.launches == applied
                assert launches.HOST["bn:plain"] - plain == sites_bn
        d_kernel = float((outs["kernels"] - outs["plain_bf16"]).abs().max())
        d_bf16 = float((outs["plain_bf16"] - outs["plain_f32"]).abs().max())
        assert 0 < d_bf16 and d_kernel <= 2.0 * d_bf16, (drop, d_kernel, d_bf16)
    model = models["kernels"].train()
    plain, applied = launches.HOST["bn:plain"], gn.gn_apply.launches
    with torch.no_grad():
        model(x, drop_prob=0.15, site_keys=keys, train=True)
    assert gn.gn_apply.launches == applied
    assert launches.HOST["bn:plain"] - plain == sites_bn


def _merge_inputs(dev, n, h, w, c1, c2, seed):
    from unet_research_tpu_torch.ops.cuda import group_norm as gn

    g = torch.Generator(device=dev).manual_seed(seed)
    x = (1.5 * torch.randn((n, h, w, c1), device=dev, generator=g) + 0.3).to(torch.bfloat16)
    skip = torch.relu(torch.randn((n, h, w, c2), device=dev, generator=g)).to(torch.bfloat16)
    weight = 1.0 + 0.2 * torch.randn(c1, device=dev, generator=g)
    bias = 0.2 * torch.randn(c1, device=dev, generator=g)
    p0, p1 = gn.gn_stats(x)
    ab, _ = gn.gn_stats_finish(p0, p1, h * w, weight, bias, 32, 1e-5)
    scale = (1.0 + 0.3 * torch.rand(n, device=dev, generator=g)).contiguous()
    return x, skip, ab, scale


def _merge_composition(x, ab, skip, scale, key, gamma, offset=0):
    """The route K1's merge mode replaces on the card: gn_apply with ReLU,
    the skip's scale as a bf16 multiply, torch.cat, K1's bare site."""
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
    from unet_research_tpu_torch.ops.cuda import group_norm as gn

    y = gn.gn_apply(x, ab, act="relu")
    if scale is not None:
        skip = skip * scale.to(skip.dtype)[:, None, None, None]
    return dbk.dropblock_fused_apply(torch.cat([y, skip], dim=-1), None, key, gamma, 7, "none",
                                     sample_offset=offset)


# the canonical U-Net's four merges at chunk 16 on 592x576, (n, h, w, C1, C2)
MERGE_SHAPES = [(16, 74, 72, 512, 512), (16, 148, 144, 256, 256), (16, 296, 288, 128, 128),
                (16, 592, 576, 64, 64)]


@pytest.mark.parametrize("scaled", [True, False], ids=["scale", "no_scale"])
@pytest.mark.parametrize("shape", MERGE_SHAPES + [(1, 592, 576, 64, 64), (3, 37, 45, 128, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dropblock_merge_apply_matches_the_composition(dev, shape, scaled):
    """K1's merge mode bit-equal, values and keep counts, to the four
    launches it replaces, at the canonical U-Net's four merges (chunk 16),
    at batch 1, and at a ragged size with unequal halves; with the deferred
    scale and without."""
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
    from unet_research_tpu_torch.ops.dropblock import dropblock_gamma_dependent

    n, h, w, c1, c2 = shape
    x, skip, ab, scale = _merge_inputs(dev, *shape, seed=c1 + n)
    scale = scale if scaled else None
    gamma, key = dropblock_gamma_dependent(h, w, 7, 0.15), _key(dev)
    before = (dbk.dropblock_fused_apply.launches, dbk.merges["kernel"])
    out, keep = dbk.dropblock_merge_apply(x, ab, skip, scale, key, gamma, 7)
    assert (dbk.dropblock_fused_apply.launches, dbk.merges["kernel"]) == (before[0] + 1,
                                                                          before[1] + 1)
    want, want_keep = _merge_composition(x, ab, skip, scale, key, gamma)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(keep, want_keep)
    assert 0 < float(keep.min()) < h * w * (c1 + c2)


@pytest.mark.parametrize("shape,k,m", [((16, 74, 72, 512, 512), 3, 5),
                                       ((4, 296, 288, 128, 128), 1, 3)])
def test_dropblock_merge_apply_at_a_sample_offset(dev, shape, k, m):
    """Rows [k, k+m) of the merge mode at sample_offset k equal rows [k,
    k+m) of the whole batch's launch and the composition at offset k."""
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
    from unet_research_tpu_torch.ops.dropblock import dropblock_gamma_dependent

    n, h, w, c1, c2 = shape
    x, skip, ab, scale = _merge_inputs(dev, *shape, seed=11)
    gamma, key = dropblock_gamma_dependent(h, w, 7, 0.15), _key(dev)
    full, full_keep = dbk.dropblock_merge_apply(x, ab, skip, scale, key, gamma, 7)
    rows = slice(k, k + m)
    args = (x[rows].contiguous(), ab[:, rows].contiguous(), skip[rows].contiguous(),
            scale[rows].contiguous(), key, gamma)
    out, keep = dbk.dropblock_merge_apply(*args, 7, sample_offset=k)
    want, want_keep = _merge_composition(*args, offset=k)
    torch.cuda.synchronize()
    assert torch.equal(out, full[rows]) and torch.equal(keep, full_keep[rows])
    assert torch.equal(out, want) and torch.equal(keep, want_keep)


def test_canonical_model_merges_match_the_composition(dev, monkeypatch):
    """The canonical U-Net (bf16, pair convs, fused masks) at 2 x 64x80: a
    forward takes K1's merge mode at its 4 merges and equals, bit for bit,
    the same forward with the merge mode refused (the composition)."""
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import launches

    cfg = tunet.canonical_config(dtype=torch.bfloat16,
                                 dropblock=tunet.DropBlockConfig(kind="dependent", block_size=7))
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(1)).eval()
    x = torch.rand((2, 64, 80, 1), device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(3)).to(dev)
    outs, routes = [], []
    for refuse in (False, True):
        if refuse:
            monkeypatch.setattr(tunet._Pass, "merge_site", lambda self, *args: None)
        before = launches.snapshot()
        with torch.no_grad():
            outs.append(model(x, drop_prob=0.15, site_keys=keys))
        got = launches.since(before)
        routes.append((got.get("merge:kernel", 0), got.get("merge:plain", 0)))
    assert routes == [(4, 0), (0, 4)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("x_shape,skip_shape", [
    ((3, 7, 5, 16), (3, 13, 9, 8)),          # odd sizes, a skip short by one each way
    ((2, 1, 1, 16), (2, 2, 1, 8)),           # a 1x1 input
    ((2, 74, 72, 16), (2, 147, 143, 24)),    # TransUNet's stage-1 merge, cut
    ((2, 9, 11, 24), None),                  # no skip
    ((140000, 1, 1, 16), (140000, 2, 2, 8)),  # past 65535 blocks a column
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_upsample_concat_matches_plain(dev, x_shape, skip_shape, dtype):
    """The upsampling merge (ops/cuda/upsample.py) bit-equal to the plain
    route (F.interpolate, F.pad, torch.cat) at edge shapes."""
    from unet_research_tpu_torch.ops.cuda import upsample as up

    g = torch.Generator(device=dev).manual_seed(7)
    x = (3 * torch.randn(x_shape, device=dev, generator=g) + 0.5).to(dtype)
    skip = None if skip_shape is None else torch.randn(skip_shape, device=dev,
                                                       generator=g).to(dtype)
    launched = up.upsample_concat.launches
    got = up.upsample_concat(x, skip)
    torch.cuda.synchronize()
    assert up.upsample_concat.launches == launched + 1
    assert torch.equal(got, up.upsample_concat_plain(x, skip))


def test_upsample_merge_gradients_match_plain(dev):
    """The kernel route's Function against autograd of the plain route in
    float32, at a short skip: x's gradient within 1e-6 of the largest
    magnitude (aten's bilinear backward adds with atomics, in no fixed
    order), the skip's equal."""
    from unet_research_tpu_torch.ops.cuda import upsample as up

    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 37, 36, 16), device=dev, generator=g)
    skip = torch.randn((2, 73, 71, 8), device=dev, generator=g)
    gy = torch.randn((2, 74, 72, 24), device=dev, generator=g)
    grads = []
    for merge in (up.upsample_merge, up.upsample_concat_plain):
        xi, si = x.clone().requires_grad_(), skip.clone().requires_grad_()
        before = dict(up.calls)
        merge(xi, si).backward(gy)
        grads.append((xi.grad, si.grad, {k: up.calls[k] - before[k] for k in before}))
    (gx, gs, routes), (px, ps, _) = grads
    assert routes == {"kernel": 1, "plain": 0}
    assert float((gx - px).abs().max()) <= 1e-6 * float(px.abs().max())
    assert torch.equal(gs, ps)
