"""Swin UNETR (models/swin_unetr.py) against its plain float32 reference (the
benchmark's, benchmark/reference/swinunetr.py), at a small size on the CPU:
the forward without and with masks on a canvas where every stage pads to
the window and shifts (160 x 128) and on one where the last stage's grid is
shorter than the window, which is then clipped and unshifted (96 x 96); the
window geometry against MONAI's rules; the published configuration's sites
and parameters; the MC-DropBlock and rotational engines; one SGD step's
gradients through the Trainer, its epochs, and the training CLI's -arch flag;
the window attention entry of ops/attention.py.

The weights of the comparisons are He-uniform (U(+-sqrt(6 / fan_in))) with
perturbed LayerNorm parameters and N(0, 1) relative-position tables, so that
every part of the model moves the output.

Tolerances: forwards and ensembles compute in float32 on both sides, in
other orders (InstanceNorm through one-pass GroupNorm coefficients, SDPA for
the written-out softmax, the windows by a gather, no rescale at the sites),
each about 5e-6 from a float64 evaluation of the reference and 1e-5-2e-5
from each other in relative L2 over the output's spread: the limit is 5e-5.
Gradients compare in float64 on both sides, the reference's sites unscaled
as the port's are: a leaky ReLU input within the two sides' distance of 0
(a few of a forward's million in float32, or where the eps of an
InstanceNorm after a rescaled site moves it by 1e-5) takes the other slope
on one side, which moves every leaf upstream of it by 0.01-3% (measured:
the float32 reference alone sits that far from its float64 gradient on some
seeds). So compared, the two agree to 1e-13 but for the port's loss, which
rounds through float32 (ops/losses.py): the limit per leaf is 1e-5.
test_bf16_swin_fails_the_tolerances checks that a reference whose Swin
linear layers run in bf16 is far outside them.
"""

from __future__ import annotations

import math
import os
import sys
from os.path import join
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import swinunetr as R  # noqa: E402
from benchmark.reference import transunet as RT  # noqa: E402
from unet_research_tpu_torch.models import (  # noqa: E402
    DropBlockConfig,
    SwinUNETRConfig,
    build_model,
    param_count,
)
from unet_research_tpu_torch.models import swin_unetr as S  # noqa: E402
from unet_research_tpu_torch.models.sites import draw_site_keys  # noqa: E402
from unet_research_tpu_torch.ops import attention  # noqa: E402
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig  # noqa: E402
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine  # noqa: E402

TINY = dict(feature_size=16, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8), window=7, mlp_ratio=4,
            output_channels=1)
REF_CFG = dict(TINY, init_channels=1, dropblock=dict(kind="dependent", block_size=3))
PUBLISHED = dict(feature_size=48, depths=(2, 2, 2, 2), heads=(3, 6, 12, 24), window=7,
                 mlp_ratio=4, output_channels=1, init_channels=1)
FWD_TOL, GRAD_TOL = 5e-5, 1e-5
BLOCK, P_DROP = 3, 0.2
# input sizes: padded to 160 x 128 (stage grids 80x64 .. 10x8, each padded to
# the window and shifted) and to 96 x 96 (the last stage's 6 x 6 grid clips
# the window, unshifted)
SIZES = {"padded": (150, 120), "clipped": (90, 96)}


def port_cfg(mask_impl: str = "fused", use_scheduler: bool = False, **kw) -> SwinUNETRConfig:
    db = DropBlockConfig(kind="dependent", block_size=BLOCK, mask_impl=mask_impl, drop_prob=P_DROP,
                         use_scheduler=use_scheduler, max_drop_prob=P_DROP, nr_steps=3)
    return SwinUNETRConfig(**TINY, dropblock=db, **kw)


def weights(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init, fan in R.param_specs(REF_CFG):
        if init == "uniform":
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * math.sqrt(6.0 / fan)
        elif init == "one":
            out[name] = 1 + 0.2 * torch.randn(shape, generator=g)
        elif init == "zero":
            out[name] = 0.2 * torch.randn(shape, generator=g)
        else:
            out[name] = torch.randn(shape, generator=g)
    return out


def model_with(params: dict, **kw):
    model = build_model(port_cfg(**kw), device="cpu")
    model.load_state_dict(params)
    return model


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 over the reference's spread about its mean."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want - want.mean()))


def image(seed: int, n: int = 1, h: int = 150, w: int = 120) -> torch.Tensor:
    return torch.rand((n, h, w, 1), generator=torch.Generator().manual_seed(seed))


class _Bf16Linear:
    """torch.nn.functional with linear in bf16 (the reference's Swin in bf16:
    the CNN has no linear layer)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def linear(x, w, b=None):
        return F.linear(x.bfloat16(), w.bfloat16(),
                        None if b is None else b.bfloat16()).to(x.dtype)


# --- the forward ------------------------------------------------------------------

@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
@pytest.mark.parametrize("size", list(SIZES.values()), ids=list(SIZES))
def test_forward_matches_reference(masks, size):
    """The reference's exact per-sample rescale at every site against the
    port's, which leaves it out (each site feeds InstanceNorms only)."""
    params = weights(1)
    model = model_with(params)
    x = image(2, n=2, h=size[0], w=size[1])
    keys = draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = model(x, drop_prob=P_DROP if masks else None, site_keys=keys if masks else None)
        want = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK) if masks else None)
        plain = model(x)
    assert got.shape == want.shape == (2, *size, 1)
    assert gap(got, want) < FWD_TOL
    if masks:  # the masks move the output
        assert gap(plain, want) > 100 * FWD_TOL


@pytest.mark.parametrize("mask_impl", ["fused", "kernel", "elementwise"])
def test_mask_routes_agree(mask_impl):
    """K1's plain version, the mask producer's and the plain DropBlock give
    one forward (the same hash, the rescale left out alike)."""
    params = weights(4)
    x = image(5, n=2, h=96, w=96)
    keys = draw_site_keys(R.num_sites(REF_CFG), torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = model_with(params, mask_impl=mask_impl)(x, drop_prob=P_DROP, site_keys=keys)
    want = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
    assert gap(got, want) < FWD_TOL


def test_bf16_swin_fails_the_tolerances():
    """The tolerances have teeth: the reference with its Swin's linear layers
    in bf16 is far outside them, forward and gradient."""
    params = weights(1)
    x = image(2, n=2)
    keys = draw_site_keys(R.num_sites(REF_CFG), torch.Generator().manual_seed(3))
    want = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
    params64, x64 = {k: v.double() for k, v in params.items()}, x.double()
    R.F = _Bf16Linear()
    try:
        bf16 = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
        grads16 = _reference_grads(params64, x64, keys)
    finally:
        R.F = F
    assert gap(bf16, want) > 10 * FWD_TOL
    grads = _reference_grads(params64, x64, keys)
    worst = max(_leaf_gap(grads16[k], grads[k]) for k in grads)
    assert worst > 10 * GRAD_TOL


# --- the windows ------------------------------------------------------------------

@pytest.mark.parametrize("window", [7, 4])
def test_relative_position_index_matches_reference(window):
    """MONAI's index: offsets (dy, dx) shifted by window - 1, row-major in a
    (2 window - 1)^2 table; 84 (the centre, no offset) on the diagonal."""
    got = S.relative_position_index(window)
    assert torch.equal(got, R.relative_position_index(window))
    t = window * window
    assert got.shape == (t, t) and int(got.max()) == (2 * window - 1) ** 2 - 1
    assert set(torch.diagonal(got).tolist()) == {(window - 1) * (2 * window - 1) + window - 1}
    assert int(got[0, t - 1]) == 0  # the first token against the last: offset (-w+1, -w+1)


@pytest.mark.parametrize("grid", [(80, 64), (40, 32), (10, 8), (6, 6), (12, 5), (304, 288),
                                  (38, 36)])
def test_grid_matches_compute_mask(grid):
    """The port's windows against MONAI's rules (the reference's): the
    clipped window and shift, the shifted block's mask with -100.0 between
    regions, and the gathers equal to pad -> roll -> partition and back."""
    h, w = grid
    g = S.make_grid(h, w, 7, "cpu")
    ws, ss = R.window_geometry(h, w, 7)
    assert g.ws == ws and S.window_geometry(h, w, 7) == (ws, ss)
    hp, wp = -(-h // ws[0]) * ws[0], -(-w // ws[1]) * ws[1]
    assert g.nw == (hp // ws[0]) * (wp // ws[1])
    if any(ss):
        want = R.compute_mask(hp, wp, ws, ss)
        assert torch.equal(g.mask, want) and set(want.unique().tolist()) == {0.0, -100.0}
    else:
        assert g.mask is None
    x = torch.randn((2, h, w, 3))
    for shifted in (False, True):
        s = ss if shifted else (0, 0)
        padded = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        rolled = torch.roll(padded, shifts=(-s[0], -s[1]), dims=(1, 2))
        want = R._partition(rolled, ws).view(2, g.nw, ws[0] * ws[1], 3).transpose(1, 2)
        rows = F.pad(x.reshape(2, h * w, 3), (0, 0, 0, 1))
        win = rows.index_select(1, g.into[shifted])
        assert torch.equal(win, want.reshape(2, -1, 3))
        assert torch.equal(win.index_select(1, g.back[shifted]).view(2, h, w, 3), x)


def test_window_attention_cpu_matches_written_out_softmax():
    """ops/attention.py with a bias on the CPU: softmax(q k^T / 4 + bias) v
    with a per-window bias broadcast over the batch, -100.0 entries included,
    against the softmax written out; it counts nothing off the card."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((3, 10, 49, 16), generator=g) for _ in range(3))
    bias = torch.randn((1, 10, 49, 49), generator=g)
    bias[0, :, :20, 30:] = -100.0
    before = dict(attention.calls)
    got = attention.attention(q, k, v, bias)
    want = torch.softmax(q @ k.transpose(-1, -2) / 4.0 + bias, dim=-1) @ v
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    assert attention.calls == before


# --- the published configuration ------------------------------------------------

def test_published_configuration():
    """15 mask sites and 25,137,931 parameters under the reference's names and
    shapes (the Swin encoder 6,306,810), the sites at DRIVE's 608 x 576
    canvas, the stage grids each padded to the 7 x 7 window, and about 189
    GFLOP a member."""
    with torch.device("meta"):
        model = build_model(SwinUNETRConfig(), device="meta")
    assert model.num_mask_sites() == R.num_sites(PUBLISHED) == 15
    specs = R.param_specs(PUBLISHED)
    sd = model.state_dict()
    assert set(sd) == {name for name, *_ in specs} and len(sd) == len(specs)
    assert all(tuple(sd[name].shape) == tuple(shape) for name, shape, *_ in specs)
    assert param_count(model) == 25_137_931
    swin = sum(p.numel() for n, p in model.named_parameters()
               if n.startswith(("layers.", "patch_embed.")))
    assert swin == 6_306_810
    assert R.canvas(584, 565) == (608, 576)
    sites = R.mask_sites(PUBLISHED, 608, 576)
    assert len(sites) == 15 and sites[0] == (608, 576, 48) and sites[4] == (19, 18, 768)
    assert sites[5] == (38, 36, 768) and sites[-2:] == [(608, 576, 96), (608, 576, 48)]
    assert [g[2:4] for g in R.swin_grids(PUBLISHED, 608, 576)] == [(308, 294), (154, 147),
                                                                    (77, 77), (42, 42)]
    assert 185e9 < R.model_flops(PUBLISHED, 608, 576) < 192e9


def test_model_flops_hand_count():
    """model_flops at the DRIVE canvas against a count by part: the Swin's
    linears (qkv and proj on the padded windows' tokens, MLP on the grid's),
    its attention products, the merges, and the CNN's convs."""
    c = [48, 96, 192, 384, 768]
    grids = [(304, 288, 308, 294), (152, 144, 154, 147), (76, 72, 77, 77), (38, 36, 42, 42)]
    swin = 304 * 288 * 48 * 4
    for s, (h, w, hp, wp) in enumerate(grids):
        swin += 2 * (hp * wp * (4 * c[s] ** 2 + 2 * 49 * c[s]) + h * w * 8 * c[s] ** 2)
        swin += (h // 2) * (w // 2) * 8 * c[s] ** 2
    cnn = 608 * 576 * 48 * (9 + 9 * 48 + 1) + 304 * 288 * 48 * 18 * 48
    cnn += 152 * 144 * 96 * 18 * 96 + 76 * 72 * 192 * 18 * 192 + 19 * 18 * 768 * 18 * 768
    for (h, w), cin, cout in zip(((38, 36), (76, 72), (152, 144), (304, 288), (608, 576)),
                                 (768, 384, 192, 96, 48), (384, 192, 96, 48, 48)):
        cnn += h * w * cout * (cin + 18 * cout + 9 * cout + 2 * cout)
    cnn += 608 * 576 * 48
    assert R.model_flops(PUBLISHED, 608, 576) == 2.0 * (swin + cnn)


# --- the engines and the trainer ----------------------------------------------------

def _moments(outs: list) -> tuple:
    o = torch.cat(outs).to(torch.float64)
    return o.mean(0), o.std(0, unbiased=True)


@pytest.mark.parametrize("program", [True, False], ids=["program", "host"])
def test_mc_engine_matches_reference(program):
    """4 members in chunks of 2 through MCDropBlockEngine: the chunks' site
    keys drawn in order from the call's generator, member j of a chunk at
    row j; mean and unbiased std against the reference's members."""
    params = weights(10)
    model = model_with(params).eval()
    x = image(11)
    mask = (torch.rand((1, 150, 120, 1), generator=torch.Generator().manual_seed(12)) > 0.2)
    mask = mask.to(torch.float32)
    engine = MCDropBlockEngine(model, num_iterations=4, return_num=0, chunk=2, device="cpu",
                               program=program)
    mean, std = engine.predict(x, x, mask, P_DROP, generator=torch.Generator().manual_seed(13))[:2]
    gen = torch.Generator().manual_seed(13)
    outs = []
    for _ in range(2):
        keys = draw_site_keys(R.num_sites(REF_CFG), gen)
        outs.append(R.forward(params, x.expand(2, -1, -1, -1), REF_CFG,
                              R.Drop(keys, P_DROP, BLOCK)) * mask)
    want_mean, want_std = _moments(outs)
    assert gap(mean[0], want_mean) < FWD_TOL
    assert gap(std[0], want_std) < 10 * FWD_TOL  # the spread of 4 members: a 10x smaller scale


def _rotate(img: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """NHWC rotated CCW by each angle about ((W-1)/2, (H-1)/2), bilinear, zero
    outside (the reference's rotation, Rotational_Uncertainty.py:36-68)."""
    n, h, w, c = img.shape
    a = degrees.to(torch.float64).reshape(-1, 1, 1) * (math.pi / 180.0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float64)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float64)[None, :] - cx
    src_x = torch.cos(a) * xx - torch.sin(a) * yy + cx
    src_y = torch.sin(a) * xx + torch.cos(a) * yy + cy
    grid = torch.stack([src_x * (2.0 / (w - 1)) - 1.0, src_y * (2.0 / (h - 1)) - 1.0], dim=-1)
    src = img.permute(0, 3, 1, 2).expand(a.shape[0], -1, -1, -1)
    out = F.grid_sample(src, grid.to(img.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


@pytest.mark.parametrize("program", [True, False], ids=["program", "host"])
def test_rotational_engine_matches_reference(program):
    """A 5-angle rotational ensemble (gather warp, DropBlock off) in chunks of
    2 through RotationalEngine: member k rotates by k degrees, runs the model
    and rotates back; mean and std against the reference's. The warps agree
    to float32 rounding, so the limits are the forward's, 10x for the std."""
    params = weights(14)
    model = model_with(params).eval()
    x = image(15)
    mask = torch.ones((1, 150, 120, 1))
    engine = RotationalEngine(model, num_iterations=5, return_num=0, chunk=2, warp="gather",
                              device="cpu", program=program)
    mean, std = engine.predict(x, x, mask)[:2]
    angles = torch.arange(1, 6, dtype=torch.float64)
    seg = R.forward(params, _rotate(x, angles), REF_CFG, None)
    want_mean, want_std = _moments([_rotate(seg, -angles) * mask])
    assert gap(mean[0], want_mean) < FWD_TOL
    assert gap(std[0], want_std) < 10 * FWD_TOL


def _bce(seg, gt, mask) -> torch.Tensor:
    """The masked BCE rescaled by numel / nonzero (utils_training.py:21-39),
    log clamped at -100."""
    p, t = seg * mask, gt * mask

    def log(v):
        return torch.clamp(torch.log(v), min=-100.0)

    return -(t * log(p) + (1 - t) * log(1 - p)).sum() / (mask != 0).sum()


class _Unscaled(R.Drop):
    """The reference's DropBlock without the per-sample rescale, as the
    port's sites have it."""

    def __call__(self, x: torch.Tensor, site: int) -> torch.Tensor:
        n, c, h, w = x.shape
        k0, k1 = self.keys[site]
        thresh = RT.threshold(RT.gamma_of(self.drop_prob, h, w, self.block))
        return x * RT.keep_mask((n, h, w, c), k0, k1, thresh, self.block, self.offset, x.device)


def _reference_grads(params, x, keys, gt=None, mask=None) -> dict:
    """The reference's gradients in the dtype of `params` and x, its sites
    unscaled (the module docstring says why)."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    seg = R.forward(p, x, REF_CFG, _Unscaled(keys, np.float32(P_DROP), BLOCK))
    gt = (x > 0.5).to(x.dtype) if gt is None else gt
    mask = torch.ones_like(x) if mask is None else mask
    _bce(seg, gt, mask).backward()
    return {k: v.grad for k, v in p.items() if v.grad is not None}


def _leaf_gap(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).to(torch.float64))
                 / torch.linalg.vector_norm(want.to(torch.float64)).clamp(min=1e-30))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_trainer_step_gradients(remat):
    """One SGD step of Trainer.train_step (the mask producer's masks) of a
    float64 model: the momentum buffer after one step is the gradient, per
    leaf against the float64 reference's autograd (the module docstring says
    why float64)."""
    params = {k: v.double() for k, v in weights(16).items()}
    model = model_with(params, remat=remat, dtype=torch.float64).double()
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(lr=1e-3, momentum=0.9,
                                                             auto_lr_find=False, verbose=False),
                      device="cpu")
    state = trainer.create_state(None, 1e-3)
    x = image(17, h=90, w=96).double()
    gt, mask = (x > 0.5).double(), torch.ones_like(x)
    keys = draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(18))
    trainer.train_step(state, x, gt, mask, 1e-3, site_keys=keys,
                       drop_prob=torch.tensor(P_DROP, dtype=torch.float32))
    names = [n for n, q in model.named_parameters() if q.requires_grad]
    got = dict(zip(names, state.momentum_buffers()))
    want = _reference_grads(params, x, keys, gt, mask)
    assert set(got) == set(want)
    worst = max(_leaf_gap(got[k], want[k]) for k in want)
    assert worst < GRAD_TOL, worst


def test_init_params_builds_the_configured_model():
    """Trainer.init_params builds a SwinUNETR of the model's own config: the
    tables N(0, 0.02), the LayerNorms ones and zeros, InstanceNorm outside
    the state_dict."""
    model = build_model(port_cfg(), device="cpu")
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(auto_lr_find=False, verbose=False),
                      device="cpu")
    sd = trainer.init_params(3)
    assert list(sd) == list(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    table = sd["layers.0.blocks.0.attn.relative_position_bias_table"]
    assert 0.01 < float(table.std()) < 0.03
    assert torch.equal(sd["layers.3.downsample.norm.weight"], torch.ones(16 * 8 * 4))
    assert not any("norm1" in k for k in sd if k.startswith("encoder"))


def test_trainer_epochs_scanned_and_stepped():
    """A scanned epoch and a stepped epoch (the step program's, as `fit` runs
    them) of two items from the same weights and seed: the same losses and
    parameters; then a stepped epoch under a size plan (the windows of the
    smaller canvas built for it) stays finite."""
    params = weights(19)
    data = tuple(torch.from_numpy(np.random.default_rng(20).integers(0, 256, (2, 90, 96, 1),
                                                                     dtype=np.uint8))
                 for _ in range(3))
    runs = []
    for scan in (True, False):
        model = model_with(params, use_scheduler=True)
        trainer = Trainer(model, POLICIES["uni"], TrainerConfig(lr=1e-3, auto_lr_find=False,
                                                                verbose=False, seed=21,
                                                                scan_epochs=scan),
                          device="cpu")
        state = trainer.create_state(None, 1e-3)
        order = np.arange(2)
        if scan:
            losses = trainer.train_epoch_scan(state, data, order, 1e-3)
        else:
            losses = trainer._step_epoch(state, data, order, None, 1e-3, None, False, None, 0)
        runs.append((np.asarray(losses), [p.detach().clone() for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    np.testing.assert_array_equal(l0[1:], l1)  # the stepped epoch keeps the log gate's losses
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    plan = np.array([64, -1])
    losses = trainer._step_epoch(state, data, np.arange(2), None, 1e-3, plan, False, None, 1)
    assert np.isfinite(losses).all() and state.step == 4
    assert {k[:2] for k in model.grids} >= {(32, 32), (48, 48)}


def test_training_cli_arch_flag(tmp_path):
    """`training -arch swin_unetr` for one epoch on a tiny tree: the paper's
    feature size 48 (block size 1: the 1 x 1 maps at a 32 x 32 frame's
    fifth halving take no larger block)."""
    from PIL import Image

    from unet_research_tpu_torch.cli import training
    from unet_research_tpu_torch.train.checkpoint import find_checkpoint
    from unet_research_tpu_torch.utils.convert import load_model_checkpoint

    rng = np.random.default_rng(0)
    root = tmp_path / "aug"
    for split, n, targets in [("train", 3, True), ("val", 1, True), ("test", 1, False)]:
        d = root / split
        for sub in ("images", "masks") + (("targets",) if targets else ()):
            (d / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32)).astype(np.uint8)).save(
                d / "images" / f"{i}_image.png")
            Image.fromarray(np.full((32, 32), 255, np.uint8)).save(d / "masks" / f"{i}_mask.png")
            if targets:
                Image.fromarray(((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8)).save(
                    d / "targets" / f"{i}_target.png")
    out = training.main(["-mode", "train", "-data_path", str(root), "-save_path",
                         str(tmp_path / "swin"), "-num_epochs", "1", "-seed", "7", "-arch",
                         "swin_unetr", "-block_size", "1", "--auto_lr_find", "False",
                         "-device", "cpu"])
    sd, meta = load_model_checkpoint(find_checkpoint(join(out, "model_info")), None)
    assert meta["epoch"] == 0 and "layers.3.blocks.1.attn.qkv.weight" in sd
    assert tuple(sd["layers.0.blocks.0.attn.qkv.weight"].shape) == (144, 48)
    assert tuple(sd["decoder1.conv_block.conv1.weight"].shape) == (48, 96, 3, 3)
    seg = torch.load(join(out, "statistics", "val_images", "tensors", "image_0",
                          "segmentation.pt"))
    assert tuple(seg.shape) == (1, 32, 32) and torch.isfinite(seg).all()
    assert os.path.isdir(join(out, "statistics", "test_images"))
