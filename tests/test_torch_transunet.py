"""TransUNet R50-ViT-B/16 (models/transunet.py) against its plain float32
reference (the benchmark's, benchmark/reference/transunet.py), at a small
size on the CPU: the forward without and with masks, the MC-DropBlock and
rotational engines, one SGD step's gradients through the Trainer, the
published configuration's sites, parameters and FLOP, and the training
CLI's -arch flag.

The weights of the comparisons are He-uniform (U(+-sqrt(6 / fan_in))) with
perturbed norm parameters and BatchNorm statistics, so that the ViT's share
of the output stays visible through the BatchNorm decoder (with torch's
default bound the decoder damps it below float32's rounding).

Tolerances: the port and the reference both compute in float32, in other
orders (StdConv through layer_norm, GroupNorm through its coefficients,
SDPA for the plain softmax, no rescale at the unit sites), which puts their
outputs about 1e-6 apart in relative L2 over the output's spread; the
limits allow 2e-5 (forwards, ensembles) and 2e-4 per gradient leaf.
test_bf16_vit_fails_the_tolerances checks that a reference with its ViT's
linear layers in bf16 is 7e-4 away and fails them.
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

from benchmark.reference import transunet as R  # noqa: E402
from unet_research_tpu_torch.models import (  # noqa: E402
    DropBlockConfig,
    TransUNetConfig,
    build_model,
    param_count,
)
from unet_research_tpu_torch.models.sites import draw_site_keys  # noqa: E402
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig  # noqa: E402
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine  # noqa: E402

TINY = dict(width=8, units=(1, 2, 1), hidden=16, layers=2, heads=2, mlp=32, head_channels=16,
            decoder=(16, 8, 8, 4), n_skip=3, grid=(4, 3), gn_groups=4, dropout=0.1,
            output_channels=1)
REF_CFG = dict(TINY, dropblock=dict(kind="dependent", block_size=3))
FWD_TOL, GRAD_TOL = 2e-5, 2e-4
BLOCK, P_DROP = 3, 0.2


def port_cfg(mask_impl: str = "fused", use_scheduler: bool = False, **kw) -> TransUNetConfig:
    db = DropBlockConfig(kind="dependent", block_size=BLOCK, mask_impl=mask_impl, drop_prob=P_DROP,
                         use_scheduler=use_scheduler, max_drop_prob=P_DROP, nr_steps=3)
    return TransUNetConfig(**{k: v for k, v in TINY.items()}, dropblock=db, **kw)


def weights(seed: int, cfg: dict = REF_CFG) -> dict:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init, fan in R.param_specs(cfg):
        if init == "uniform":
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * math.sqrt(6.0 / fan)
        elif init == "one":
            out[name] = 1 + 0.2 * torch.randn(shape, generator=g)
        elif init == "zero":
            out[name] = 0.2 * torch.randn(shape, generator=g)
        elif init == "pos":
            out[name] = torch.randn(shape, generator=g)
        elif init == "mean":
            out[name] = torch.rand(shape, generator=g) * 0.2 - 0.1
        elif init == "var":
            out[name] = torch.rand(shape, generator=g) + 0.5
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64)
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


def image(seed: int, n: int = 1, h: int = 60, w: int = 45) -> torch.Tensor:
    return torch.rand((n, h, w, 1), generator=torch.Generator().manual_seed(seed))


class _Bf16Linear:
    """torch.nn.functional with linear in bf16 (the reference's ViT in bf16)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def linear(x, w, b=None):
        return F.linear(x.bfloat16(), w.bfloat16(), None if b is None else b.bfloat16()).float()


# --- the forward ------------------------------------------------------------------

@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
@pytest.mark.parametrize("size", [(60, 45), (64, 64)], ids=["padded", "square"])
def test_forward_matches_reference(masks, size):
    """The reference's exact per-sample rescale at every site against the
    port's, which leaves it out where only a GroupNorm reads the site."""
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
    one forward (the same hash, the same per-sample rescale)."""
    params = weights(4)
    x = image(5, n=3)
    keys = draw_site_keys(R.num_sites(REF_CFG),
                          torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = model_with(params, mask_impl=mask_impl)(x, drop_prob=P_DROP, site_keys=keys)
    want = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
    assert gap(got, want) < FWD_TOL


def test_bf16_vit_fails_the_tolerances():
    """The tolerances have teeth: the reference with its ViT's linear layers
    in bf16 is far outside them, forward and gradient."""
    params = weights(1)
    x = image(2, n=2)
    keys = draw_site_keys(R.num_sites(REF_CFG), torch.Generator().manual_seed(3))
    want = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
    R.F = _Bf16Linear()
    try:
        bf16 = R.forward(params, x, REF_CFG, R.Drop(keys, P_DROP, BLOCK))
        grads16 = _reference_grads(params, x, keys)
    finally:
        R.F = F
    assert gap(bf16, want) > 10 * FWD_TOL
    grads = _reference_grads(params, x, keys)
    worst = max(_leaf_gap(grads16[k], grads[k]) for k in grads)
    assert worst > 10 * GRAD_TOL


# --- the published configuration ------------------------------------------------

def test_published_configuration():
    """45 mask sites, 106,148,369 parameters under the reference's names and
    shapes (R50 body 23.5M-odd, ViT-B 85M, 1332 positions), and the
    reference's sites at the DRIVE canvas."""
    cfg = TransUNetConfig()
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    ref_cfg = dict(width=64, units=(3, 4, 9), hidden=768, layers=12, heads=12, mlp=3072,
                   head_channels=512, decoder=(256, 128, 64, 16), n_skip=3, grid=(37, 36),
                   gn_groups=32, dropout=0.1, output_channels=1)
    assert model.num_mask_sites() == R.num_sites(ref_cfg) == 45
    specs = R.param_specs(ref_cfg)
    sd = model.state_dict()
    assert set(sd) == {name for name, *_ in specs} and len(sd) == len(specs)
    assert all(tuple(sd[name].shape) == tuple(shape) for name, shape, *_ in specs)
    assert param_count(model) == 106_148_369
    sites = R.mask_sites(ref_cfg, 592, 576)
    assert len(sites) == 45
    assert sites[0] == (296, 288, 64) and sites[1] == (147, 143, 64)  # root, stage 1 unit 1
    assert sites[7] == (147, 143, 128) and sites[8] == (74, 72, 128)  # stage 2's stride
    assert sites[33] == (37, 36, 512)  # conv_more
    assert sites[34] == (74, 72, 1024) and sites[-1] == (592, 576, 16)  # a merge, the last


def test_model_flops_hand_count():
    """model_flops at the DRIVE canvas against a count by layer: root 7x7,
    the units' 1x1/3x3/1x1 and projections, the embedding, 12 ViT layers
    (projections 4 x 768^2, MLP 2 x 768 x 3072 a token, attention 2 x T^2 x
    768), conv_more and the decoder's convs and head."""
    cfg = dict(width=64, units=(3, 4, 9), hidden=768, layers=12, heads=12, mlp=3072,
               head_channels=512, decoder=(256, 128, 64, 16), n_skip=3, grid=(37, 36),
               gn_groups=32, dropout=0.1, output_channels=1)
    root = 296 * 288 * 64 * 3 * 49
    s1 = 147 * 143 * (64 * 64 + 64 * 64 * 9 + 64 * 256 + 64 * 256)  # unit 1 with projection
    s1 += 2 * 147 * 143 * (256 * 64 + 64 * 64 * 9 + 64 * 256)
    s2 = 147 * 143 * 256 * 128 + 74 * 72 * (128 * 128 * 9 + 128 * 512 + 256 * 512)
    s2 += 3 * 74 * 72 * (512 * 128 + 128 * 128 * 9 + 128 * 512)
    s3 = 74 * 72 * 512 * 256 + 37 * 36 * (256 * 256 * 9 + 256 * 1024 + 512 * 1024)
    s3 += 8 * 37 * 36 * (1024 * 256 + 256 * 256 * 9 + 256 * 1024)
    t = 37 * 36
    vit = t * 1024 * 768 + 12 * (t * (4 * 768 * 768 + 2 * 768 * 3072) + 2 * t * t * 768)
    dec = 37 * 36 * 768 * 512 * 9
    dec += 74 * 72 * 9 * 256 * (1024 + 256) + 148 * 144 * 9 * 128 * (512 + 128)
    dec += 296 * 288 * 9 * 64 * (192 + 64) + 592 * 576 * 9 * 16 * (64 + 16)
    dec += 592 * 576 * 9 * 16
    want = 2.0 * (root + s1 + s2 + s3 + vit + dec)
    assert R.model_flops(cfg, 592, 576) == want
    assert 440e9 < want < 470e9  # about 452 GFLOP a member


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
    mask = (torch.rand((1, 60, 45, 1), generator=torch.Generator().manual_seed(12)) > 0.2)
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


def test_rotational_engine_matches_reference():
    """A 3-angle rotational ensemble (gather warp, DropBlock off) through
    RotationalEngine: member k rotates by k degrees, runs the model and
    rotates back; mean and std against the reference's. The warps agree to
    float32 rounding, so the limits are the forward's."""
    params = weights(14)
    model = model_with(params).eval()
    x = image(15)
    mask = torch.ones((1, 60, 45, 1))
    engine = RotationalEngine(model, num_iterations=3, return_num=0, chunk=2, warp="gather",
                              device="cpu")
    mean, std = engine.predict(x, x, mask)[:2]
    angles = torch.arange(1, 4, dtype=torch.float64)
    seg = R.forward(params, _rotate(x, angles), REF_CFG, None)
    want_mean, want_std = _moments([_rotate(seg, -angles) * mask])
    assert gap(mean[0], want_mean) < 10 * FWD_TOL
    assert gap(std[0], want_std) < 10 * FWD_TOL


def _bce(seg, gt, mask) -> torch.Tensor:
    """The masked BCE rescaled by numel / nonzero (utils_training.py:21-39),
    log clamped at -100."""
    p, t = seg * mask, gt * mask

    def log(v):
        return torch.clamp(torch.log(v), min=-100.0)

    return -(t * log(p) + (1 - t) * log(1 - p)).sum() / (mask != 0).sum()


def _reference_grads(params, x, keys, gt=None, mask=None) -> dict:
    p = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in params.items()}
    seg = R.forward(p, x, REF_CFG, R.Drop(keys, np.float32(P_DROP), BLOCK), train=True)
    gt = (x > 0.5).to(torch.float32) if gt is None else gt
    mask = torch.ones_like(x) if mask is None else mask
    _bce(seg, gt, mask).backward()
    return {k: v.grad for k, v in p.items() if v.grad is not None}


def _leaf_gap(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).to(torch.float64))
                 / torch.linalg.vector_norm(want.to(torch.float64)).clamp(min=1e-30))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_trainer_step_gradients(remat):
    """One SGD step of Trainer.train_step (train mode: BatchNorm on batch
    statistics, the mask producer's masks, the ViT's dropout): the momentum
    buffer after one step is the gradient, per leaf against the
    reference's autograd."""
    params = weights(16)
    model = model_with(params, remat=remat)
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(lr=1e-3, momentum=0.9,
                                                             auto_lr_find=False, verbose=False),
                      device="cpu")
    state = trainer.create_state(None, 1e-3)
    x = image(17)
    gt, mask = (x > 0.5).to(torch.float32), torch.ones_like(x)
    keys = draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(18))
    trainer.train_step(state, x, gt, mask, 1e-3, site_keys=keys,
                       drop_prob=torch.tensor(P_DROP, dtype=torch.float32))
    names = [n for n, q in model.named_parameters() if q.requires_grad]
    got = dict(zip(names, state.momentum_buffers()))
    want = _reference_grads(params, x, keys, gt, mask)
    assert set(got) == set(want)
    worst = max(_leaf_gap(got[k], want[k]) for k in want)
    assert worst < GRAD_TOL, worst
    # the running statistics moved once (a remat re-run leaves them alone)
    assert int(model.conv_more["bn"].num_batches_tracked) == 1


def test_init_params_builds_the_configured_model():
    """Trainer.init_params builds a TransUNet of the model's own config."""
    model = build_model(port_cfg(), device="cpu")
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(auto_lr_find=False, verbose=False),
                      device="cpu")
    sd = trainer.init_params(3)
    assert list(sd) == list(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())


def test_training_cli_arch_flag(tmp_path):
    """`training -arch transunet_r50_b16` for one epoch on a tiny tree: the
    ViT at its published widths, the ResNet at -filters 8 -group_norm_groups
    4 (block size 1: the 2 x 2 stage-3 maps take no larger block)."""
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
                         str(tmp_path / "tu"), "-num_epochs", "1", "-seed", "7", "-arch",
                         "transunet_r50_b16", "-filters", "8", "-group_norm_groups", "4",
                         "-block_size", "1", "--auto_lr_find", "False", "-device", "cpu"])
    sd, meta = load_model_checkpoint(find_checkpoint(join(out, "model_info")), None)
    assert meta["epoch"] == 0 and "vit.11.fc2.weight" in sd and "pos" in sd
    assert tuple(sd["vit.0.qkv.weight"].shape) == (2304, 768)
    seg = torch.load(join(out, "statistics", "val_images", "tensors", "image_0",
                          "segmentation.pt"))
    assert tuple(seg.shape) == (1, 32, 32) and torch.isfinite(seg).all()
    assert os.path.isdir(join(out, "statistics", "test_images"))


def test_trainer_epochs_scanned_and_stepped():
    """A scanned epoch and a stepped epoch (the step program's, as `fit` runs
    them) of two items from the same weights and seed: the same losses and
    parameters; then a stepped epoch under a size plan (the position table
    interpolated to the smaller grid) stays finite."""
    params = weights(19)
    data = tuple(torch.from_numpy(np.random.default_rng(20).integers(0, 256, (2, 60, 45, 1),
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
    plan = np.array([48, -1])
    losses = trainer._step_epoch(state, data, np.arange(2), None, 1e-3, plan, False, None, 1)
    assert np.isfinite(losses).all() and state.step == 4


def test_per_sample_scale_rounds_once():
    """A 'sample' site's rescale: each product in float32, rounded once to
    bf16, the same bits through the in-place multiply (the CPU's route) and
    through gn_apply with the identity affine (the card's, here its plain
    version); a scale rounded to bf16 first differs."""
    from unet_research_tpu_torch.models.sites import per_sample
    from unet_research_tpu_torch.ops.cuda.group_norm import gn_apply

    g = torch.Generator().manual_seed(22)
    x = (torch.randn((3, 5, 4, 16), generator=g) * 4).to(torch.bfloat16)
    scale = 1 + torch.rand(3, generator=g)
    want = (x.float() * scale[:, None, None, None]).to(torch.bfloat16)
    ab = torch.stack([torch.ones(3, 16), torch.zeros(3, 16)])
    assert torch.equal(per_sample(x.clone(), scale), want)
    assert torch.equal(gn_apply(x, ab, None, scale, "none"), want)
    assert not torch.equal(x * scale.to(torch.bfloat16)[:, None, None, None], want)
