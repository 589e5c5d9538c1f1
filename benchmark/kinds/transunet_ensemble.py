"""The "transunet_ensemble" kind: the "ensemble" kind (kinds/ensemble.py) on
TransUNet R50-ViT-B/16 (unet_research_tpu_torch/models/transunet.py). It
changes only the weights (reference/transunet.py's parameters, drawn on the
device from the seed), the model (the port's TransUNet of the
configuration) and the reference (reference/transunet.py's forward in the
MC-DropBlock and rotational ensembles of reference/tasks.py). Its traffic
states `batch` 1 besides: one image a predict, as the ensemble kind runs
them.

The profiled slice's work carries no U-Net sites: `forwards` (the batch
sizes of its member forwards) and `transunet` True; the readers of
benchmark/metrics/*.transunet.py compute its bounds from it through the
Cell's member_flops, attention_bound and k1_bound (the functions below).
"""

from __future__ import annotations

import math

import torch

from benchmark import cells, roofline
from benchmark.reference import tasks, transunet

ensemble = cells.kind("ensemble")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: tensor} on the device from the seed: one uniform draw scaled
    per leaf to U(+-1/sqrt(fan_in)) (conv and linear weights and biases), the
    positions N(0, 0.02), BatchNorm's running mean U(-0.1, 0.1) and variance
    U(0.5, 1.5), norm weights 1 and biases 0."""
    specs = transunet.param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(cells.derive(seed, "weights"))
    uniform = [(n, s, f) for n, s, init, f in specs if init == "uniform"]
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan in uniform:
        size = math.prod(shape)
        out[name] = ((u[at:at + size] * 2.0 - 1.0) / math.sqrt(fan)).reshape(shape)
        at += size
    for name, shape, init, _ in specs:
        if init == "pos":
            out[name] = 0.02 * torch.randn(shape, generator=gen, device=device)
        elif init == "mean":
            out[name] = torch.rand(shape, generator=gen, device=device) * 0.2 - 0.1
        elif init == "var":
            out[name] = torch.rand(shape, generator=gen, device=device) + 0.5
        elif init == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif init in ("one", "zero"):
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=device)
    return {n: out[n] for n, *_ in specs}


def port_model(cfg: dict, weights: dict, device):
    """The port's TransUNet of the configuration, holding `weights`."""
    from unet_research_tpu_torch.models import DropBlockConfig, TransUNetConfig, build_model

    db = cfg["dropblock"]
    tcfg = TransUNetConfig(
        output_channels=cfg["output_channels"],
        width=cfg["width"], units=tuple(cfg["units"]), hidden=cfg["hidden"],
        layers=cfg["layers"], heads=cfg["heads"], mlp=cfg["mlp"],
        head_channels=cfg["head_channels"], decoder=tuple(cfg["decoder"]), n_skip=cfg["n_skip"],
        grid=tuple(cfg["grid"]), gn_groups=cfg["gn_groups"], dropout=cfg["dropout"],
        dropblock=DropBlockConfig(kind=db["kind"], block_size=db["block_size"],
                                  mask_impl=db["mask_impl"]),
        remat=cfg["remat"], dtype=getattr(torch, cfg["dtype"]))
    with torch.device(device):
        model = build_model(tcfg, device=device)
    model.load_state_dict(weights)
    return model


# --- the bounds of the profiled slice ------------------------------------------------

def attention_bound(cfg: dict, h: int, w: int, forwards: list) -> tuple:
    """(calls, seconds): the attention calls of the member forwards of batch
    sizes `forwards` on an h x w frame, and the least seconds their FLOP
    (QK^T and AV, 4 x B x heads x T^2 x head size a call) take at the
    card's bf16 peak."""
    ch, cw = transunet.canvas(h, w)
    t, d = (ch // 16) * (cw // 16), cfg["hidden"]
    flop = sum(4.0 * n * t * t * d for n in forwards) * cfg["layers"]
    return cfg["layers"] * len(forwards), flop / roofline.PEAK_FLOPS


def k1_bound(cfg: dict, h: int, w: int, forwards: list) -> tuple:
    """(launches, seconds): K1 at each of TransUNet's mask sites in each
    member forward, the bytes of roofline.k1_bound at the site's shape."""
    sites = transunet.mask_sites(cfg, *transunet.canvas(h, w))
    seconds = sum(roofline.k1_bound(n, *s) for n in forwards for s in sites)
    return len(sites) * len(forwards), seconds


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOP of one member forward of an h x w frame on its padded canvas."""
    return transunet.model_flops(cfg, *transunet.canvas(h, w))


@tasks.plain_float32()
@torch.no_grad()
def mc_ensemble(params, cfg, image, mask, key_seed: int, members: int, chunk: int,
                drop_prob: float, block: int, rows: int = 8, quant: bool = False) -> tuple:
    """tasks.mc_ensemble on reference/transunet.py's forward."""
    gen = torch.Generator().manual_seed(key_seed)
    acc = tasks.Moments()
    for size in tasks.chunk_sizes(members, chunk):
        drop_keys = tasks.draw_keys(gen, transunet.num_sites(cfg))
        for r in range(0, size, rows):
            n = min(rows, size - r)
            drop = transunet.Drop(drop_keys, drop_prob, block, sample_offset=r)
            acc.add(transunet.forward(params, image.expand(n, -1, -1, -1), cfg, drop, quant)
                    * mask)
    return acc.result()


@tasks.plain_float32()
@torch.no_grad()
def rot_ensemble(params, cfg, image, mask, members: int, rows: int = 8,
                 quant: bool = False) -> tuple:
    """tasks.rot_ensemble on reference/transunet.py's forward."""
    acc = tasks.Moments()
    for r in range(1, members + 1, rows):
        angles = torch.arange(r, min(r + rows, members + 1), dtype=torch.float64)
        seg = transunet.forward(params, tasks.rotate(image, angles), cfg, None, quant)
        acc.add(tasks.rotate(seg, -angles) * mask)
    return acc.result()


class Cell(ensemble):
    def inputs(self) -> None:
        self.weights = make_weights(self.cfg, self.seed, self.device)
        self.images, self.targets, self.masks = cells.make_frames(self.traffic, self.seed,
                                                                  self.device)
        self.answers = []

    def setup(self) -> None:
        t = self.traffic
        self.inputs()
        self.phase("inputs")
        self.model = port_model(self.cfg, self.weights, self.device)
        self.model.eval()
        common = dict(num_iterations=t["members"], return_num=0, resize=-1, chunk=t["chunk"],
                      device=self.device)
        if t["engine"] == "mc":
            from unet_research_tpu_torch.uncertainty import MCDropBlockEngine

            self.engine = MCDropBlockEngine(self.model, **common)
        else:
            from unet_research_tpu_torch.uncertainty import RotationalEngine

            self.engine = RotationalEngine(self.model, warp=t["warp"], **common)
        self.phase("model and engine")
        self.predict(-1)  # the warm-up image: every chunk shape runs and the body is captured
        self.phase("warm-up image")

    # the bounds that the readers of benchmark/metrics/*.transunet.py read
    def member_flops(self) -> float:
        return forward_flops(self.cfg, self.traffic["height"], self.traffic["width"])

    def attention_bound(self, forwards: list) -> tuple:
        return attention_bound(self.cfg, self.traffic["height"], self.traffic["width"], forwards)

    def k1_bound(self, forwards: list) -> tuple:
        return k1_bound(self.cfg, self.traffic["height"], self.traffic["width"], forwards)

    def profile_work(self) -> tuple:
        run, work = super().profile_work()
        work.update(dropblock=False, transunet=True)
        return run, work

    def reference(self, f: int, i: int, quant: bool) -> tuple:
        t = self.traffic
        sl = slice(f, f + 1)
        image, mask = self.images[sl], self.masks[sl][0]
        if t["engine"] == "mc":
            return mc_ensemble(self.weights, self.cfg, image, mask, self.key_seed(i),
                               t["members"], t["chunk"], t["drop_prob"],
                               self.cfg["dropblock"]["block_size"], t["reference_rows"], quant)
        return rot_ensemble(self.weights, self.cfg, image, mask, t["members"],
                            t["reference_rows"], quant)
