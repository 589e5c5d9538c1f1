"""The "swinunetr_ensemble" kind: the "ensemble" kind (kinds/ensemble.py) on
Swin UNETR (unet_research_tpu_torch/models/swin_unetr.py). It changes only
the weights (reference/swinunetr.py's parameters, drawn on the device from
the seed), the model (the port's SwinUNETR of the configuration) and the
reference (reference/swinunetr.py's forward in the rotational ensemble of
reference/tasks.py). Its traffic states `batch` 1 besides: one image a
predict, as the ensemble kind runs them. It runs the rotational engine
alone: the mask sites lie outside the Swin encoder, so MC members would
share its output, and no cell scores Swin UNETR by MC-DropBlock.

The profiled slice's work carries no U-Net sites: `forwards` (the batch
sizes of its member forwards) and `swinunetr` True; the readers of
benchmark/metrics/*.swinunetr.py compute its bounds from it through the
Cell's member_flops and window_attention_bound (the functions below).
"""

from __future__ import annotations

import math

import torch

from benchmark import cells, roofline
from benchmark.reference import swinunetr, tasks

ensemble = cells.kind("ensemble")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: tensor} on the device from the seed: one uniform draw scaled
    per leaf to U(+-1/sqrt(fan_in)) (conv, transposed conv and linear
    weights and biases), the relative-position tables N(0, 0.02), LayerNorm
    weights 1 and biases 0."""
    specs = swinunetr.param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(cells.derive(seed, "weights"))
    uniform = [(n, s, f) for n, s, init, f in specs if init == "uniform"]
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, fan in uniform:
        size = math.prod(shape)
        out[name] = ((u[at:at + size] * 2.0 - 1.0) / math.sqrt(fan)).reshape(shape)
        at += size
    for name, shape, init, _ in specs:
        if init == "table":
            out[name] = 0.02 * torch.randn(shape, generator=gen, device=device)
        elif init in ("one", "zero"):
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=device)
    return {n: out[n] for n, *_ in specs}


def port_model(cfg: dict, weights: dict, device):
    """The port's SwinUNETR of the configuration, holding `weights`."""
    from unet_research_tpu_torch.models import DropBlockConfig, SwinUNETRConfig, build_model

    db = cfg["dropblock"]
    scfg = SwinUNETRConfig(
        input_channels=cfg["init_channels"], output_channels=cfg["output_channels"],
        feature_size=cfg["feature_size"], depths=tuple(cfg["depths"]),
        heads=tuple(cfg["heads"]), window=cfg["window"], mlp_ratio=cfg["mlp_ratio"],
        dropblock=DropBlockConfig(kind=db["kind"], block_size=db["block_size"],
                                  mask_impl=db["mask_impl"]),
        remat=cfg["remat"], dtype=getattr(torch, cfg["dtype"]))
    with torch.device(device):
        model = build_model(scfg, device=device)
    model.load_state_dict(weights)
    return model


# --- the bounds of the profiled slice ------------------------------------------------

def window_attention_bound(cfg: dict, h: int, w: int, forwards: list) -> tuple:
    """(calls, seconds): the window attention calls of the member forwards of
    batch sizes `forwards` on an h x w frame, and the least seconds they take
    on the card, each call at roofline.bound of its bytes (q, k, v read and
    o written once over the padded windows, 4 x N x windows x T x C in the
    compute dtype, the relative-position table and, in a shifted block, the
    mask once) and FLOP (q k^T and A v, 4 x N x windows x heads x T^2 x head
    size)."""
    item = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
    calls, seconds = 0, 0.0
    for s, (gh, gw, hp, wp, wh, ww) in enumerate(swinunetr.swin_grids(
            cfg, *swinunetr.canvas(h, w))):
        c, heads, t = cfg["feature_size"] << s, cfg["heads"][s], wh * ww
        nw = (hp // wh) * (wp // ww)
        shifts = gh > cfg["window"] or gw > cfg["window"]
        for b in range(cfg["depths"][s]):
            table = (2 * cfg["window"] - 1) ** 2 * heads * item
            mask = nw * t * t * item if (b % 2 and shifts) else 0
            for n in forwards:
                nbytes = 4 * n * nw * t * c * item + table + mask
                seconds += roofline.bound(nbytes, 4.0 * n * nw * heads * t * t * (c // heads))
                calls += 1
    return calls, seconds


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOP of one member forward of an h x w frame on its padded canvas."""
    return swinunetr.model_flops(cfg, *swinunetr.canvas(h, w))


@tasks.plain_float32()
@torch.no_grad()
def rot_ensemble(params, cfg, image, mask, members: int, rows: int = 8,
                 quant: bool = False) -> tuple:
    """tasks.rot_ensemble on reference/swinunetr.py's forward."""
    acc = tasks.Moments()
    for r in range(1, members + 1, rows):
        angles = torch.arange(r, min(r + rows, members + 1), dtype=torch.float64)
        seg = swinunetr.forward(params, tasks.rotate(image, angles), cfg, None, quant)
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
        if t["engine"] != "rot":
            raise ValueError(f"swinunetr_ensemble runs the rotational engine, not {t['engine']!r}")
        self.inputs()
        self.phase("inputs")
        self.model = port_model(self.cfg, self.weights, self.device)
        self.model.eval()
        from unet_research_tpu_torch.uncertainty import RotationalEngine

        self.engine = RotationalEngine(self.model, num_iterations=t["members"], return_num=0,
                                       resize=-1, chunk=t["chunk"], device=self.device,
                                       warp=t["warp"])
        self.phase("model and engine")
        self.predict(-1)  # the warm-up image: every chunk shape runs and the body is captured
        self.phase("warm-up image")

    # the bounds that the readers of benchmark/metrics/*.swinunetr.py read
    def member_flops(self) -> float:
        return forward_flops(self.cfg, self.traffic["height"], self.traffic["width"])

    def window_attention_bound(self, forwards: list) -> tuple:
        return window_attention_bound(self.cfg, self.traffic["height"], self.traffic["width"],
                                      forwards)

    def profile_work(self) -> tuple:
        run, work = super().profile_work()
        work.update(dropblock=False, swinunetr=True)
        return run, work

    def reference(self, f: int, i: int, quant: bool) -> tuple:
        t = self.traffic
        sl = slice(f, f + 1)
        image, mask = self.images[sl], self.masks[sl][0]
        return rot_ensemble(self.weights, self.cfg, image, mask, t["members"],
                            t["reference_rows"], quant)
