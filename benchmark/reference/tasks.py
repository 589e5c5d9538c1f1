"""The plain reference of the benchmark's three jobs, on reference/unet.py:
the MC-DropBlock ensemble, the rotational ensemble and the first steps of
SGD training. float32 with TF32 off, or the control's float8 convolutions
(`quant`). Nothing here imports the program under test.

- MC-DropBlock (the reference's Dropblock_Uncertainty.py:48-72, batched as the
  configuration states): members in chunks of `chunk`, each chunk one
  (S, 2) draw of uint32 site-key words from a CPU torch.Generator
  (randint(0, 2^32)), chunk after chunk; member j of a chunk is row j of
  that chunk's batch, where its hash counters start. Each member's output
  is multiplied by the FOV mask; the statistics are the mean and the
  unbiased std over all members.
- Rotational TTA (Rotational_Uncertainty.py:36-68): member k rotates the
  image by k degrees (k = 1..members), CCW about ((W-1)/2, (H-1)/2),
  bilinear with zero fill, runs the forward with DropBlock off, rotates the
  output back by -k degrees, and is multiplied by the mask.
- Training (utils/utils_training.py:21-39): masked BCE with the log clamped at
  -100, rescaled by numel / nonzero(mask) over the whole batch, its
  gradient, then SGD with momentum (v = mu v + g, p -= lr v) at a drop
  probability ramped linearly (float32 arithmetic) over the steps.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import unet


@contextlib.contextmanager
def plain_float32():
    """TF32 off for matmuls and convolutions (float32 is float32); the
    settings are restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def draw_keys(generator: torch.Generator, sites: int) -> torch.Tensor:
    """One (sites, 2) draw of uint32 key words (as int64)."""
    return torch.randint(0, 2**32, (sites, 2), dtype=torch.int64, generator=generator)


def chunk_sizes(total: int, chunk: int) -> list:
    """Full chunks of `chunk` members, then the remainder."""
    return [chunk] * (total // chunk) + ([total % chunk] if total % chunk else [])


class Moments:
    """Running float64 sums of member outputs for the mean and unbiased std."""

    def __init__(self):
        self.n, self.s1, self.s2 = 0, None, None

    def add(self, outs: torch.Tensor) -> None:
        o = outs.to(torch.float64)
        s1, s2 = o.sum(0), (o * o).sum(0)
        self.s1 = s1 if self.s1 is None else self.s1 + s1
        self.s2 = s2 if self.s2 is None else self.s2 + s2
        self.n += outs.shape[0]

    def result(self) -> tuple:
        mean = self.s1 / self.n
        var = ((self.s2 - self.s1 * mean) / (self.n - 1)).clamp(min=0.0)
        return mean.to(torch.float32), var.sqrt().to(torch.float32)


@plain_float32()
@torch.no_grad()
def mc_ensemble(params, cfg, image, mask, key_seed: int, members: int, chunk: int,
                drop_prob: float, block: int, rows: int = 8, quant: bool = False) -> tuple:
    """(mean, std) (H, W, 1) of the MC-DropBlock ensemble of one NHWC
    (1, H, W, 1) image, the site keys drawn from a generator seeded
    `key_seed`; `rows` members per forward."""
    gen = torch.Generator().manual_seed(key_seed)
    acc = Moments()
    for size in chunk_sizes(members, chunk):
        drop_keys = draw_keys(gen, unet.num_sites(cfg))
        for r in range(0, size, rows):
            n = min(rows, size - r)
            x = image.expand(n, -1, -1, -1)
            drop = unet.Drop(drop_keys, drop_prob, block, sample_offset=r)
            acc.add(unet.forward(params, x, cfg, drop, quant) * mask)
    return acc.result()


def rotate(img: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """NHWC (1 or K, H, W, C) rotated CCW by K angles about ((W-1)/2,
    (H-1)/2), bilinear, zero outside -> (K, H, W, C)."""
    n, h, w, c = img.shape
    a = torch.as_tensor(degrees, dtype=torch.float64).to(img.device).reshape(-1, 1, 1)
    a = a * (math.pi / 180.0)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float64, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float64, device=img.device)[None, :] - cx
    src_x = torch.cos(a) * xx - torch.sin(a) * yy + cx
    src_y = torch.sin(a) * xx + torch.cos(a) * yy + cy
    grid = torch.stack([src_x * (2.0 / (w - 1)) - 1.0, src_y * (2.0 / (h - 1)) - 1.0], dim=-1)
    src = img.permute(0, 3, 1, 2).expand(a.shape[0], -1, -1, -1)
    out = F.grid_sample(src, grid.to(img.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)


@plain_float32()
@torch.no_grad()
def rot_ensemble(params, cfg, image, mask, members: int, rows: int = 8,
                 quant: bool = False) -> tuple:
    """(mean, std) (H, W, 1) of the rotational ensemble of one NHWC
    (1, H, W, 1) image over the angles 1..members degrees."""
    acc = Moments()
    for r in range(1, members + 1, rows):
        angles = torch.arange(r, min(r + rows, members + 1), dtype=torch.float64)
        seg = unet.forward(params, rotate(image, angles), cfg, None, quant)
        acc.add(rotate(seg, -angles) * mask)
    return acc.result()


def drop_prob_at(step: int, start: float, stop: float, nr_steps: int) -> np.float32:
    """The ramp's drop probability at `step`, in float32 arithmetic."""
    i = np.float32(min(step, nr_steps - 1))
    return np.float32(start) + np.float32(stop - start) * i / np.float32(nr_steps - 1)


def _safe_log(v: torch.Tensor) -> torch.Tensor:
    """log(v) clamped at -100, with a finite gradient at v = 0."""
    small = v < 1.1754944e-38
    return torch.where(small, torch.full_like(v, -100.0),
                       torch.log(torch.where(small, torch.ones_like(v), v)))


def bce_terms(seg, gt, mask) -> torch.Tensor:
    """-sum of the masked BCE terms of a block of rows."""
    p, t = seg * mask, gt * mask
    return -(t * _safe_log(p) + (1.0 - t) * _safe_log(1.0 - p)).sum()


@plain_float32()
def train_steps(params0: dict, cfg: dict, batches: list, keys: list, drop_probs: list,
                lr: float, momentum: float, block: int, rows: int = 1,
                quant: bool = False, grad_rows: int | None = None) -> dict:
    """SGD steps from params0 on `batches` (each a global batch (im, gt,
    mask), NHWC float32); keys[k] the step's (S, 2) site keys, drop_probs[k]
    its float32 drop probability. The batch runs `rows` rows per forward,
    each block's masks drawn at its global rows. Returns per-step losses, the
    first step's gradient per leaf (the momentum buffer after one step) and
    the parameters after the last step. grad_rows: only the first grad_rows
    rows' terms reach the gradient (a fault's reading: one rank's share
    without the exchange)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    bufs = {k: torch.zeros_like(v) for k, v in params0.items()}
    losses, first = [], None
    for (im, gt, mask), step_keys, p in zip(batches, keys, drop_probs):
        nonzero = float((mask != 0).sum())
        loss = 0.0
        for r in range(0, im.shape[0], rows):
            sl = slice(r, r + rows)
            drop = unet.Drop(step_keys, p, block, sample_offset=r)
            seg = unet.forward(params, im[sl], cfg, drop, quant)
            part = bce_terms(seg, gt[sl], mask[sl]) / nonzero
            if grad_rows is None or r < grad_rows:
                part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            for k, v in params.items():
                bufs[k].mul_(momentum).add_(v.grad)
                v.sub_(lr * bufs[k])
                v.grad = None
        if first is None:
            first = {k: b.clone() for k, b in bufs.items()}
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in params.items()}}
