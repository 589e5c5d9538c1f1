"""The mask-site machinery that the port's models share: a forward pass's
DropBlock state (the drop probability, the site keys handed out in call
order, the fused route), its normalisation epilogues and its remat.

A mask site is norm -> DropBlock -> activation after a conv, or a bare
DropBlock (a skip merge). `SitePass` runs one site through the route its
input allows:

- K1 (ops/cuda/dropblock_kernel.py::dropblock_fused_apply): act((x*a + b) *
  mask) and the keep counts in one pass, forward only (eval with DropBlock
  on, mask_impl 'fused'); (a, b) are per-(sample, channel) coefficients, a
  GroupNorm's or an eval-mode BatchNorm's (`coeffs`, or `kernel_coeffs`
  from GroupNorm's statistics kernels); the U-Net's skip merge may take K1's
  merge mode (models/unet.py::_Pass.merge_site);
- otherwise the mask from the mask producer K2 (or the plain ops), and the
  norm, mask, rescale and activation as GroupNorm's epilogue kernels
  (ops/cuda/group_norm.py::group_norm_act, differentiable), or, for an
  eval-mode BatchNorm, its affine as `gn_apply`; a site on the card that
  cannot take them (a train-mode BatchNorm among them) runs the plain ops
  and is counted in `gn:plain` or `bn:plain` (ops/cuda/launches.py).

A site's DropBlock rescale is one of 'apply' (the whole batch's count,
the reference op), 'defer' (returned per sample), 'skip' (left out, where a
scale-invariant GroupNorm follows) or 'sample' (each sample's own count,
applied at the site).

Each model defines its pass as a subclass: models/unet.py::_Pass and
models/transunet.py::_Pass. The keys are the (S, 2) int64 uint32 words of
`draw_site_keys`, one row per site in call order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.cuda.dropblock_kernel import (
    dropblock_fused_apply,
    dropblock_kernel_supported,
    seed_threshold,
)
from unet_research_tpu_torch.ops.cuda.group_norm import (
    gn_apply,
    gn_stats,
    gn_stats_finish,
    group_norm_act,
    group_norm_act_supported,
)
from unet_research_tpu_torch.ops.dropblock import (
    apply_keep_mask,
    batch_keep,
    dropblock_gamma_dependent,
    dropblock_gamma_independent,
    dropblock_mask_scale,
    keep_scale,
)
from unet_research_tpu_torch.parallel.mesh import psum


def draw_site_keys(num_sites: int, generator: torch.Generator) -> torch.Tensor:
    """(num_sites, 2) int64 uint32 key words from an explicit CPU generator."""
    return torch.randint(0, 2**32, (num_sites, 2), dtype=torch.int64, generator=generator)


# --- GroupNorm as per-(sample, channel) affine coefficients -------------------

def group_norm_coeffs_from_sums(s1, s2, hw: int, scale, bias, num_groups: int,
                                eps: float):
    """(a, b), (N, C) each in the sums' dtype (float32, or float64 for a
    float64 model), with GN(x) = x*a + b, from the per-channel sums s1 = sum x
    and s2 = sum x^2 over (H, W); hw = H*W. The variance is clamped at 0
    against float32 cancellation."""
    n, c = s1.shape
    cg = c // num_groups
    g1 = s1.reshape(n, num_groups, cg).sum(-1)
    g2 = s2.reshape(n, num_groups, cg).sum(-1)
    cnt = float(hw * cg)
    mean = g1 / cnt
    var = torch.clamp(g2 / cnt - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1)
    a = mul * scale.to(s1.dtype)[None, :]
    b = bias.to(s1.dtype)[None, :] - mean.repeat_interleave(cg, dim=1) * a
    return a, b


def group_norm_coeffs(x, scale, bias, num_groups: int, eps: float):
    """GroupNorm affine coefficients of NHWC x (torch GroupNorm semantics:
    biased variance over (H, W, C/G) per sample), statistics in float32 (in
    float64 for a float64 x). Both sums accumulate in float32 straight from
    x's dtype (one reduction kernel each on the card, no float32 copy of x);
    s2 is the squared float32 2-norm."""
    acc = torch.promote_types(x.dtype, torch.float32)
    s1 = x.sum(dim=(1, 2), dtype=acc)
    s2 = torch.linalg.vector_norm(x, 2, dim=(1, 2), dtype=acc).square()
    return group_norm_coeffs_from_sums(s1, s2, x.shape[1] * x.shape[2], scale,
                                       bias, num_groups, eps)


def group_norm_affine(x, scale, bias, num_groups: int, eps: float, dtype,
                      sums=None):
    """GroupNorm of NHWC x as x*a + b, applied in x's dtype (a, b rounded
    once). sums: precomputed (s1, s2), e.g. from conv3x3_pair."""
    if sums is not None:
        a, b = group_norm_coeffs_from_sums(sums[0], sums[1], x.shape[1] * x.shape[2],
                                           scale, bias, num_groups, eps)
    else:
        a, b = group_norm_coeffs(x, scale, bias, num_groups, eps)
    a = a.to(x.dtype)[:, None, None, :]
    b = b.to(x.dtype)[:, None, None, :]
    return (x * a + b).to(dtype)


def batch_norm_coeffs(mod, n: int, eps: float):
    """An eval-mode BatchNorm as (2, N, C) float32 coefficients: a =
    weight * rsqrt(running_var + eps), b = bias - running_mean * a, the same
    for every sample (K1's and gn_apply's layout)."""
    a = torch.rsqrt(mod.running_var.to(torch.float32) + eps) * mod.weight.to(torch.float32)
    b = mod.bias.to(torch.float32) - mod.running_mean.to(torch.float32) * a
    return torch.stack([a, b])[:, None, :].expand(2, n, a.shape[0]).contiguous()


# --- one normalisation -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Norm:
    """One site's normalisation: kind 'group', 'batch' or None (none), the
    module that holds its parameters (and BatchNorm's running statistics),
    its groups (GroupNorm) and eps."""

    kind: Optional[str]
    mod: Optional[nn.Module]
    groups: int = 1
    eps: float = 1e-5


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _kernel_input(x) -> bool:
    """Whether gn_apply takes x: contiguous bf16 NHWC on the card, C % 8 == 0."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()
            and x.shape[-1] % 8 == 0)


class SitePass:
    """One forward pass's DropBlock state and site routes (module docstring).

    Site keys are handed out by block, in call order, before the block
    runs (`take`), so a block that remat runs again in the backward draws
    the same masks. A subclass sets `fuses()` (whether its sites may take
    K1 at all)."""

    # whether K1's GroupNorm coefficients come from the statistics kernels
    # (`kernel_coeffs`) where they take x; the U-Net's K1 sites keep
    # group_norm_coeffs
    kernel_statistics = False

    def __init__(self, model: nn.Module, db, dtype, drop_prob, site_keys, train: bool, mesh,
                 remat: bool, activation: str, slope: float):
        self.model, self.db, self.dtype = model, db, dtype
        self.drop_prob = drop_prob
        self.train = train
        self.mesh = mesh
        self.remat = remat
        self.activation, self.slope = activation, slope
        self.sample_offset = 0  # the global row of x's first sample, set by run
        # set when the forward is done: a block that runs after that is a
        # remat re-run, which must not update BatchNorm's running statistics
        self.recomputing = False
        self.active = db.kind is not None and drop_prob is not None
        self.site_keys = None
        self.cursor = 0
        self.thresholds = {}  # a device drop_prob's seed thresholds by site size
        if self.active:
            want = (model.num_mask_sites(), 2)
            if site_keys is None or tuple(site_keys.shape) != want:
                raise ValueError(f"DropBlock is active: site_keys must have shape {want}")
            device = next(model.parameters()).device
            self.site_keys = site_keys.to(device=device, dtype=torch.int64)
        # the fused kernel K1 has no backward: under train=True the mask
        # sites take the mask producer K2 ('kernel'), as the JAX op level
        # degrades 'fused' (ops/dropblock.py:190-194); the masks are the same
        self.fused = (self.active and db.mask_impl == "fused" and not train and self.fuses()
                      and activation in ("relu", "leaky_relu")
                      and dropblock_kernel_supported(db.block_size))
        if self.fused and isinstance(drop_prob, torch.Tensor):
            raise ValueError("mask_impl='fused': the forward-only fused kernel takes "
                             "drop_prob as a number")
        if self.fused and torch.is_grad_enabled() and any(
                p.requires_grad for p in model.parameters()):
            raise RuntimeError(
                "mask_impl='fused' runs a forward-only kernel: call the model "
                "with train=True to train, or under torch.no_grad()")

    def fuses(self) -> bool:
        return True

    def take(self, count: int) -> list:
        """The next `count` site-key rows (None each when DropBlock is off)."""
        if not self.active:
            return [None] * count
        rows = list(self.site_keys[self.cursor:self.cursor + count])
        self.cursor += count
        return rows

    def block(self, fn, x):
        """fn(x), rematerialised in the backward under remat (JAX
        `_maybe_remat`, models/unet.py:729-742). The forward draws nothing
        from torch's generators (its masks come from the counter hash on
        explicit keys), so the RNG state need not be saved and restored
        around the re-run: preserve_rng_state=False is the same function,
        and it leaves the CUDA generator's state unread, which a CUDA graph
        capture refuses."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
        return fn(x)

    # -- layers ----------------------------------------------------------------

    def act(self, x, name: Optional[str] = None):
        a = self.activation if name is None else name
        if a == "relu":
            return torch.relu(x)
        if a == "leaky_relu":
            return F.leaky_relu(x, self.slope)
        if a == "elu":
            return F.elu(x)
        if a == "gelu":
            return F.gelu(x)
        if a == "silu":
            return F.silu(x)
        if a == "tanh":
            return torch.tanh(x)
        if a == "sigmoid":
            return torch.sigmoid(x)
        return x

    def plain_norm(self, x, norm: Norm, sums=None):
        """The normalisation as plain ops, in the pass's dtype: GroupNorm by
        its coefficients (group_norm_affine), BatchNorm in float32 (train
        mode: batch_norm_train)."""
        if norm.kind == "group":
            return group_norm_affine(x, norm.mod.weight, norm.mod.bias, norm.groups, norm.eps,
                                     self.dtype, sums=sums)
        if norm.kind == "batch":
            x32 = x.to(torch.float32)
            if self.train:
                return self.batch_norm_train(x32, norm.mod, norm.eps).to(self.dtype)
            y = F.batch_norm(_nchw(x32), norm.mod.running_mean, norm.mod.running_var,
                             norm.mod.weight, norm.mod.bias, False, 0.0, norm.eps)
            return _nhwc(y).to(self.dtype)
        return x

    def batch_norm_train(self, x, mod, eps: float = 1e-5):
        """Train-mode BatchNorm of NHWC float32 x in flax's arithmetic: the
        batch's per-channel mean and biased variance E[x^2] - E[x]^2
        (clamped at 0) from the sums of x and x^2. Under a mesh the sums and
        the count are the global batch's (a differentiable psum). The
        running statistics update as torch's BatchNorm2d does (momentum 0.1,
        the unbiased variance; flax's is biased), once: a remat re-run
        leaves them alone."""
        n, h, w, c = x.shape
        sums = torch.stack([x.sum(dim=(0, 1, 2)), (x * x).sum(dim=(0, 1, 2))])
        count = n * h * w
        if self.mesh is not None:
            sums = psum(sums, self.mesh)
            count *= self.mesh.size
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        if not self.recomputing:
            with torch.no_grad():
                mod.running_mean.mul_(0.9).add_(0.1 * mean)
                mod.running_var.mul_(0.9).add_(0.1 * var * (count / (count - 1)))
                mod.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + eps) * mod.weight) + mod.bias

    def coeffs(self, x, norm: Norm, sums=None):
        """(2, N, C) float32 coefficients of a site's normalisation for K1:
        GroupNorm's from its statistics, an eval BatchNorm's from its running
        ones; from the statistics kernels under `kernel_statistics`."""
        if norm.kind == "batch":
            return batch_norm_coeffs(norm.mod, x.shape[0], norm.eps)
        if (self.kernel_statistics and sums is None and x.dtype == self.dtype
                and group_norm_act_supported(x, norm.groups, "none")):
            return self.kernel_coeffs(x, norm)
        h, w = x.shape[1:3]
        if sums is not None:
            a, b = group_norm_coeffs_from_sums(sums[0], sums[1], h * w, norm.mod.weight,
                                               norm.mod.bias, norm.groups, norm.eps)
        else:
            a, b = group_norm_coeffs(x, norm.mod.weight, norm.mod.bias, norm.groups, norm.eps)
        return torch.stack([a, b]).contiguous()

    @staticmethod
    def kernel_coeffs(x, norm: Norm):
        """K1's (2, N, C) float32 GroupNorm coefficients from the statistics
        kernels (gn_stats, gn_stats_finish: one pass over x), as
        group_norm_act computes them; x as group_norm_act_supported takes
        it."""
        p0, p1 = gn_stats(x)
        ab, _ = gn_stats_finish(p0, p1, x.shape[1] * x.shape[2], norm.mod.weight, norm.mod.bias,
                                norm.groups, norm.eps)
        return ab

    def gamma(self, h: int, w: int):
        """The seed probability of an (h, w) mask site."""
        db = self.db
        fn = dropblock_gamma_dependent if db.kind == "dependent" else dropblock_gamma_independent
        return fn(h, w, db.block_size, self.drop_prob)

    # -- DropBlock sites -------------------------------------------------------

    def fused_site(self, x, key, norm: Optional[Norm], rescale: str, with_act: bool,
                   sums=None):
        """One mask site through the fused kernel: act((x*a + b) * mask), the
        coefficients computed outside (from `sums` if given); norm None: the
        bare site."""
        db = self.db
        n, h, w, c = x.shape
        ab = None
        if with_act and norm is not None and norm.kind is not None:
            ab = self.coeffs(x, norm, sums)
        out, keep = dropblock_fused_apply(
            x.contiguous(), ab, key, self.gamma(h, w), db.block_size,
            act=self.activation if with_act else "none", slope=self.slope,
            sample_offset=self.sample_offset)
        out = out.to(self.dtype)
        if rescale == "skip":
            return out
        if rescale in ("defer", "sample"):
            scale = keep_scale(db.kind, keep, float(h * w * c))
            if rescale == "defer":
                return out, scale
            return per_sample(out, scale)
        # the whole-batch scale of the JAX model (:410-422)
        total, numel = batch_keep(keep, n * h * w * c, self.mesh)
        return out * keep_scale(db.kind, total, numel).to(out.dtype)

    def site_mask(self, x, key, rescale: str):
        """(int8 keep mask, scale) of the mask site over x
        (ops/dropblock.py::dropblock_mask_scale; 'sample' gives the
        per-sample scale, as 'defer'), or (None, None) when DropBlock is
        off."""
        if not self.active:
            return None, None
        db = self.db
        rescale = "defer" if rescale == "sample" else rescale
        if not isinstance(self.drop_prob, torch.Tensor):
            return dropblock_mask_scale(x, key, self.drop_prob, db.block_size, db.kind,
                                        db.mask_impl, rescale, self.mesh)
        # the gamma and seed threshold of the device drop_prob, once per size
        h, w = x.shape[1:3]
        if (h, w) not in self.thresholds:
            self.thresholds[h, w] = seed_threshold(self.gamma(h, w))
        return dropblock_mask_scale(x, key, None, db.block_size, db.kind, db.mask_impl,
                                    rescale, self.mesh, threshold=self.thresholds[h, w])

    def dropblock(self, x, key, rescale: str = "apply"):
        """A bare mask site (a skip merge). Under autograd the mask is a
        constant: x * mask needs no backward of its own."""
        if not self.active:
            return (x, None) if rescale == "defer" else x
        if self.fused:
            return self.fused_site(x, key, None, rescale, with_act=False)
        mask, scale = self.site_mask(x, key, rescale)
        if rescale == "sample":
            return per_sample(x * mask.to(x.dtype), scale)
        return apply_keep_mask(x, mask, scale, rescale)

    def site_norm_act(self, x, norm: Norm, sums=None, mask=None, scale=None,
                      act: bool = True):
        """norm -> x * mask -> x * scale (0-d: the whole batch's; (N,): each
        sample's) -> activation (act=False: none); mask and scale None where
        there are none."""
        name = self.activation if act else "none"
        if norm.kind == "group":
            if x.dtype == self.dtype and group_norm_act_supported(x, norm.groups, name):
                return group_norm_act(x, norm.mod.weight, norm.mod.bias, norm.groups, norm.eps,
                                      sums, mask, scale, name, self.slope)
            if x.is_cuda:
                launches.HOST["gn:plain"] += 1
        elif norm.kind == "batch":
            if (not self.train and not torch.is_grad_enabled() and x.dtype == self.dtype
                    and _kernel_input(x) and name in ("relu", "leaky_relu", "none")):
                return gn_apply(x, batch_norm_coeffs(norm.mod, x.shape[0], norm.eps), mask,
                                scale, name, self.slope)
            if x.is_cuda:
                launches.HOST["bn:plain"] += 1
        x = self.plain_norm(x, norm, sums)
        if mask is not None and scale is not None and scale.dim() == 1:
            x = per_sample(x * mask.to(x.dtype), scale)
        elif mask is not None:
            x = apply_keep_mask(x, mask, scale, "skip" if scale is None else "apply")
        return self.act(x) if act else x

    def site_norm_db_act(self, x, key, norm: Norm, rescale: str, sums=None):
        """The conv epilogue norm -> DropBlock -> activation."""
        if self.fused:
            return self.fused_site(x, key, norm, rescale, with_act=True, sums=sums)
        mask, scale = self.site_mask(x, key, rescale)
        y = self.site_norm_act(x, norm, sums, mask,
                               scale if rescale in ("apply", "sample") else None)
        return (y, scale) if rescale == "defer" else y


def per_sample(x, scale):
    """x (N, H, W, C) times a per-sample (N,) scale, each product in float32
    and rounded once to x's dtype: a scale rounded to bf16 first carries an
    error of up to 2^-9, another in each member, which was most of a bf16
    TransUNet ensemble's std gap from float32. Outside autograd a card input
    takes `gn_apply` with the identity affine (one vectorised pass; PyTorch's
    mixed bf16-float32 multiply runs at a third of its speed), any other is
    overwritten in place (the sites pass their own fresh output)."""
    s = scale.to(torch.float32)
    if torch.is_grad_enabled() and x.requires_grad:
        return (x * s[:, None, None, None]).to(x.dtype)
    if _kernel_input(x):
        ab = x.new_zeros((2, x.shape[0], x.shape[-1]), dtype=torch.float32)
        ab[0].fill_(1.0)
        return gn_apply(x, ab, None, s.contiguous(), "none")
    return x.mul_(s[:, None, None, None])
