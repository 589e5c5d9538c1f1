"""GroupNorm's conv epilogue as hand-written kernels, and their plain versions.

y = act(((x*a + b) * m) * s) over a bf16 NHWC x: a, b the per-(sample,
channel) GroupNorm coefficients, m an optional int8 keep mask (K2's), s an
optional per-sample rescale, act relu, leaky_relu or none; and its backward.
One autograd Function (`group_norm_act`) runs six launches, each counted on
its wrapper:

- `gn_stats`: one pass over x, per-block float32 partial sums of x and x^2
  per (sample, channel); skipped where K3 gave the sums;
- `gn_stats_finish`: the partials summed in a fixed order, the group mean and
  rstd, folded with the GroupNorm weight and bias into float32 a, b (N, C);
- `gn_apply`: one pass, x (and m) in, y out, float32 arithmetic rounded once;
- `gn_grad_sums`: per (sample, channel) sums of gz and gz*x, gz = act'(z) *
  gy * m * s with z recomputed from x, a, b; where K3 gave the sums it also
  writes dx = gz*a;
- `gn_grad_finish`: the weight and bias gradients and the sums' cotangents
  ds1, ds2 (returned to K3's backward, whose fold adds them);
- `gn_grad_dx`: where the statistics were this pass's own, dx = gz*a + ds1 +
  2*x*ds2.

Source: csrc/group_norm.cu (design and bounds there). It replaces no TPU
kernel: XLA fuses the JAX model's GroupNorm epilogue. No atomics: two runs
give the same bits. The kernels take bf16 contiguous NHWC with C % 8 == 0 and
at most 1024 channels a group (`group_norm_act_supported`); the model keeps
its plain composition for anything else and on the CPU. The wrappers run
their plain versions for CPU tensors (float32 arithmetic, float64 for a
float64 input), so the Function's arithmetic is testable on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from unet_research_tpu_torch.ops.cuda.build import check, load_library

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
THREADS, FIN_THREADS, QMAX = 256, 1024, 32  # as csrc/group_norm.cu
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("group_norm")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gn_stats_launch.argtypes = [p, p, i, i, i, i, p]
        lib.gn_stats_finish_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, p]
        lib.gn_apply_launch.argtypes = [p, p, p, p, i, p, i, i, i, i, i, f, p]
        lib.gn_grad_sums_launch.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, i, f, p]
        lib.gn_grad_finish_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, p]
        lib.gn_grad_dx_launch.argtypes = [p, p, p, p, p, i, p, p, i, i, i, i, i, f, p]
        for fn in (lib.gn_stats_launch, lib.gn_stats_finish_launch, lib.gn_apply_launch,
                   lib.gn_grad_sums_launch, lib.gn_grad_finish_launch, lib.gn_grad_dx_launch):
            fn.restype = i
        _lib = lib
    return _lib


def group_norm_act_supported(x, groups: int, act: str) -> bool:
    """Whether the kernels take this input: a contiguous bf16 NHWC tensor on
    the card, C a multiple of 8 and of `groups` with at most 1024 channels a
    group, and an activation they compute."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()):
        return False
    c = x.shape[-1]
    return act in _ACTS and c % 8 == 0 and c % groups == 0 and c // groups <= FIN_THREADS


# --- launch geometry ----------------------------------------------------------

def _rows(c: int) -> int:
    """Positions a pass's block covers a step (csrc Layout)."""
    return THREADS // min(c // 8, QMAX)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _blocks(x, per_thread: int, fill: bool) -> int:
    """NB, a pass's blocks per (sample, channel slice): enough that each
    thread takes about `per_thread` positions, and, for a reduction (fill),
    no more than four blocks an SM over the grid, so the partials stay
    small."""
    n, h, w, c = x.shape
    rows = _rows(c)
    nb = max(1, math.ceil(h * w / (rows * per_thread)))
    if fill:
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        slices = math.ceil(c // 8 / min(c // 8, QMAX))
        nb = min(nb, max(1, math.ceil(4 * _sm_count(dev) / (slices * n))))
    return nb


def _groups_per_block(c: int, groups: int) -> int:
    """Groups a finishing block sums: whole groups of at most 8 channels in
    all (one group where a group is wider), so a sample's partials spread
    over many blocks and each channel's over 1024 / channels lanes."""
    return max(1, min(groups, 8 // (c // groups)))


def _aligned(t, to: int = 16):
    t = t.contiguous()
    return t if t.data_ptr() % to == 0 else t.clone()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _scale_args(scale, x):
    """(scale, pointer, stride) of a 0-d or (N,) float32 scale on x's device
    (stride 0: one scale for the batch), or (None, None, 0)."""
    if scale is None:
        return None, None, 0
    if scale.numel() not in (1, x.shape[0]) or scale.dtype != torch.float32 \
            or scale.device != x.device:
        raise ValueError("group_norm_act: scale must be 0-d or (N,) float32 on x's device")
    scale = scale.contiguous()
    return scale, scale.data_ptr(), 0 if scale.numel() == 1 else 1


def _check_f32(t, shape, device, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"group_norm_act: {what} must be contiguous float32 {tuple(shape)} "
                         f"on {device}")


def _check_x(x) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] % 8:
        raise ValueError("group_norm_act: x must be bf16 NHWC with C % 8 == 0")


def _mask_ptr(mask, x):
    if mask is None:
        return None, None
    if mask.dtype != torch.int8 or mask.shape != x.shape or mask.device != x.device:
        raise ValueError("group_norm_act: mask must be int8 in x's shape on x's device")
    mask = _aligned(mask, 8)
    return mask, mask.data_ptr()


# --- the plain versions ----------------------------------------------------------

def _acc(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _per_sample(t):
    return t[:, None, None, :]


def _pre_act(x, ab, mask, scale):
    """z = ((x*a + b) * m) * s in ab's dtype, each operation rounded."""
    z = x.to(ab.dtype) * _per_sample(ab[0]) + _per_sample(ab[1])
    if mask is not None:
        z = z * mask.to(ab.dtype)
    if scale is not None:
        z = z * scale.to(ab.dtype).reshape(-1, 1, 1, 1)
    return z


def _act(z, act: str, slope: float):
    if act == "relu":
        return torch.where(z <= 0, torch.zeros((), dtype=z.dtype), z)
    if act == "leaky_relu":
        return torch.where(z > 0, z, z * slope)
    return z


def _grad_z(gy, z, mask, scale, act: str, slope: float):
    """gz = ((act'(z) * gy) * m) * s."""
    g = gy.to(z.dtype)
    if act == "relu":
        g = torch.where(z > 0, g, torch.zeros((), dtype=z.dtype))
    elif act == "leaky_relu":
        g = torch.where(z > 0, g, g * slope)
    if mask is not None:
        g = g * mask.to(z.dtype)
    if scale is not None:
        g = g * scale.to(z.dtype).reshape(-1, 1, 1, 1)
    return g


def gn_stats_plain(x):
    """(2, N, 1, C): the sums of x and x^2 over (H, W)."""
    xf = x.to(_acc(x))
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))])[:, :, None, :]


def gn_stats_finish_plain(p0, p1, hw: int, weight, bias, groups: int, eps: float):
    """(ab (2, N, C), mr (3, N, G)) from the (N, NB, C) partials of s1 and
    s2: a = rstd*weight, b = bias - mean*a; mr = (mean, rstd, 1 where the
    variance was not clamped at 0)."""
    s1, s2 = p0.sum(1), p1.sum(1)
    n, c = s1.shape
    cg = c // groups
    cnt = float(hw * cg)
    mean = s1.reshape(n, groups, cg).sum(-1) / cnt
    var = s2.reshape(n, groups, cg).sum(-1) / cnt - mean * mean
    rstd = 1.0 / torch.sqrt(var.clamp(min=0.0) + eps)
    a = rstd.repeat_interleave(cg, dim=1) * weight.to(s1.dtype)
    b = bias.to(s1.dtype) - mean.repeat_interleave(cg, dim=1) * a
    return torch.stack([a, b]), torch.stack([mean, rstd, (var >= 0).to(s1.dtype)])


def gn_apply_plain(x, ab, mask=None, scale=None, act: str = "none", slope: float = 0.01):
    return _act(_pre_act(x, ab, mask, scale), act, slope).to(x.dtype)


def gn_grad_sums_plain(gy, x, ab, mask=None, scale=None, act: str = "none",
                       slope: float = 0.01, dx: bool = False):
    """((2, N, 1, C) sums of gz and gz*x, dx = gz*a in x's dtype or None)."""
    g = _grad_z(gy, _pre_act(x, ab, mask, scale), mask, scale, act, slope)
    part = torch.stack([g.sum(dim=(1, 2)), (g * x.to(g.dtype)).sum(dim=(1, 2))])[:, :, None, :]
    return part, ((g * _per_sample(ab[0])).to(x.dtype) if dx else None)


def gn_grad_finish_plain(part, ab, mr, weight, hw: int, groups: int):
    """(ds (2, N, C) = (ds1, ds2), dweight (C,), dbias (C,)) from the sums'
    partials (2, N, NB, C), the coefficients and the statistics."""
    gsum, gxsum = part[0].sum(1), part[1].sum(1)
    n, c = gsum.shape
    cg = c // groups
    mean, rstd, gate = mr
    centred = gxsum - mean.repeat_interleave(cg, dim=1) * gsum
    d_rstd = (weight.to(gsum.dtype) * centred).reshape(n, groups, cg).sum(-1)
    d_mean = -(ab[0] * gsum).reshape(n, groups, cg).sum(-1)
    dvar = gate * (d_rstd * (-0.5 * (rstd * rstd * rstd)))
    cnt = float(hw * cg)
    ds1 = (d_mean - 2.0 * mean * dvar) / cnt
    ds2 = dvar / cnt
    ds = torch.stack([ds1.repeat_interleave(cg, dim=1), ds2.repeat_interleave(cg, dim=1)])
    dweight = (rstd.repeat_interleave(cg, dim=1) * centred).sum(0)
    return ds, dweight, gsum.sum(0)


def gn_grad_dx_plain(gy, x, ab, mask, scale, ds, act: str = "none", slope: float = 0.01):
    """dx = gz*a + (ds1 + (2*x)*ds2), in x's dtype."""
    g = _grad_z(gy, _pre_act(x, ab, mask, scale), mask, scale, act, slope)
    xf = x.to(g.dtype)
    return (g * _per_sample(ab[0]) + (_per_sample(ds[0]) + 2.0 * xf * _per_sample(ds[1]))).to(
        x.dtype)


# --- the wrappers ----------------------------------------------------------------

def gn_stats(x):
    """(2, N, NB, C) float32 partial sums of x and x^2 over (H, W)."""
    if not x.is_cuda:
        return gn_stats_plain(x)
    _check_x(x)
    x = _aligned(x)
    n, h, w, c = x.shape
    nb = _blocks(x, 8, fill=True)
    part = torch.empty((2, n, nb, c), dtype=torch.float32, device=x.device)
    check(_library().gn_stats_launch(x.data_ptr(), part.data_ptr(), n, h * w, c, nb,
                                     _stream(x)), "gn_stats")
    gn_stats.launches += 1
    return part


gn_stats.launches = 0


def gn_stats_finish(p0, p1, hw: int, weight, bias, groups: int, eps: float):
    """(ab (2, N, C), mr (3, N, G)) float32 from the (N, NB, C) partials of
    s1 and s2 (K3's (N, C) sums as NB = 1)."""
    if not p0.is_cuda:
        return gn_stats_finish_plain(p0, p1, hw, weight, bias, groups, eps)
    n, nb, c = p0.shape
    dev = p0.device
    if c % groups or c // groups > FIN_THREADS:
        raise ValueError("gn_stats_finish: C must be a multiple of groups, at most 1024 a group")
    p0, p1 = p0.to(torch.float32).contiguous(), p1.to(torch.float32).contiguous()
    _check_f32(p1, (n, nb, c), dev, "the partials")
    weight = weight.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _check_f32(weight, (c,), dev, "weight")
    _check_f32(bias, (c,), dev, "bias")
    ab = torch.empty((2, n, c), dtype=torch.float32, device=dev)
    mr = torch.empty((3, n, groups), dtype=torch.float32, device=dev)
    check(_library().gn_stats_finish_launch(
        p0.data_ptr(), p1.data_ptr(), weight.data_ptr(), bias.data_ptr(), ab.data_ptr(),
        mr.data_ptr(), n, c, groups, nb, _groups_per_block(c, groups),
        float(hw * (c // groups)), float(eps), _stream(p0)), "gn_stats_finish")
    gn_stats_finish.launches += 1
    return ab, mr


gn_stats_finish.launches = 0


def gn_apply(x, ab, mask=None, scale=None, act: str = "none", slope: float = 0.01):
    """act(((x*a + b) * m) * s) in x's dtype."""
    if not x.is_cuda:
        return gn_apply_plain(x, ab, mask, scale, act, slope)
    _check_x(x)
    x = _aligned(x)
    n, h, w, c = x.shape
    _check_f32(ab, (2, n, c), x.device, "ab")
    mask, mptr = _mask_ptr(mask, x)
    scale, sptr, sstride = _scale_args(scale, x)
    y = torch.empty_like(x)
    check(_library().gn_apply_launch(
        x.data_ptr(), ab.data_ptr(), mptr, sptr, sstride, y.data_ptr(), n, h * w, c,
        _blocks(x, 4, fill=False), _ACTS[act], float(slope), _stream(x)), "gn_apply")
    gn_apply.launches += 1
    return y


gn_apply.launches = 0


def gn_grad_sums(gy, x, ab, mask=None, scale=None, act: str = "none", slope: float = 0.01,
                 dx: bool = False):
    """((2, N, NB, C) float32 partial sums of gz and gz*x, dx = gz*a or
    None)."""
    if not x.is_cuda:
        return gn_grad_sums_plain(gy, x, ab, mask, scale, act, slope, dx)
    _check_x(x)
    gy, x = _aligned(gy.to(x.dtype)), _aligned(x)
    n, h, w, c = x.shape
    _check_f32(ab, (2, n, c), x.device, "ab")
    mask, mptr = _mask_ptr(mask, x)
    scale, sptr, sstride = _scale_args(scale, x)
    nb = _blocks(x, 8, fill=True)
    part = torch.empty((2, n, nb, c), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x) if dx else None
    check(_library().gn_grad_sums_launch(
        gy.data_ptr(), x.data_ptr(), ab.data_ptr(), mptr, sptr, sstride, part.data_ptr(),
        None if out is None else out.data_ptr(), n, h * w, c, nb, _ACTS[act], float(slope),
        _stream(x)), "gn_grad_sums")
    gn_grad_sums.launches += 1
    return part, out


gn_grad_sums.launches = 0


def gn_grad_finish(part, ab, mr, weight, hw: int, groups: int):
    """(ds (2, N, C), dweight (C,), dbias (C,)) float32."""
    if not part.is_cuda:
        return gn_grad_finish_plain(part, ab, mr, weight, hw, groups)
    _, n, nb, c = part.shape
    dev = part.device
    _check_f32(part, (2, n, nb, c), dev, "the partials")
    _check_f32(ab, (2, n, c), dev, "ab")
    _check_f32(mr, (3, n, groups), dev, "mr")
    weight = weight.to(torch.float32).contiguous()
    _check_f32(weight, (c,), dev, "weight")
    ds = torch.empty((2, n, c), dtype=torch.float32, device=dev)
    dweight = torch.empty(c, dtype=torch.float32, device=dev)
    dbias = torch.empty(c, dtype=torch.float32, device=dev)
    check(_library().gn_grad_finish_launch(
        part.data_ptr(), ab.data_ptr(), mr.data_ptr(), weight.data_ptr(), ds.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), n, c, groups, nb, _groups_per_block(c, groups),
        float(hw * (c // groups)), _stream(part)), "gn_grad_finish")
    gn_grad_finish.launches += 1
    return ds, dweight, dbias


gn_grad_finish.launches = 0


def gn_grad_dx(gy, x, ab, mask, scale, ds, act: str = "none", slope: float = 0.01):
    """dx = gz*a + (ds1 + (2*x)*ds2) in x's dtype."""
    if not x.is_cuda:
        return gn_grad_dx_plain(gy, x, ab, mask, scale, ds, act, slope)
    _check_x(x)
    gy, x = _aligned(gy.to(x.dtype)), _aligned(x)
    n, h, w, c = x.shape
    _check_f32(ab, (2, n, c), x.device, "ab")
    _check_f32(ds, (2, n, c), x.device, "ds")
    mask, mptr = _mask_ptr(mask, x)
    scale, sptr, sstride = _scale_args(scale, x)
    dx = torch.empty_like(x)
    check(_library().gn_grad_dx_launch(
        gy.data_ptr(), x.data_ptr(), ab.data_ptr(), mptr, sptr, sstride, ds.data_ptr(),
        dx.data_ptr(), n, h * w, c, _blocks(x, 4, fill=False), _ACTS[act], float(slope),
        _stream(x)), "gn_grad_dx")
    gn_grad_dx.launches += 1
    return dx


gn_grad_dx.launches = 0

WRAPPERS = (gn_stats, gn_stats_finish, gn_apply, gn_grad_sums, gn_grad_finish, gn_grad_dx)


# --- the Function ----------------------------------------------------------------

class _GroupNormAct(torch.autograd.Function):
    """The epilogue's forward (statistics, finish, apply) and its backward
    (sums, finish, and dx where the statistics were its own). Saves x, the
    coefficients and the statistics; z is recomputed."""

    @staticmethod
    def forward(ctx, x, weight, bias, s1, s2, mask, scale, groups, eps, act, slope):
        hw = x.shape[1] * x.shape[2]
        if s1 is None:
            p0, p1 = gn_stats(x)
        else:
            p0, p1 = s1[:, None, :], s2[:, None, :]
        ab, mr = gn_stats_finish(p0, p1, hw, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, ab, mr, mask, scale)
        ctx.args = (groups, act, slope, s1 is not None)
        return gn_apply(x, ab, mask, scale, act, slope)

    @staticmethod
    def backward(ctx, gy):
        x, weight, ab, mr, mask, scale = ctx.saved_tensors
        groups, act, slope, given = ctx.args
        hw = x.shape[1] * x.shape[2]
        part, dx = gn_grad_sums(gy, x, ab, mask, scale, act, slope, dx=given)
        ds, dweight, dbias = gn_grad_finish(part, ab, mr, weight, hw, groups)
        if not given and ctx.needs_input_grad[0]:
            dx = gn_grad_dx(gy, x, ab, mask, scale, ds, act, slope)
        sums = (ds[0], ds[1]) if given else (None, None)
        return (dx, dweight.to(weight.dtype), dbias.to(weight.dtype), *sums,
                None, None, None, None, None, None)


def group_norm_act(x, weight, bias, groups: int, eps: float = 1e-5, sums=None, mask=None,
                   scale=None, act: str = "none", slope: float = 0.01):
    """act(((GroupNorm(x) * mask) * scale)) of NHWC x through the kernels
    (their plain versions for CPU tensors), differentiable in x, weight, bias
    and the sums.

    weight, bias: the GroupNorm's (C,) parameters; sums: K3's float32 (s1, s2)
    (N, C) of x, or None to compute them; mask: int8 keep mask in x's shape,
    or None; scale: a 0-d or (N,) float32 rescale, or None. Returns x's dtype
    and shape."""
    if act not in _ACTS:
        raise ValueError(f"group_norm_act: unsupported activation {act!r}")
    s1, s2 = (None, None) if sums is None else sums
    return _GroupNormAct.apply(x, weight, bias, s1, s2, mask, scale, groups, eps, act, slope)
