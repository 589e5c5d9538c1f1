"""GroupNorm's conv epilogue (ops/cuda/group_norm.py) on the CPU.

(1) The model's epilogue on the CPU (`_Pass.norm_db_act` and `norm_act`, the
route the JAX parity tests take) is bit-equal to the composition it ran
before the kernels came: group_norm_affine -> dropblock_dependent -> the
activation, in bf16 and float32. (2) The kernels' arithmetic, through
`group_norm_act` on CPU tensors (each wrapper's plain version, the same
formulas as csrc/group_norm.cu), against autograd of that composition in
float64: the output and the gradients of x and K3's sums within 1e-9 of
the largest magnitude of each, the weight's and the bias's within 1e-7 (the
composition casts the float32 parameters to float32 at use, so autograd
rounds their gradients to float32 there). Each over mask / no mask,
relu / leaky_relu / none, K3's sums / its own statistics, rescale apply /
defer / skip, N = 1 and 2. (3) The launch geometry keeps a finishing block's
lanes within its 1024 threads. No card needed; the kernels themselves are
held against these plain versions on the card by
tests/test_torch_cuda_kernels.py.
"""

import pytest
import torch
import torch.nn.functional as F

from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import group_norm as gn
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.dropblock import (
    apply_keep_mask,
    dropblock_dependent,
    dropblock_mask_scale,
)

GROUPS, BLOCK, P_DROP = 4, 3, 0.3
ACTS = {"relu": torch.relu, "leaky_relu": lambda t: F.leaky_relu(t, 0.01),
        "none": lambda t: t}
CASES = [(mask, act, k3, rescale, n)
         for mask in (True, False)
         for act in ("relu", "leaky_relu", "none")
         for k3 in (True, False)
         for rescale in ("apply", "defer", "skip")
         for n in (1, 2)]
IDS = [f"{'mask' if m else 'nomask'}-{a}-{'k3' if k else 'own'}-{r}-n{n}"
       for m, a, k, r, n in CASES]


def _inputs(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((n, 10, 12, 16), generator=g) * 1.5 + 0.4).to(dtype)
    weight = 1.0 + 0.3 * torch.randn(16, generator=g)
    bias = 0.2 * torch.randn(16, generator=g)
    key = torch.randint(0, 2**32, (2,), dtype=torch.int64, generator=g)
    return x, weight, bias, key


def _sums(x):
    xf = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    return xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))


def _pass(act, mask, dtype):
    cfg = tunet.canonical_config(filters=16, model_depth=1, group_norm_groups=GROUPS,
                                 activation=act if act != "none" else "relu", dtype=dtype,
                                 dropblock=tunet.DropBlockConfig(kind="dependent",
                                                                 block_size=BLOCK,
                                                                 mask_impl="elementwise"))
    model = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(1))
    return tunet._Pass(model, P_DROP if mask else None, keys if mask else None, True, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask,act,k3,rescale,n", CASES, ids=IDS)
def test_epilogue_plain_route_is_the_composition(mask, act, k3, rescale, n, dtype):
    """The model's epilogue on the CPU against group_norm_affine ->
    dropblock_dependent -> act, bit for bit (act 'none': norm_act without
    the activation, as the max-pool site runs it)."""
    p = _pass(act, mask, dtype)
    x, weight, bias, key = _inputs(n, dtype, seed=n + 7)
    mod = torch.nn.GroupNorm(GROUPS, 16)
    with torch.no_grad():
        mod.weight.copy_(weight)
        mod.bias.copy_(bias)
    sums = _sums(x) if k3 else None
    before = launches.HOST["gn:plain"]
    ref = tunet.group_norm_affine(x, weight, bias, GROUPS, 1e-5, dtype, sums=sums)
    scale = None
    if mask:
        ref = dropblock_dependent(ref, key, P_DROP, BLOCK, mask_impl="elementwise",
                                  rescale=rescale)
        if rescale == "defer":
            ref, scale = ref
    ref = ACTS[act](ref)
    if act == "none":
        m, s = p.site_mask(x, key, rescale) if mask else (None, None)
        got = p.norm_act(x, mod, sums, m, s if rescale == "apply" else None, act=False)
        got_scale = s if rescale == "defer" else None
    else:
        got = p.norm_db_act(x, key if mask else None, mod, rescale, sums)
        got, got_scale = got if rescale == "defer" else (got, None)
    assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert (got_scale is None) == (scale is None)
    if scale is not None:
        assert torch.equal(got_scale, scale)
    assert launches.HOST["gn:plain"] == before  # CPU sites are not card fallbacks


def _composition(x, weight, bias, sums, keep, scale, act):
    """The plain composition in float64: group_norm_affine from the sums,
    the mask, the whole-batch scale, the activation."""
    y = tunet.group_norm_affine(x, weight, bias, GROUPS, 1e-5, torch.float64, sums=sums)
    if keep is not None:
        y = apply_keep_mask(y, keep, scale, "skip" if scale is None else "apply")
    return ACTS[act](y)


@pytest.mark.parametrize("mask,act,k3,rescale,n", CASES, ids=IDS)
def test_group_norm_act_gradients_match_autograd(mask, act, k3, rescale, n):
    """group_norm_act on CPU float64 tensors (the six wrappers' plain
    versions) against autograd of the composition: y and the gradients of x,
    weight, bias and (at a K3 site) the sums."""
    x0, w0, b0, key = _inputs(n, torch.float64, seed=n + 11)
    w0, b0 = w0.double(), b0.double()
    keep = scale = None
    if mask:
        keep, scale = dropblock_mask_scale(x0, key, P_DROP, BLOCK, "dependent", "elementwise",
                                           rescale)
        scale = scale.double() if rescale == "apply" else None
    g = torch.Generator().manual_seed(n + 13)
    gy = torch.randn(x0.shape, generator=g, dtype=torch.float64)

    def run(fn):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        if k3:
            s1, s2 = (t.detach().clone().requires_grad_() for t in _sums(x0))
            sums, leaves = (s1, s2), (x, w, b, s1, s2)
        else:
            sums, leaves = None, (x, w, b)
        y = fn(x, w, b, sums)
        return [t.detach() for t in (y, *torch.autograd.grad(y, leaves, gy))]

    before = {f.__name__: f.launches for f in gn.WRAPPERS}
    got = run(lambda x, w, b, sums: gn.group_norm_act(x, w, b, GROUPS, 1e-5, sums, keep, scale,
                                                      act, 0.01))
    assert {f.__name__: f.launches for f in gn.WRAPPERS} == before  # plain versions only
    ref = run(lambda x, w, b, sums: _composition(x, w, b, sums if k3 else _sums(x), keep,
                                                 scale, act))
    for name, a, r in zip(("y", "dx", "dweight", "dbias", "ds1", "ds2"), got, ref):
        assert a.shape == r.shape, name
        err = float((a.double() - r.double()).abs().max() / r.abs().max().clamp(min=1e-30))
        assert err <= (1e-7 if name in ("dweight", "dbias") else 1e-9), (name, err)


@pytest.mark.parametrize("scale_shape", [(), (2,)])
def test_group_norm_act_per_sample_scale(scale_shape):
    """A 0-d scale and a per-sample (N,) one (the kernels' stride 0 and 1),
    float64 against autograd of the composition with the scale multiplied
    in per sample."""
    x0, w0, b0, _ = _inputs(2, torch.float64, seed=5)
    w0, b0 = w0.double(), b0.double()
    scale = torch.tensor([1.25, 0.8], dtype=torch.float64)[:scale_shape[0] if scale_shape
                                                           else 1].reshape(scale_shape)
    gy = torch.randn(x0.shape, generator=torch.Generator().manual_seed(6), dtype=torch.float64)

    def run(fn):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        y = fn(x, w, b)
        return [t.detach() for t in (y, *torch.autograd.grad(y, (x, w, b), gy))]

    got = run(lambda x, w, b: gn.group_norm_act(x, w, b, GROUPS, scale=scale, act="relu"))
    ref = run(lambda x, w, b: torch.relu(
        tunet.group_norm_affine(x, w, b, GROUPS, 1e-5, torch.float64, sums=_sums(x))
        * scale.reshape(-1, 1, 1, 1)))
    for name, a, r in zip(("y", "dx", "dweight", "dbias"), got, ref):
        err = float((a.double() - r.double()).abs().max() / r.abs().max())
        assert err <= (1e-7 if name in ("dweight", "dbias") else 1e-9), (name, err)


@pytest.mark.parametrize("c,groups", [(8, 8), (16, 4), (64, 32), (256, 32), (1024, 32),
                                      (1024, 1), (24, 3), (2048, 2)])
def test_launch_geometry(c, groups):
    """A finishing block sums whole groups within its 1024 lanes, at most 8
    channels unless one group is wider; a pass's block covers at most 32
    octets and at least 8 positions a step."""
    gb = gn._groups_per_block(c, groups)
    cg = c // groups
    assert 1 <= gb <= groups and gb * cg <= gn.FIN_THREADS
    assert gb * cg <= max(8, cg) and (gb == groups or (gb + 1) * cg > 8)
    assert gn._rows(c) * min(c // 8, gn.QMAX) <= gn.THREADS and gn._rows(c) >= 8


@pytest.mark.parametrize("shape,groups,act,ok", [
    ((1, 8, 8, 64), 32, "relu", True),
    ((1, 8, 8, 12), 4, "relu", False),     # C not a multiple of 8
    ((1, 8, 8, 2048), 1, "relu", False),   # 2048 channels a group
    ((1, 8, 8, 64), 32, "gelu", False),
])
def test_group_norm_act_supported(shape, groups, act, ok):
    """The kernels' gate: never on the CPU; on the card by dtype, layout,
    channels and activation (checked here on a stand-in for a card tensor)."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    assert not gn.group_norm_act_supported(x, groups, act)

    class Card:
        is_cuda, dtype = True, torch.bfloat16

        def __init__(self, t, contiguous=True):
            self.t, self.c = t, contiguous

        def dim(self):
            return self.t.dim()

        def is_contiguous(self):
            return self.c

        @property
        def shape(self):
            return self.t.shape

    assert gn.group_norm_act_supported(Card(x), groups, act) == ok
    assert not gn.group_norm_act_supported(Card(x, contiguous=False), groups, act)


def test_cpu_model_counts_no_card_fallback():
    """A CPU forward and backward of a small model leaves gn:plain alone and
    launches none of the kernels."""
    cfg = tunet.canonical_config(filters=8, model_depth=2, group_norm_groups=4, remat=True,
                                 dropblock=tunet.DropBlockConfig(kind="dependent", block_size=3))
    model = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(3))
    before = launches.snapshot()
    x = torch.rand((2, 16, 16, 1), generator=torch.Generator().manual_seed(4))
    model(x, drop_prob=0.2, site_keys=keys, train=True).sum().backward()
    assert launches.since(before) == {}
