"""The U-Net's skip merge in K1's merge mode (ops/cuda/dropblock_kernel.py::
dropblock_merge_apply, models/unet.py::_Pass.merge_site) on the CPU.

(1) The merge mode's plain version (the wrapper on CPU tensors) is bit-equal,
values and keep counts, to the composition it replaces on the card:
group_norm_act with ReLU (its plain versions here), the skip times its
deferred scale in bf16, torch.cat and K1's bare site; with and without a
scale, at a sample offset, where rows [k, k+m) equal the full call's. (2)
The merge mode's gate, on stand-ins for card tensors. (3) The U-Net's pass
routes a merge to the merge mode exactly when the gate holds: with the card
gates opened to CPU tensors and the merge mode's call counted as its card
launch is (`on_card`), the canonical configuration's merges all take it and
count `merge:kernel`; a cat merge of another up
mode, an add merge, no fold_rescale, channels off 64, float32 and
leaky_relu count `merge:plain`; DropBlock off, training and the mask
producer make no merge on the fused route and count neither; every forward
is bit-equal to the same pass with the merge mode refused. (4) On the CPU as
it is, every fused merge runs the composition and counts `merge:plain`, and
the wrapper's plain version counts no `merge:kernel`.
The kernel is held against the composition on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import pytest
import torch

from unet_research_tpu_torch.models import sites
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
from unet_research_tpu_torch.ops.cuda import group_norm as gn
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.dropblock import dropblock_gamma_dependent

BF16 = torch.bfloat16


def _key(words=(0xFFFFFFF0, 0x80000001)):
    return torch.tensor(words, dtype=torch.int64)


def _inputs(n, h, w, c1, c2, seed):
    g = torch.Generator().manual_seed(seed)
    x = (1.5 * torch.randn((n, h, w, c1), generator=g) + 0.3).to(BF16)
    skip = torch.relu(torch.randn((n, h, w, c2), generator=g)).to(BF16)
    weight = 1.0 + 0.2 * torch.randn(c1, generator=g)
    bias = 0.2 * torch.randn(c1, generator=g)
    scale = 1.0 + 0.3 * torch.rand(n, generator=g)
    return x, skip, weight, bias, scale


def composition(x, weight, bias, groups, skip, scale, key, gamma, b, offset=0):
    """The route the merge mode replaces, as the U-Net ran it."""
    y = gn.group_norm_act(x, weight, bias, groups, 1e-5, act="relu")
    if scale is not None:
        skip = skip * scale.to(skip.dtype)[:, None, None, None]
    return dbk.dropblock_fused_apply(torch.cat([y, skip], dim=-1), None, key, gamma, b, "none",
                                     sample_offset=offset)


def merge_mode(x, weight, bias, groups, skip, scale, key, gamma, b, offset=0):
    """The merge mode as the U-Net's pass calls it."""
    p0, p1 = gn.gn_stats(x)
    ab, _ = gn.gn_stats_finish(p0, p1, x.shape[1] * x.shape[2], weight, bias, groups, 1e-5)
    return dbk.dropblock_merge_apply(x, ab, skip, scale, key, gamma, b, offset)


@pytest.mark.parametrize("scaled", [True, False], ids=["scale", "no_scale"])
@pytest.mark.parametrize("shape,groups,b", [
    ((2, 9, 8, 64, 64), 32, 3),
    ((3, 12, 10, 128, 64), 8, 7),
    ((1, 17, 5, 64, 128), 4, 5),
])
def test_plain_version_is_the_composition(shape, groups, b, scaled):
    n, h, w, c1, c2 = shape
    x, skip, weight, bias, scale = _inputs(*shape, seed=c1 + c2 + b)
    scale = scale if scaled else None
    gamma = 0.3 * h * w / (b * b * (h - b + 1) * (w - b + 1))
    before = launches.snapshot()
    got, keep = merge_mode(x, weight, bias, groups, skip, scale, _key(), gamma, b)
    assert launches.since(before) == {}  # no launch, no `merge:kernel`
    want, want_keep = composition(x, weight, bias, groups, skip, scale, _key(), gamma, b)
    assert got.dtype == BF16 and got.shape == (n, h, w, c1 + c2)
    assert torch.equal(got, want) and torch.equal(keep, want_keep)
    assert 0 < float(keep.min()) < h * w * (c1 + c2)  # something was dropped, not everything


@pytest.mark.parametrize("k,m", [(1, 2), (3, 1)])
def test_plain_version_at_a_sample_offset(k, m):
    """Rows [k, k+m) at sample_offset k equal rows [k, k+m) of the whole
    batch's call and the composition at that offset (a rank's rows)."""
    n, h, w, c = 4, 11, 9, 64
    x, skip, weight, bias, scale = _inputs(n, h, w, c, c, seed=5)
    gamma = dropblock_gamma_dependent(h, w, 3, 0.3)
    p0, p1 = gn.gn_stats(x)
    ab, _ = gn.gn_stats_finish(p0, p1, h * w, weight, bias, 32, 1e-5)
    full, full_keep = dbk.dropblock_merge_apply(x, ab, skip, scale, _key(), gamma, 3)
    rows = slice(k, k + m)
    got, keep = dbk.dropblock_merge_apply(x[rows], ab[:, rows].contiguous(), skip[rows],
                                          scale[rows], _key(), gamma, 3, sample_offset=k)
    want, want_keep = composition(x[rows], weight, bias, 32, skip[rows], scale[rows], _key(),
                                  gamma, 3, offset=k)
    assert torch.equal(got, full[rows]) and torch.equal(keep, full_keep[rows])
    assert torch.equal(got, want) and torch.equal(keep, want_keep)


class OnCard:
    """A card tensor's stand-in: the tensor, but on the card for a gate."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


@pytest.mark.parametrize("x,skip,ok", [
    ((16, 74, 72, 512), (16, 74, 72, 512), True),
    ((16, 592, 576, 64), (16, 592, 576, 64), True),
    ((2, 8, 8, 128), (2, 8, 8, 64), True),    # unequal halves
    ((2, 8, 8, 32), (2, 8, 8, 32), False),    # x's channels not a multiple of 64
    ((2, 8, 8, 64), (2, 8, 8, 40), False),    # the skip's not a multiple of 64
    ((2, 8, 8, 64), (2, 9, 8, 64), False),    # another size: a crop
    ((2, 8, 8, 64), (1, 8, 8, 64), False),    # another batch
], ids=["512", "64", "unequal", "c1_32", "c2_40", "crop", "batch"])
def test_merge_apply_gate(x, skip, ok):
    x, skip = torch.zeros(x, dtype=BF16), torch.zeros(skip, dtype=BF16)
    assert not dbk.merge_apply_supported(x, skip)  # never on the CPU
    assert dbk.merge_apply_supported(OnCard(x), OnCard(skip)) == ok
    assert not dbk.merge_apply_supported(OnCard(x.float()), OnCard(skip.float()))
    assert not dbk.merge_apply_supported(OnCard(x), OnCard(skip.float()))
    wide = torch.zeros(x.shape[:3] + (2 * x.shape[-1],), dtype=BF16)
    assert not dbk.merge_apply_supported(OnCard(wide[..., ::2]), OnCard(skip))  # strided


@pytest.fixture
def on_card(monkeypatch):
    """The card gates of the GroupNorm epilogue and of the merge mode opened
    to CPU tensors: the kernels' wrappers then run their plain versions, and
    a call of the merge mode counts `merge:kernel` as its card launch does."""
    gn_gate, merge_gate = gn.group_norm_act_supported, dbk.merge_apply_supported
    for module in (sites, tunet):
        monkeypatch.setattr(module, "group_norm_act_supported",
                            lambda x, groups, act: gn_gate(OnCard(x), groups, act))
    monkeypatch.setattr(tunet, "merge_apply_supported",
                        lambda x, skip: merge_gate(OnCard(x), OnCard(skip)))

    def launch(*args):
        out = dbk.dropblock_merge_apply(*args)
        dbk.merges["kernel"] += 1
        return out

    monkeypatch.setattr(tunet, "dropblock_merge_apply", launch)


def _model(**overrides):
    db = tunet.DropBlockConfig(kind="dependent", block_size=3,
                               mask_impl=overrides.pop("mask_impl", "fused"))
    cfg = tunet.canonical_config(**{"filters": 64, "model_depth": 2, "dtype": BF16,
                                    "conv_impl": "torch", "dropblock": db, **overrides})
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).eval()


def _forward(model, train=False, drop_prob=0.2):
    x = torch.rand((2, 16, 16, 1), generator=torch.Generator().manual_seed(5))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(6))
    before = launches.snapshot()
    with torch.no_grad():
        out = model(x, drop_prob=drop_prob, site_keys=keys, train=train)
    got = launches.since(before)
    return out, {k: got.get(f"merge:{k}", 0) for k in ("kernel", "plain")}


# (configuration overrides, merges on the merge mode, merges on the composition)
ROUTES = {
    "canonical": ({}, 2, 0),
    "c32": ({"filters": 32}, 1, 1),              # the top merge's 32 channels
    "upsample": ({"up_mode": "upsample"}, 0, 2),
    "add": ({"connection": "add"}, 0, 2),
    "no_fold": ({"fold_rescale": False}, 0, 2),
    "float32": ({"dtype": torch.float32}, 0, 2),
    "leaky_relu": ({"activation": "leaky_relu"}, 0, 2),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_pass_routes_merges_by_the_gate(on_card, monkeypatch, route):
    overrides, kernel, plain = ROUTES[route]
    model = _model(**overrides)
    out, counts = _forward(model)
    assert counts == {"kernel": kernel, "plain": plain}
    monkeypatch.setattr(tunet._Pass, "merge_site", lambda self, *args: None)
    want, refused = _forward(model)
    assert refused == {"kernel": 0, "plain": kernel + plain}
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["drop_off", "train", "mask_producer", "no_connection"])
def test_merges_off_the_fused_route_count_nothing(on_card, case):
    model = _model(mask_impl="kernel" if case == "mask_producer" else "fused",
                   **({"connection": "none"} if case == "no_connection" else {}))
    _, counts = _forward(model, train=case == "train",
                         drop_prob=None if case == "drop_off" else 0.2)
    assert counts == {"kernel": 0, "plain": 0}


def test_cpu_merges_run_the_composition():
    """Without the stand-in gates every CPU merge runs the composition."""
    _, counts = _forward(_model())
    assert counts == {"kernel": 0, "plain": 2}


def test_merge_counts_are_credited_per_replay():
    """`merge:*` are launch-like counts: a capture's counts keep them and a
    replay's credit adds them, as `up:*`."""
    before = launches.snapshot()
    counts = launches.launched({"merge:kernel": 4, "merge:plain": 1, "graph:captures": 1})
    assert counts == {"merge:kernel": 4, "merge:plain": 1}
    launches.credit(counts, 3)
    assert launches.since(before) == {"merge:kernel": 12, "merge:plain": 3}
    launches.credit(counts, -3)
    assert launches.since(before) == {}

