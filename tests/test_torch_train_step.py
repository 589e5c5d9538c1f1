"""One train step of the port (unet_research_tpu_torch/train/loop.py) against
the JAX trainer's jitted step, from the same weights (JAX init ->
utils/convert.py::jax_params_to_state_dict) and the same batch.

Compared: the loss, every gradient (the momentum trace after the first
step, which is the clipped gradient in both optimizers) and the updated
parameters. float32 throughout, with one tolerance for every case: loss
rtol 1e-5; gradients and parameters atol 2e-6 plus rtol 1e-4 (the two
frameworks convolve and reduce in different orders, and the errors grow
through the backward of 8-20 layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.train import POLICIES as JPOLICIES
from unet_research_tpu.train import Trainer as JTrainer
from unet_research_tpu.train import TrainerConfig as JTrainerConfig
from unet_research_tpu.train.policies import lf_policy as jlf_policy
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import pair_conv as tpc
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig, lf_policy
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)
ATOL, RTOL = 2e-6, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here, and the suite runs
    several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(db=None, **kw):
    kw = {**SMALL, **kw}
    db = db or {"kind": None}
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(**db), **kw)
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(**db), **kw)
    return jcfg, tcfg


def _batch(rng, h=20, w=24):
    im = rng.random((1, h, w, 1), dtype=np.float32)
    gt = (rng.random((1, h, w, 1)) > 0.7).astype(np.float32)
    mask = np.ones((1, h, w, 1), np.float32)
    mask[:, :3] = 0.0
    mask[:, :, -2:] = 0.0
    return im, gt, mask


class _Both:
    """The JAX trainer and the port's on one configuration and one set of
    weights (JAX init)."""

    def __init__(self, jcfg, tcfg, jpolicy, tpolicy, lr=0.05, clip_norm=None, seed=0):
        self.jcfg, self.lr = jcfg, lr
        kw = dict(lr=lr, momentum=0.99, clip_norm=clip_norm, auto_lr_find=False, seed=3,
                  verbose=False)
        self.jt = JTrainer(junet.UNet(jcfg), jpolicy, JTrainerConfig(**kw))
        variables = self.jt.init_params(seed=seed)
        self.jstate = self.jt.create_state(variables, lr)
        self.model = tunet.UNet(tcfg, device="cpu")
        self.model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
        self.tt = Trainer(self.model, tpolicy, TrainerConfig(**kw), device="cpu")
        self.tstate = self.tt.create_state(None, lr)

    def jax_step(self, im, gt, mask, size=-1):
        self.jstate, loss = self.jt._train_step(self.jstate, jnp.asarray(im), jnp.asarray(gt),
                                                jnp.asarray(mask), self.lr,
                                                jax.random.PRNGKey(0), size)
        return float(loss)

    def port_step(self, im, gt, mask, size=-1, site_keys=None):
        loss = self.tt.train_step(self.tstate, *(torch.from_numpy(a) for a in (im, gt, mask)),
                                  self.lr, size, site_keys=site_keys)
        return float(loss)

    def jax_trace(self) -> dict:
        traces = [s for s in jax.tree_util.tree_leaves(
            self.jstate.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
            if isinstance(s, optax.TraceState)]
        assert len(traces) == 1
        return jax_params_to_state_dict(traces[0].trace, self.jcfg)

    def port_trace(self) -> dict:
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        return dict(zip(names, self.tstate.momentum_buffers()))

    def assert_equal(self, jloss, tloss):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
        ref = self.jax_trace()
        ours = self.port_trace()
        assert ref.keys() == ours.keys()
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=f"gradient {k}")
        ref = jax_params_to_state_dict(
            {"params": self.jstate.params, "batch_stats": self.jstate.batch_stats}, self.jcfg)
        sd = self.model.state_dict()
        for k, v in ref.items():
            if "running" in k or "num_batches" in k:
                continue
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=f"parameter {k}")


POLICY_CASES = [("none", -1), ("red", -1), ("uni", 16), ("uni", -1), ("rat", 16),
                ("rsz-rat", 16), ("lft", -1), ("hft", -1), ("lft-up", -1)]


@pytest.mark.parametrize("kind,size", POLICY_CASES, ids=[f"{k}{s}" for k, s in POLICY_CASES])
def test_step_per_policy_matches_jax(rng, kind, size):
    """DropBlock off, non-square 20x24 input, MF size entries -1 and 16, LF
    train_size 16: loss, gradients and updated parameters equal JAX's."""
    jcfg, tcfg = _configs()
    if kind in ("lft", "hft", "lft-up"):
        jpol, tpol = jlf_policy(kind, 16), lf_policy(kind, 16)
    else:
        jpol, tpol = JPOLICIES[kind], POLICIES[kind]
    both = _Both(jcfg, tcfg, jpol, tpol)
    im, gt, mask = _batch(rng)
    both.assert_equal(both.jax_step(im, gt, mask, size), both.port_step(im, gt, mask, size))
    assert both.tstate.step == int(both.jstate.step) == 1


@pytest.mark.parametrize("clip_norm", [0.05, 1e3])
def test_two_steps_with_momentum_and_clip_match_jax(rng, clip_norm):
    """Two updates: the momentum trace v = g + 0.99 v and the global-norm
    clip (0.05 clips both steps, 1e3 neither)."""
    jcfg, tcfg = _configs()
    both = _Both(jcfg, tcfg, JPOLICIES["none"], POLICIES["none"], clip_norm=clip_norm)
    for seed in (1, 2):
        im, gt, mask = _batch(np.random.default_rng(seed))
        jl, tl = both.jax_step(im, gt, mask), both.port_step(im, gt, mask)
    both.assert_equal(jl, tl)
    g = torch.cat([v.reshape(-1) for v in both.port_trace().values()])
    assert (float(g.norm()) < 0.2) == (clip_norm == 0.05)  # the clip acted, or not


def _capture_site_keys(monkeypatch):
    calls = []
    for name in ("dropblock_dependent", "dropblock_independent"):
        real = getattr(junet, name)

        def spy(x_, key, *a, _real=real, **k):
            calls.append(np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.int64))
            return _real(x_, key, *a, **k)

        monkeypatch.setattr(junet, name, spy)
    return calls


@pytest.mark.parametrize("kind", ["dependent", "independent"])
def test_dropblock_step_with_jax_keys_matches_jax(rng, monkeypatch, kind):
    """DropBlock on at step 3 of the linear ramp (drop_prob 0.15 in float32
    arithmetic), the port handed the site keys the JAX step drew (its step
    run without jit so the spy sees concrete keys). The port's config keeps
    mask_impl='fused', which train mode routes to the mask producer."""
    db = dict(kind=kind, block_size=3, use_scheduler=True, start_drop_prob=0.0,
              max_drop_prob=0.2, nr_steps=5)
    jcfg, tcfg = _configs(db=db)
    jcfg = dataclasses.replace(jcfg, dropblock=junet.DropBlockConfig(**db, mask_impl=None))
    both = _Both(jcfg, tcfg, JPOLICIES["none"], POLICIES["none"])
    both.jstate = both.jstate.replace(step=jnp.asarray(3, jnp.int32))
    both.tstate.step = 3
    im, gt, mask = _batch(rng)
    calls = _capture_site_keys(monkeypatch)
    with jax.disable_jit():
        jl = both.jax_step(im, gt, mask)
    keys = torch.from_numpy(np.stack(calls))
    assert keys.shape == (both.model.num_mask_sites(), 2) == (12, 2)
    with torch.no_grad():
        on = both.model(torch.from_numpy(im), drop_prob=0.15, site_keys=keys, train=True)
        off = both.model(torch.from_numpy(im))
    assert float((on - off).abs().max()) > 1e-3  # DropBlock really acted
    both.assert_equal(jl, both.port_step(im, gt, mask, site_keys=keys))


def test_pair_route_step_matches_jax(rng, monkeypatch):
    """conv_impl='pair' at 64 filters: the three eligible convs run the K3
    Function, whose backward sends each dx through conv3x3_pair_dx with the
    GroupNorm sums' cotangents to fold; the step equals the JAX step on its
    XLA convs."""
    jcfg, tcfg = _configs(filters=64, model_depth=1, group_norm_groups=8)
    both = _Both(jcfg, tcfg, JPOLICIES["none"], POLICIES["none"])
    calls = []
    real = tpc.conv3x3_pair_dx

    def spy(dy, kernel, *fold):
        assert len(fold) == 3
        calls.append((tuple(dy.shape), tuple(kernel.shape)))
        return real(dy, kernel, *fold)

    monkeypatch.setattr(tpc, "conv3x3_pair_dx", spy)
    im, gt, mask = _batch(rng, 16, 16)
    both.assert_equal(both.jax_step(im, gt, mask), both.port_step(im, gt, mask))
    assert sorted(calls) == [((1, 16, 16, 64), (3, 3, 64, 64))] * 2 + [
        ((1, 16, 16, 64), (3, 3, 128, 64))]


def _step_grads(tcfg, state_dict, batch, keys, drop_prob):
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(state_dict)
    im, gt, mask = (torch.from_numpy(a) for a in batch)
    from unet_research_tpu_torch.ops.losses import masked_rescaled_bce

    loss = masked_rescaled_bce(model(im, drop_prob=drop_prob, site_keys=keys, train=True), gt,
                               mask)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}, model


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_remat_equals_no_remat(rng, norm):
    """remat re-runs the conv, pool and up blocks in the backward with their
    bound site keys: the same loss, gradients and running statistics."""
    db = dict(kind="dependent", block_size=3)
    _, tcfg = _configs(db=db, norm=norm)
    base = tunet.UNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    keys = tunet.draw_site_keys(base.num_mask_sites(), torch.Generator().manual_seed(2))
    batch = _batch(rng)
    l0, g0, m0 = _step_grads(tcfg, base.state_dict(), batch, keys, 0.2)
    l1, g1, m1 = _step_grads(dataclasses.replace(tcfg, remat=True), base.state_dict(), batch,
                             keys, 0.2)
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-7, rtol=1e-6, msg=k)
    for (k, a), b in zip(m0.state_dict().items(), m1.state_dict().values()):
        torch.testing.assert_close(b, a, atol=0, rtol=0, msg=k)


def _bn_level(key: str, depth: int) -> int:
    """The resolution level (0 = full) of a BatchNorm site of the port."""
    parts = key.split(".")
    if parts[0] == "conn_block":
        return depth
    d, part = int(parts[1]), int(parts[2])
    if parts[0] == "down_blocks":
        return d + part  # the pool norm runs one level down
    return depth - 1 - d


def test_batchnorm_step_matches_jax(rng):
    """norm='batch': the train step normalises with batch statistics in both;
    the running means agree and the running variances agree up to torch's
    unbiased n/(n-1) factor (flax updates with the biased variance)."""
    jcfg, tcfg = _configs(norm="batch")
    both = _Both(jcfg, tcfg, JPOLICIES["none"], POLICIES["none"])
    im, gt, mask = _batch(rng)
    both.assert_equal(both.jax_step(im, gt, mask), both.port_step(im, gt, mask))
    ref = jax_params_to_state_dict({"params": both.jstate.params,
                                    "batch_stats": both.jstate.batch_stats}, jcfg)
    sd = both.model.state_dict()
    checked = 0
    for k, v in ref.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5)
        elif k.endswith("running_var"):
            lvl = _bn_level(k, jcfg.model_depth)
            n = (20 >> lvl) * (24 >> lvl)
            biased = (v.numpy() - 0.9) / 0.1
            unbiased = (sd[k].numpy() - 0.9) / 0.1
            np.testing.assert_allclose(unbiased * (n - 1) / n, biased, atol=2e-5, rtol=1e-4)
            assert int(sd[k.replace("running_var", "num_batches_tracked")]) == 1
            checked += 1
    assert checked == 14  # 2 per conv block (5), one per pool (2) and up (2) norm
