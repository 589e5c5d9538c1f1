"""The port's UNet (unet_research_tpu_torch/models/unet.py) against the
reference golden and the JAX UNet on the same weights and inputs.

Weights: JAX init -> utils/convert.py::jax_params_to_state_dict. DropBlock:
the JAX model's per-site keys are captured by a spy on its dropblock
functions and handed to the port as `site_keys`. float32 throughout;
atol 1e-5 against JAX (different conv/reduction orders), 1e-4 against the
golden (the gate of tests/test_reference_parity.py:366-375)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu_torch.cli.common import CONV_IMPLS
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_reference_checkpoint,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "reference_unet_small.npz")
SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)


def _configs(db=None, **kw):
    """The same configuration for both packages; conv_impl in JAX's names
    (xla is the port's cuDNN route, conv_impl='torch')."""
    kw = {**SMALL, **kw}
    jdb = junet.DropBlockConfig(**(db or {}))
    tdb_kw = dict(db or {})
    tdb_kw.setdefault("mask_impl", "fused")
    if tdb_kw["mask_impl"] is None:
        tdb_kw["mask_impl"] = "elementwise"
    jcfg = junet.canonical_config(dropblock=jdb, **kw)
    if "conv_impl" in kw:
        kw["conv_impl"] = CONV_IMPLS[kw["conv_impl"]]
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(**tdb_kw), **kw)
    return jcfg, tcfg


def _pair(jcfg, tcfg, x, seed=0):
    """JAX params and the port model holding the same weights."""
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    return variables, model


def test_golden_loads_straight_into_the_port():
    data = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd:")}
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        ours = model(torch.from_numpy(data["x"])).numpy()
    assert np.max(np.abs(ours - data["y"])) <= 1e-4


def test_reference_checkpoint_prefixes_are_stripped(tmp_path):
    data = np.load(GOLDEN)
    sd = {f"model._model.{k[3:]}": torch.from_numpy(data[k])
          for k in data.files if k.startswith("sd:")}
    path = tmp_path / "model-epoch=01-val_loss=0.50.ckpt"
    torch.save({"state_dict": sd, "epoch": 1}, str(path))
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu")
    model.load_state_dict(load_reference_checkpoint(str(path)))
    with torch.no_grad():
        ours = model(torch.from_numpy(data["x"])).numpy()
    assert np.max(np.abs(ours - data["y"])) <= 1e-4


EVAL_CONFIGS = [
    dict(),
    dict(pool_mode="avg", up_mode="upsample", connection="add"),
    dict(pool_mode="conv", connection="none"),
    dict(norm=None, activation="leaky_relu", pool_mode="conv"),
    dict(norm=None, up_mode="upsample", connection="cat", activation="elu"),
    dict(pool_mode="avg", activation="gelu"),
    dict(same_padding=False, activation="silu"),
    dict(norm="batch", activation="tanh"),
    # the ensembles' routes: K3 with the fused masks, cuDNN with plain masks
    dict(conv_impl="pair", db=dict(mask_impl="fused")),
    dict(conv_impl="xla", db=dict(mask_impl="elementwise")),
]


@pytest.mark.parametrize("kw", EVAL_CONFIGS, ids=lambda kw: "-".join(map(str, kw.values())) or "canonical")
def test_eval_forward_matches_jax(rng, kw):
    jcfg, tcfg = _configs(**kw)
    h = 44 if not kw.get("same_padding", True) else 36
    x = rng.standard_normal((2, h, h + 4, 1)).astype(np.float32)
    variables, model = _pair(jcfg, tcfg, x)
    if kw.get("norm") == "batch":
        # non-trivial running statistics
        stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape),
                                       variables["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": stats}
        model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    ref = np.asarray(junet.UNet(jcfg).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _capture_site_keys(monkeypatch, jcfg, variables, x, drop_prob, seed):
    """Run the JAX model (not jitted) and record the key words each mask
    site draws, in call order."""
    calls = []
    for name in ("dropblock_dependent", "dropblock_independent"):
        real = getattr(junet, name)

        def spy(x_, key, *a, _real=real, **k):
            calls.append(np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.int64))
            return _real(x_, key, *a, **k)

        monkeypatch.setattr(junet, name, spy)
    ref = junet.UNet(jcfg).apply(variables, jnp.asarray(x), drop_prob=drop_prob,
                                 rngs={"dropblock": jax.random.PRNGKey(seed)})
    return np.asarray(ref), torch.from_numpy(np.stack(calls))


ACTIVE = [
    (dict(kind="dependent"), dict()),
    (dict(kind="independent"), dict()),
    (dict(kind="dependent", block_size=5), dict(fold_rescale=False)),
    (dict(kind="dependent", block_size=4), dict()),
    (dict(kind="dependent", mask_impl="kernel"), dict(connection="add")),
    (dict(kind="dependent", mask_impl=None), dict(activation="leaky_relu")),
    (dict(kind="independent"), dict(norm=None, pool_mode="conv")),
]


@pytest.mark.parametrize("db,kw", ACTIVE)
def test_dropblock_forward_matches_jax(monkeypatch, rng, db, kw):
    jcfg, tcfg = _configs(db=db, **kw)
    x = rng.standard_normal((3, 32, 28, 1)).astype(np.float32)
    variables, model = _pair(jcfg, tcfg, x)
    ref, keys = _capture_site_keys(monkeypatch, jcfg, variables, x, 0.15, seed=5)
    assert keys.shape == (model.num_mask_sites(), 2) == (12, 2)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), drop_prob=0.15, site_keys=keys).numpy()
        off = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(ours - off)) > 1e-3  # DropBlock really acted
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_pair_route_matches_jax(monkeypatch, rng):
    """conv_impl='pair' at 64 filters: the three eligible convs (down0/conv1,
    post0/conv0, post0/conv1) go through conv3x3_pair and their sums feed
    GroupNorm; the result still matches the JAX model."""
    jcfg, tcfg = _configs(db=dict(kind="dependent"), filters=64, model_depth=1,
                          group_norm_groups=8)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    variables, model = _pair(jcfg, tcfg, x)
    ref, keys = _capture_site_keys(monkeypatch, jcfg, variables, x, 0.15, seed=2)
    calls = []
    real = tunet.conv3x3_pair

    def spy(xin, kernel, stats=False):
        calls.append((tuple(xin.shape), tuple(kernel.shape), stats))
        return real(xin, kernel, stats)

    monkeypatch.setattr(tunet, "conv3x3_pair", spy)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), drop_prob=0.15, site_keys=keys).numpy()
    assert calls == [((2, 16, 16, 64), (3, 3, 64, 64), True),
                     ((2, 16, 16, 128), (3, 3, 128, 64), True),
                     ((2, 16, 16, 64), (3, 3, 64, 64), True)]
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_identity_at_zero_drop_prob(rng):
    _, tcfg = _configs(db=dict(kind="dependent"))
    model = tunet.UNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((2, 32, 28, 1)).astype(np.float32))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(1))
    with torch.no_grad():
        on = model(x, drop_prob=0.0, site_keys=keys)
        off = model(x)
    torch.testing.assert_close(on, off, atol=1e-6, rtol=0)


def test_site_keys_are_required_when_active():
    _, tcfg = _configs(db=dict(kind="dependent"))
    model = tunet.UNet(tcfg, device="cpu")
    with pytest.raises(ValueError):
        model(torch.zeros((1, 16, 16, 1)), drop_prob=0.1)


def test_config_checks():
    with pytest.raises(ValueError):
        tunet.canonical_config(conv_impl="xla")
    with pytest.raises(ValueError):
        tunet.DropBlockConfig(mask_impl="bitplane")
    assert tunet.UNet(tunet.canonical_config(), device="cpu").num_mask_sites() == 22


def test_seeded_init_is_reproducible():
    cfg = tunet.canonical_config(**SMALL)
    a = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    b = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_bf16_forward_is_close_to_f32(rng):
    _, tcfg = _configs(db=dict(kind="dependent"))
    model = tunet.UNet(tcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    low = tunet.UNet(dataclasses.replace(tcfg, dtype=torch.bfloat16), device="cpu")
    low.load_state_dict(model.state_dict())
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(6))
    with torch.no_grad():
        ref = model(x, drop_prob=0.15, site_keys=keys)
        out = low(x, drop_prob=0.15, site_keys=keys)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) < 0.1
