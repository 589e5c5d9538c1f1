"""The port's subpackages export the JAX package's public names, and the
names added for that (param_count, as_variables, split_variables,
ArrayDataset.as_float, create_train_state / make_optimizer / get_lr /
set_lr, the sharding twins, streaming_ensemble's per-member form,
streaming_ensemble_batched with a generator) compute what JAX's do.

Tolerances: counts, datasets, shards and pixels exact; one SGD update with
momentum and clipping 1e-6 + 1e-5 relative (float32 updates of the same
gradients); the streaming statistics 1e-6 (float32 merges of the same
members in the same order)."""

import ast
import importlib
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.data.dataset import ArrayDataset as JArrayDataset
from unet_research_tpu.parallel.mesh import make_mesh as jmake_mesh
from unet_research_tpu.parallel.mesh import shard_ensemble_keys as jshard_ensemble_keys
from unet_research_tpu.train.state import create_train_state as jcreate_train_state
from unet_research_tpu.train.state import get_lr as jget_lr
from unet_research_tpu.train.state import set_lr as jset_lr
from unet_research_tpu.uncertainty.ensemble import streaming_ensemble as jstreaming_ensemble
from unet_research_tpu.utils.general import to_pil
from unet_research_tpu_torch.data import ArrayDataset, shard_batch
from unet_research_tpu_torch.models import (
    UNet,
    as_variables,
    canonical_config,
    param_count,
    split_variables,
)
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.parallel import (
    Mesh,
    data_sharding,
    replicated,
    shard_ensemble_keys,
)
from unet_research_tpu_torch.train import create_train_state
from unet_research_tpu_torch.train.state import get_lr, make_optimizer, set_lr
from unet_research_tpu_torch.uncertainty import streaming_ensemble, streaming_ensemble_batched
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict
from unet_research_tpu_torch.utils.general import to_u8

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("cli", "data", "evaluation", "models", "ops", "parallel", "train",
               "uncertainty", "utils")
# JAX names without a twin, and why (ROADMAP.md lists them among the
# differences): to_pil returns a PIL image, and the port does not depend on
# PIL; utils.general.to_u8 gives its pixels (test_to_u8_is_to_pils_pixels).
NOT_PORTED = {"utils": {"to_pil"}}
SMALL = dict(filters=4, model_depth=2, group_norm_groups=2)


def _jax_exports(sub: str) -> list:
    """The names that unet_research_tpu/<sub>/__init__.py imports from the
    package (its public names)."""
    tree = ast.parse((ROOT / "unet_research_tpu" / sub / "__init__.py").read_text())
    return sorted(alias.asname or alias.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)
                  and (node.module or "").startswith("unet_research_tpu")
                  for alias in node.names)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_name_imports_from_the_port(sub):
    port = importlib.import_module(f"unet_research_tpu_torch.{sub}")
    names = _jax_exports(sub)
    missing = [n for n in names if n not in NOT_PORTED.get(sub, ()) and not hasattr(port, n)]
    assert not missing, f"unet_research_tpu_torch.{sub} lacks {missing}"
    assert NOT_PORTED.get(sub, set()) <= set(names)
    exported = getattr(port, "__all__", None)
    if exported is not None:
        assert set(names) - NOT_PORTED.get(sub, set()) <= set(exported)


def test_the_reference_import_works():
    from unet_research_tpu_torch.models import UNet as U, canonical_config as c  # noqa: F401


def test_importing_loads_no_jax_and_no_kernel_library():
    """The subpackages' imports pull in the engines, the trainer and the
    kernel wrappers, and still load no jax and build or load no library."""
    code = (
        "import importlib, sys\n"
        f"for sub in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('unet_research_tpu_torch.' + sub)\n"
        "from unet_research_tpu_torch.ops.cuda import build\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'unet_research_tpu')), len(build._LIBS))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0"


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_param_count_and_variables_match_jax(norm):
    jcfg = junet.canonical_config(norm=norm, **SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    model = UNet(canonical_config(norm=norm, **SMALL), device="cpu")
    sd = jax_params_to_state_dict(variables, jcfg)
    model.load_state_dict(sd)
    want = junet.param_count(variables["params"])
    assert param_count(model) == want
    params, stats = split_variables(model.state_dict())
    jparams, jstats = junet.split_variables(dict(variables))
    assert param_count(params) == junet.param_count(jparams) == want
    assert (stats is None) == (jstats is None) == (norm == "group")
    if stats is not None:
        assert param_count(stats) - len(stats) // 3 == junet.param_count(jstats)
        assert all(k.rsplit(".", 1)[-1].startswith(("running_", "num_batches")) for k in stats)
    bundle = as_variables({"params": params, "batch_stats": stats})
    assert bundle.keys() == sd.keys() and all(torch.equal(bundle[k], sd[k]) for k in sd)
    assert as_variables(sd) == dict(sd)
    assert split_variables({"params": params, "batch_stats": None}) == (params, None)
    assert param_count(list(model.parameters())) == want


def test_as_float_matches_jax(rng):
    arrays = [rng.integers(0, 256, (3, 5, 4, 1), dtype=np.uint8) for _ in range(3)]
    for got, ref in zip(ArrayDataset(*arrays).as_float(), JArrayDataset(*arrays).as_float()):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_create_train_state_matches_jax(rng, clip_norm):
    """Two updates from the same weights and gradients, at two learning
    rates set through set_lr, with momentum 0.99 (and a global-norm clip)."""
    jcfg = junet.canonical_config(**SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))
    model = UNet(canonical_config(**SMALL), device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    jstate = jcreate_train_state(variables["params"], 0.05, 0.99, clip_norm)
    state = create_train_state(model, 0.05, 0.99, clip_norm)
    assert state.step == int(jstate.step) == 0
    # JAX keeps the learning rate in float32, the port as the number given
    assert np.float32(get_lr(state)) == np.float32(jget_lr(jstate.opt_state)) == np.float32(0.05)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    for lr in (0.05, 0.02):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
            jstate.params)
        jstate = jstate.replace(opt_state=jset_lr(jstate.opt_state, lr))
        assert set_lr(state, lr) is state
        assert np.float32(get_lr(state)) == np.float32(jget_lr(jstate.opt_state)) == \
            np.float32(lr)
        tgrads = jax_params_to_state_dict({"params": grads}, jcfg)
        for name, p in zip(names, state.params):
            p.grad.copy_(tgrads[name])
        jstate = jstate.apply_gradients(grads, lr)
        state.apply_gradients()
    assert state.step == int(jstate.step) == 2
    ref = jax_params_to_state_dict({"params": jstate.params}, jcfg)
    sd = model.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_make_optimizer_builds_the_state():
    model = UNet(canonical_config(**SMALL), device="cpu")
    state = make_optimizer(0.1, momentum=0.9, clip_norm=1.0)(model)
    assert (state.lr, state.clip_norm, state.optimizer.param_groups[0]["momentum"]) == \
        (0.1, 1.0, 0.9)
    assert [id(p) for p in state.params] == [id(p) for p in model.parameters()]


@pytest.mark.parametrize("n", [8, 16])
def test_sharding_twins_match_jax_placement(n):
    """Rank r of an 8-rank mesh holds the rows that JAX's data sharding puts
    on device r of its 8-device CPU mesh; replicated holds everything."""
    jmesh = jmake_mesh(data=8)
    keys = np.arange(n * 2, dtype=np.uint32).reshape(n, 2)
    placed = jshard_ensemble_keys(jmesh, jnp.asarray(keys))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    batch = (np.arange(n * 3, dtype=np.float32).reshape(n, 3), torch.arange(n))
    for rank, device in enumerate(jmesh.devices.reshape(-1)):
        mesh = Mesh(None, 8, 1, rank, torch.device("cpu"))
        np.testing.assert_array_equal(shard_ensemble_keys(mesh, keys), by_device[device])
        rows = shard_batch(batch, data_sharding(mesh))
        np.testing.assert_array_equal(rows[0], batch[0][rank * n // 8:(rank + 1) * n // 8])
        assert torch.equal(rows[1], shard_batch(batch[1], mesh))
        whole = shard_batch(batch, replicated(mesh))
        assert whole[0] is batch[0] and whole[1] is batch[1]


def test_to_u8_is_to_pils_pixels(rng):
    a = rng.random((7, 9, 1), dtype=np.float32)
    a[0, 0], a[0, 1] = -0.5, 1.5
    np.testing.assert_array_equal(to_u8(a), np.asarray(to_pil(a)))


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (10, 3, 0), (9, 9, 0)])
def test_per_member_streaming_ensemble_matches_jax(rng, total, chunk, return_num):
    """chunk_fn=False: sample_fn maps one member's input; JAX vmaps it, the
    port calls it per member."""
    table = rng.random((total, 4, 3), dtype=np.float32)
    jtable = jnp.asarray(table)
    jmean, jstd, jsaved = jstreaming_ensemble(lambda i: jtable[i] * 2.0, jnp.arange(total),
                                              chunk, return_num)
    calls = []

    def sample(i):
        calls.append(int(i))
        return torch.from_numpy(table[int(i)]) * 2.0

    mean, std, saved = streaming_ensemble(sample, torch.arange(total), chunk, return_num)
    assert calls == list(range(total))
    for got, ref in ((mean, jmean), (std, jstd), (saved, jsaved)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (10, 3, 0)])
def test_batched_ensemble_draws_from_the_generator_in_chunk_order(total, chunk, return_num):
    """batch_fn(generator, size) draws each chunk's members from the
    generator it is given; the statistics equal a direct reduction of the
    same draws made in the same order."""
    seen = []

    def batch_fn(gen, size):
        seen.append(gen)
        return torch.rand((size, 4, 3), generator=gen)

    gen = torch.Generator().manual_seed(7)
    mean, std, saved = streaming_ensemble_batched(batch_fn, gen, total, chunk, return_num)
    assert seen and all(g is gen for g in seen)
    ref_gen = torch.Generator().manual_seed(7)
    sizes = ([return_num] if return_num else []) + [chunk] * ((total - return_num) // chunk)
    sizes += [(total - return_num) % chunk] if (total - return_num) % chunk else []
    ref = torch.cat([torch.rand((s, 4, 3), generator=ref_gen) for s in sizes])
    torch.testing.assert_close(mean, ref.mean(0), rtol=0, atol=1e-6)
    torch.testing.assert_close(std, ref.std(0), rtol=0, atol=1e-6)
    assert torch.equal(saved, ref[:return_num])
    assert torch.equal(gen.get_state(), ref_gen.get_state())


def test_jax_exports_are_read():
    """The enumeration reads real names (a guard on _jax_exports itself)."""
    assert "canonical_config" in _jax_exports("models")
    assert "streaming_ensemble_batched" in _jax_exports("uncertainty")
    assert _jax_exports("cli") == []
    assert tunet.param_count is param_count
