"""The port's checkpoint readers (unet_research_tpu_torch/utils/convert.py)
against flax and the JAX package: `read_flax_msgpack` equals
flax.serialization.msgpack_restore leaf for leaf and bit for bit on the JAX
package's checkpoints (meta, optimizer state, a bfloat16 tree, a BatchNorm
bundle, chunked leaves) and on every msgpack type family; the model that
`load_model_checkpoint` builds from a JAX checkpoint matches the JAX model's
forward to 1e-5 in float32; torch files load as they are."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import unet_research_tpu.models.unet as junet
from unet_research_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.train.checkpoint import save_checkpoint
from unet_research_tpu_torch.utils.convert import (
    checkpoint_format,
    load_model_checkpoint,
    read_flax_msgpack,
)

SMALL = dict(filters=4, model_depth=2, group_norm_groups=2)


def assert_same_tree(ref, got, key="<root>"):
    """Leaf for leaf: the same containers and keys, equal scalars of the
    same type, arrays of the same dtype, shape and bytes; flax's bfloat16
    arrays against torch.bfloat16 tensors by their bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), key
        for k in ref:
            assert_same_tree(ref[k], got[k], f"{key}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), key
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same_tree(r, g, f"{key}[{i}]")
    elif isinstance(ref, np.ndarray) and ref.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, key
        assert tuple(got.shape) == ref.shape, key
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert type(got) is type(ref) and got.dtype == ref.dtype and got.shape == ref.shape, key
        assert np.asarray(got).tobytes() == np.asarray(ref).tobytes(), key
    else:
        assert type(got) is type(ref) and (got == ref or (got != got and ref != ref)), key


def _jax_variables(seed=0, **kw):
    cfg = junet.canonical_config(**{**SMALL, **kw})
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    return cfg, junet.UNet(cfg).init(jax.random.PRNGKey(seed), x)


def _restore(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """Files written by the JAX package's save_checkpoint."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    cfg, variables = _jax_variables()
    params = variables["params"]
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.sgd(1e-3, momentum=0.99))
    files = {
        "params_meta_opt": jax_save_checkpoint(
            str(root / "model-epoch=03-val_loss=0.25.ckpt"), params,
            meta={"epoch": 3, "val_loss": 0.25, "lr": 1e-3}, opt_state=tx.init(params)),
        "bfloat16": jax_save_checkpoint(
            str(root / "bf16.ckpt"), jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)),
    }
    bcfg, bvars = _jax_variables(seed=1, norm="batch")
    stats = jax.tree_util.tree_map(lambda a: a + 0.25, bvars["batch_stats"])
    files["batchnorm_bundle"] = jax_save_checkpoint(
        str(root / "bn.ckpt"), {"params": bvars["params"], "batch_stats": stats})
    return files, {"group": (cfg, params), "batch": (bcfg, {"params": bvars["params"],
                                                             "batch_stats": stats})}


@pytest.mark.parametrize("name", ["params_meta_opt", "bfloat16", "batchnorm_bundle"])
def test_read_flax_msgpack_equals_flax(jax_checkpoints, name):
    path = jax_checkpoints[0][name]
    assert checkpoint_format(path) == "msgpack"
    assert_same_tree(_restore(path), read_flax_msgpack(path))


def test_chunked_leaves_are_reassembled(tmp_path, monkeypatch):
    """flax splits a leaf above MAX_CHUNK_SIZE into chunks; shrink the limit
    so that the test model's kernels (and a bfloat16 leaf) are chunked."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    _, variables = _jax_variables()
    tree = {"params": variables["params"],
            "bf16": np.asarray(jnp.arange(300, dtype=jnp.bfloat16).reshape(10, 30))}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(data)
    assert_same_tree(serialization.msgpack_restore(data), read_flax_msgpack(str(path)))


def test_every_msgpack_family(tmp_path):
    """Each msgpack type family at the edges of its width."""
    tree = {
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [1.5, -0.0, float("inf"), float("nan")],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "consts": [None, True, False],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(k): k for k in range(15)}, {str(k): k for k in range(16)},
                 {str(k): k for k in range(70000)}],
        "numpy": [np.float32(2.5), np.int64(-7), np.arange(12, dtype=np.int32).reshape(3, 4),
                  np.zeros((0, 3), np.uint8), np.array([True, False]),
                  np.arange(6, dtype=np.float64).reshape(2, 3)],
    }
    data = serialization.msgpack_serialize(tree)
    path = tmp_path / "types.msgpack"
    path.write_bytes(data)
    assert_same_tree(serialization.msgpack_restore(data), read_flax_msgpack(str(path)))


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_loaded_model_matches_jax_forward(jax_checkpoints, rng, norm):
    files, trees = jax_checkpoints
    jcfg, variables = trees[norm]
    path = files["params_meta_opt" if norm == "group" else "batchnorm_bundle"]
    tcfg = tunet.canonical_config(**SMALL, norm=norm)
    sd, meta = load_model_checkpoint(path, tcfg)
    assert meta == ({"epoch": 3, "val_loss": 0.25, "lr": 1e-3} if norm == "group" else {})
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    x = rng.standard_normal((2, 36, 40, 1)).astype(np.float32)
    jvars = variables if norm == "batch" else {"params": variables}
    ref = np.asarray(junet.UNet(jcfg).apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_bfloat16_checkpoint_converts_its_values(jax_checkpoints):
    files, trees = jax_checkpoints
    cfg, params = trees["group"]
    sd, _ = load_model_checkpoint(files["bfloat16"], tunet.canonical_config(**SMALL))
    kernel = np.asarray(params["down0"]["conv0"]["kernel"].astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(sd["down_blocks.0.0.0.weight"].numpy(), kernel.transpose(3, 2, 0, 1))


def test_torch_checkpoints_load_as_they_are(tmp_path):
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(3))
    ours = save_checkpoint(str(tmp_path / "ours.ckpt"), model.state_dict(), meta={"epoch": 1})
    reference = tmp_path / "reference.ckpt"
    torch.save({"state_dict": {f"_model.{k}": v for k, v in model.state_dict().items()},
                "epoch": 1}, str(reference))
    for path, meta in ((ours, {"epoch": 1}), (str(reference), {})):
        assert checkpoint_format(path) == "torch"
        sd, got_meta = load_model_checkpoint(path, model.cfg)
        assert got_meta == meta and list(sd) == list(model.state_dict())
        assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    other = tmp_path / "other.bin"
    other.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="other.bin"):
        load_model_checkpoint(str(other), model.cfg)
