"""JAX params and checkpoints, reference checkpoints -> the port's state_dict.

`jax_params_to_state_dict` inverts unet_research_tpu/utils/convert.py
(:49-137): the Flax tree's HWIO conv kernels become OIHW, the (kh, kw, in,
out) upconv kernel becomes ConvTranspose2d's (in, out, kh, kw) with no
spatial flip (torch's stamp orientation), GroupNorm/BatchNorm 'scale'/'bias'
become 'weight'/'bias', and BatchNorm 'batch_stats' mean/var become the
running statistics.

The JAX package's checkpoints are flax msgpack files
(unet_research_tpu/train/checkpoint.py:28-46). `read_flax_msgpack` decodes
them in Python, without the msgpack library (the port depends on numpy,
torch and the standard library only). `load_model_checkpoint` reads any of
the three kinds of file a user holds: a JAX checkpoint, a reference PL
`.ckpt`, or the port's own. `main` converts a reference `.ckpt` into the
port's own checkpoint format.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Mapping

import numpy as np
import torch


def _strip(key: str) -> str:
    """Drop PL wrapper prefixes ('_model.', 'model.', nested) and wrapper
    '.module' segments from a reference checkpoint key."""
    stripped = True
    while stripped:
        stripped = False
        for prefix in ("_model.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                stripped = True
    return key.replace(".module.", ".").replace("module.", "")


def _read_torch_checkpoint(path: str):
    """(state_dict with stripped keys, meta) of a torch.save file: a
    reference PL .ckpt, a raw state dict, or the port's own checkpoint
    (whose 'meta' is returned; {} otherwise)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    meta = payload.get("meta", {}) if isinstance(payload, dict) and "state_dict" in payload else {}
    return {_strip(k): torch.as_tensor(v) for k, v in sd.items()}, meta


def load_reference_checkpoint(path: str) -> dict:
    """The UNet state_dict of a reference PL .ckpt (or raw state dict file),
    keys stripped to the port's layout, on the CPU."""
    return _read_torch_checkpoint(path)[0]


# --- flax msgpack -------------------------------------------------------------

# msgpack's fixed-width families: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
          0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8)}
# length-prefixed families: first byte -> (kind, bytes of the length)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4), 0xc7: ("ext", 1),
          0xc8: ("ext", 2), 0xc9: ("ext", 4), 0xd9: ("str", 1), 0xda: ("str", 2),
          0xdb: ("str", 4), 0xdc: ("array", 2), 0xdd: ("array", 4), 0xde: ("map", 2),
          0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CHUNKED = "__msgpack_chunked_array__"


class _Unpacker:
    """A msgpack decoder over one buffer. Strings decode as UTF-8 unless
    raw (then bytes), arrays become lists, and ext payloads go to `ext`."""

    def __init__(self, data, ext=None, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.ext = ext
        self.raw = raw

    def take(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.mapping(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _FIXEXT:
            code = struct.unpack(">b", self.take(1))[0]
            return self.extension(code, _FIXEXT[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")
        kind, size = _SIZED[b]
        n = self.length(size)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.string(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.mapping(n)
        code = struct.unpack(">b", self.take(1))[0]
        return self.extension(code, n)

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def extension(self, code: int, n: int):
        if self.ext is None:
            raise ValueError(f"msgpack: unexpected ext type {code}")
        return self.ext(code, self.take(n))


def _flax_array(payload):
    """flax's ndarray encoding (serialization.py::_ndarray_to_bytes): a
    msgpack (shape, dtype name, C-order bytes). bfloat16 -> torch.bfloat16,
    bit for bit (numpy has no bfloat16); every other dtype -> numpy."""
    shape, name, buf = _Unpacker(payload, raw=True).value()
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"flax array of dtype {name!r} is not supported") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _flax_ext(code: int, payload):
    if code == 1:  # ndarray
        return _flax_array(payload)
    if code == 3:  # numpy scalar, stored as a 0-d array
        return _flax_array(payload)[()]
    raise ValueError(f"flax msgpack ext type {code} is not supported")


def _unchunk(tree, key="<root>"):
    """Reassemble the leaves flax split into chunks (`_chunk`, arrays above
    its MAX_CHUNK_SIZE): {'__msgpack_chunked_array__', 'shape': {'0': ..},
    'chunks': {'0': flat part, ..}}."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        try:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        except KeyError:
            raise ValueError(f"malformed chunked array at {key!r}") from None
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts).reshape(shape)
        return np.concatenate(parts).reshape(shape)
    return {k: _unchunk(v, k) for k, v in tree.items()}


def read_flax_msgpack(path: str):
    """The tree of a flax msgpack file, as flax.serialization.msgpack_restore
    gives it: dicts, lists, Python scalars and strings, numpy arrays and
    scalars, bfloat16 leaves as torch.bfloat16 tensors."""
    with open(path, "rb") as f:
        data = f.read()
    unpacker = _Unpacker(data, ext=_flax_ext)
    tree = unpacker.value()
    if unpacker.pos != len(data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_jax_checkpoint(path: str, cfg):
    """(state_dict, meta) of a checkpoint the JAX package wrote
    (train/checkpoint.py::save_checkpoint): its params, or its
    {'params', 'batch_stats'} bundle, converted for a model of `cfg`."""
    payload = read_flax_msgpack(path)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path}: not a checkpoint of the JAX package (no 'params')")
    return jax_params_to_state_dict(payload["params"], cfg), json.loads(payload.get("meta_json", "{}"))


def checkpoint_format(path: str) -> str:
    """'torch' for a zip or pickle file (torch.save), 'msgpack' for a
    msgpack map (the JAX package), from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04" or head[:1] == b"\x80":
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch nor a flax msgpack checkpoint")


def load_model_checkpoint(path: str, cfg):
    """(state_dict, meta) for a model of `cfg` from a JAX msgpack checkpoint,
    a reference PL .ckpt or the port's own checkpoint, by the file's first
    bytes."""
    if checkpoint_format(path) == "msgpack":
        return load_jax_checkpoint(path, cfg)
    return _read_torch_checkpoint(path)


def jax_params_to_state_dict(params: Mapping[str, Any], cfg) -> dict:
    """A JAX UNet param tree (or a {'params', 'batch_stats'} bundle) of
    numpy-convertible arrays or torch tensors (read_flax_msgpack's bfloat16
    leaves) -> the port's state_dict of float32 tensors."""
    bstats = {}
    if "params" in params:
        bstats = params.get("batch_stats") or {}
        params = params["params"]
    sd: dict = {}

    def t(a, perm=None):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, dtype=np.float32)
        return torch.tensor(a if perm is None else a.transpose(perm))

    def at(tree, path: str):
        for part in path.split("/"):
            tree = None if tree is None else tree.get(part)
        return tree

    def conv(src: str, dst: str, perm=(3, 2, 0, 1)):
        node = at(params, src)
        if node is None:
            return
        sd[f"{dst}.weight"] = t(node["kernel"], perm)
        if "bias" in node:
            sd[f"{dst}.bias"] = t(node["bias"])

    def norm(src: str, dst: str):
        node = at(params, src)
        if node is None:
            return
        sd[f"{dst}.weight"] = t(node["scale"])
        sd[f"{dst}.bias"] = t(node["bias"])
        stats = at(bstats, src)
        if stats is not None:
            sd[f"{dst}.running_mean"] = t(stats["mean"])
            sd[f"{dst}.running_var"] = t(stats["var"])
            sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    n_convs = cfg.conv_layers_per_block
    for d in range(cfg.model_depth):
        for i in range(n_convs):
            conv(f"down{d}/conv{i}", f"down_blocks.{d}.0.{4 * i}")
            norm(f"down{d}/norm{i}", f"down_blocks.{d}.0.{4 * i + 1}")
        conv(f"pool{d}/pool_conv", f"down_blocks.{d}.1.0")
        norm(f"pool{d}/pool_norm", f"down_blocks.{d}.1.1")
    for i in range(n_convs):
        conv(f"conn/conv{i}", f"conn_block.{4 * i}")
        norm(f"conn/norm{i}", f"conn_block.{4 * i + 1}")
    for d in range(cfg.model_depth):
        if cfg.up_mode == "upconv":
            conv(f"up{d}/up_conv", f"up_blocks.{d}.0.0", perm=(2, 3, 0, 1))
            norm(f"up{d}/up_norm", f"up_blocks.{d}.0.1")
        else:
            conv(f"up{d}/up_conv", f"up_blocks.{d}.0.1")
            norm(f"up{d}/up_norm", f"up_blocks.{d}.0.2")
        for i in range(n_convs):
            conv(f"post{d}/conv{i}", f"up_blocks.{d}.1.{4 * i}")
            norm(f"post{d}/norm{i}", f"up_blocks.{d}.1.{4 * i + 1}")
    conv("head", "output_conv.0")
    return sd


def main(argv=None):
    """Convert a reference PL/torch .ckpt into a checkpoint of this port
    (train/checkpoint.py::save_checkpoint), with meta {"converted_from": SRC}.

    Usage:
      python -m unet_research_tpu_torch.utils.convert SRC.ckpt DST.ckpt \
          [-filters 64] [-model_depth 4] [-group_norm_groups 32] \
          [-norm group|batch|none] [-activation relu|...]

    The arch flags must describe the reference model the checkpoint was
    trained with (the reference hardcodes the canonical 31M config,
    base_model_tests/training.py:171-192: the defaults here). The weights
    are loaded strictly into a UNet of that configuration on the CPU, so a
    file of another model raises; BatchNorm running statistics are kept."""
    import argparse

    from unet_research_tpu_torch.models.unet import DropBlockConfig, UNet, canonical_config
    from unet_research_tpu_torch.train.checkpoint import save_checkpoint

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("-filters", type=int, default=64)
    p.add_argument("-model_depth", type=int, default=4)
    p.add_argument("-group_norm_groups", type=int, default=32)
    p.add_argument("-norm", default="group")
    p.add_argument("-activation", default="relu")
    a = p.parse_args(argv)
    cfg = canonical_config(
        filters=a.filters, model_depth=a.model_depth, group_norm_groups=a.group_norm_groups,
        norm=None if a.norm == "none" else a.norm, activation=a.activation,
        dropblock=DropBlockConfig(kind="dependent"))
    model = UNet(cfg, device="cpu")
    model.load_state_dict(load_reference_checkpoint(a.src))
    save_checkpoint(a.dst, model.state_dict(), meta={"converted_from": a.src})
    n = sum(t.numel() for t in model.parameters())
    print(f"converted {a.src} -> {a.dst} ({n:,} params)")
    return a.dst


if __name__ == "__main__":
    main()
