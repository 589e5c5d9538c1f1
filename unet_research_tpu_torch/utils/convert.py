"""JAX params and reference checkpoints -> the port's state_dict.

`jax_params_to_state_dict` inverts unet_research_tpu/utils/convert.py
(:49-137): the Flax tree's HWIO conv kernels become OIHW, the (kh, kw, in,
out) upconv kernel becomes ConvTranspose2d's (in, out, kh, kw) with no
spatial flip (torch's stamp orientation), GroupNorm/BatchNorm 'scale'/'bias'
become 'weight'/'bias', and BatchNorm 'batch_stats' mean/var become the
running statistics.
"""

from __future__ import annotations

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


def load_reference_checkpoint(path: str) -> dict:
    """The UNet state_dict of a reference PL .ckpt (or raw state dict file),
    keys stripped to the port's layout, on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    return {_strip(k): torch.as_tensor(v) for k, v in sd.items()}


def jax_params_to_state_dict(params: Mapping[str, Any], cfg) -> dict:
    """A JAX UNet param tree (or a {'params', 'batch_stats'} bundle) of
    numpy-convertible arrays -> the port's state_dict of float32 tensors."""
    bstats = {}
    if "params" in params:
        bstats = params.get("batch_stats") or {}
        params = params["params"]
    sd: dict = {}

    def t(a, perm=None):
        a = np.asarray(a, dtype=np.float32)
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
