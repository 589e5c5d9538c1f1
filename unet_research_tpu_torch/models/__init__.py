"""The port's models: the study's configurable U-Net, TransUNet (R50-ViT-B/16)
and Swin UNETR, all on the mask-site machinery of models/sites.py, and
`build_model`, which builds each from its configuration."""

from unet_research_tpu_torch.models.swin_unetr import SwinUNETR, SwinUNETRConfig
from unet_research_tpu_torch.models.transunet import TransUNet, TransUNetConfig
from unet_research_tpu_torch.models.unet import (
    DropBlockConfig,
    UNet,
    UNetConfig,
    as_variables,
    canonical_config,
    param_count,
    split_variables,
)

ARCHS = ("unet", "transunet_r50_b16", "swin_unetr")


def build_model(cfg, device=None, generator=None):
    """The model of a configuration: a UNet of a UNetConfig, a TransUNet of a
    TransUNetConfig, a SwinUNETR of a SwinUNETRConfig, on `device`, seeded
    from `generator` if given."""
    if isinstance(cfg, TransUNetConfig):
        return TransUNet(cfg, device=device, generator=generator)
    if isinstance(cfg, SwinUNETRConfig):
        return SwinUNETR(cfg, device=device, generator=generator)
    if isinstance(cfg, UNetConfig):
        return UNet(cfg, device=device, generator=generator)
    raise TypeError(f"no model for a {type(cfg).__name__}")


__all__ = ["ARCHS", "DropBlockConfig", "SwinUNETR", "SwinUNETRConfig", "TransUNet",
           "TransUNetConfig", "UNet", "UNetConfig", "as_variables", "build_model",
           "canonical_config", "param_count", "split_variables"]
