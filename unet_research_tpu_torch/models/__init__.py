"""The U-Net model."""

from unet_research_tpu_torch.models.unet import (
    DropBlockConfig,
    UNet,
    UNetConfig,
    as_variables,
    canonical_config,
    param_count,
    split_variables,
)

__all__ = ["DropBlockConfig", "UNet", "UNetConfig", "as_variables", "canonical_config",
           "param_count", "split_variables"]
