"""Uncertainty ensembles: the streaming merge, MC-DropBlock and rotational
test-time augmentation."""

from unet_research_tpu_torch.uncertainty.ensemble import (
    streaming_ensemble,
    streaming_ensemble_batched,
)
from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine
from unet_research_tpu_torch.uncertainty.rotational import RotationalEngine

__all__ = ["MCDropBlockEngine", "RotationalEngine", "streaming_ensemble",
           "streaming_ensemble_batched"]
