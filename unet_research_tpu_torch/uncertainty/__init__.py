"""Uncertainty ensembles: MC-DropBlock and rotational test-time augmentation."""

from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine
from unet_research_tpu_torch.uncertainty.rotational import RotationalEngine

__all__ = ["MCDropBlockEngine", "RotationalEngine"]
