"""Data: the in-memory split and the host -> device batch feed."""

from unet_research_tpu_torch.data.dataset import ArrayDataset
from unet_research_tpu_torch.data.loading import batch_iterator

__all__ = ["ArrayDataset", "batch_iterator"]
