"""Data: the split reader, the in-memory split and the host -> device batch
feed."""

from unet_research_tpu_torch.data.dataset import ArrayDataset, load_split
from unet_research_tpu_torch.data.loading import batch_iterator

__all__ = ["ArrayDataset", "batch_iterator", "load_split"]
