"""Data: the DRIVE reader, the augmentation generator, the split reader,
the in-memory split and the host -> device batch feed."""

from unet_research_tpu_torch.data.augment import (create_augmentations, gen_givens,
                                                  gen_givens_resized, gen_tests)
from unet_research_tpu_torch.data.dataset import ArrayDataset, load_split
from unet_research_tpu_torch.data.drive import DriveImages, load_drive
from unet_research_tpu_torch.data.loading import batch_iterator, shard_batch

__all__ = ["ArrayDataset", "DriveImages", "batch_iterator", "create_augmentations",
           "gen_givens", "gen_givens_resized", "gen_tests", "load_drive", "load_split",
           "shard_batch"]
