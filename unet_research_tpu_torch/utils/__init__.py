"""General helpers, parameter and checkpoint conversion, the image-file
readers and writers. JAX's `to_pil` has no twin (the port does not depend
on PIL): `utils.general.to_u8` gives its pixels."""

from unet_research_tpu_torch.utils.general import create_dir, seed_everything, to_u8

__all__ = ["create_dir", "seed_everything", "to_u8"]
