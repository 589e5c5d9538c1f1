"""The U-Net model."""
