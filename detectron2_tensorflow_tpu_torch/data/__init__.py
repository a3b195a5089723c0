from . import fields, transforms
from .loader import build_dataloader, pad_sample_to_batch_arrays, pick_bucket
from .synthetic import SyntheticDataset

__all__ = ["fields", "transforms", "build_dataloader", "pad_sample_to_batch_arrays",
           "pick_bucket", "SyntheticDataset"]
