from . import fields, image_io, tfrecord_codec, transforms
from .coco import CocoDataset, decode_rle, segmentation_to_mask
from .loader import build_dataloader, pad_sample_to_batch_arrays, pick_bucket
from .records import TFRecordDataset, build_records, create_example
from .synthetic import SyntheticDataset, jittered_proposals, write_proposal_file

__all__ = ["fields", "image_io", "tfrecord_codec", "transforms", "CocoDataset", "decode_rle",
           "segmentation_to_mask", "build_dataloader", "pad_sample_to_batch_arrays",
           "pick_bucket", "TFRecordDataset", "build_records", "create_example",
           "SyntheticDataset", "jittered_proposals", "write_proposal_file"]
