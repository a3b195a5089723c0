from . import boxes
from .image_list import ImageList
from .instances import Instances
from .masks import paste_masks_in_image

__all__ = ["boxes", "ImageList", "Instances", "paste_masks_in_image"]
