"""Image operations on the read path (reference weed/images/)."""

from .resizing import fix_orientation, resize_image

__all__ = ["fix_orientation", "resize_image"]
