"""Image preprocessing for serving (counterpart of the JAX package's
data/imagenet.py ``resize_center_crop``; PIL only)."""
from __future__ import annotations


def resize_center_crop(img, size: int = 224, resize_to: int = 256):
    """Resize the short side to `resize_to`, then center-crop `size`."""
    from PIL import Image
    if size > resize_to:
        # PIL zero-pads out-of-bounds crops, so a crop bigger than the
        # resized short side would silently produce black borders: scale
        # the resize with the crop (torchvision's 256/224 ratio)
        resize_to = int(round(size * 256 / 224))
    W, H = img.size
    if W < H:
        nw, nh = resize_to, int(resize_to * H / W)
    else:
        nw, nh = int(resize_to * W / H), resize_to
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - size) // 2, (nh - size) // 2
    return img.crop((left, top, left + size, top + size))
