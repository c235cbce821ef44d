"""Image resizing and the EXIF orientation fix on a needle GET.

The JAX package's ``images/resizing.py`` (reference
weed/images/resizing.go and orientation.go): a GET of an image with
``width``/``height`` (and ``mode`` fit or fill) is answered resized, a
JPEG with its EXIF orientation baked into the pixels first (the
reference fixes it at write time; on read the bytes stored stay as
written). Pillow does the work; where Pillow is missing, both pass the
bytes through unchanged.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

try:
    from PIL import Image, ImageOps
    _HAVE_PIL = True
except ImportError:
    _HAVE_PIL = False

RESIZABLE = ("image/jpeg", "image/png", "image/gif", "image/webp")


def _format_of(mime: str) -> str:
    return {"image/jpeg": "JPEG", "image/png": "PNG",
            "image/gif": "GIF", "image/webp": "WEBP"}.get(mime, "PNG")


def fix_orientation(data: bytes, mime: str = "image/jpeg") -> bytes:
    """Bake the EXIF orientation into the pixels (reference
    FixJpgOrientation)."""
    if not _HAVE_PIL or mime != "image/jpeg":
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fixed = ImageOps.exif_transpose(img)
        if fixed is img:
            return data
        out = io.BytesIO()
        fixed.save(out, format="JPEG", quality=90)
        return out.getvalue()
    except Exception:        # noqa: BLE001 — never break a read
        return data


def resize_image(data: bytes, mime: str, width: int = 0, height: int = 0,
                 mode: str = "") -> Tuple[bytes, str]:
    """Resize per the reference's semantics (Resized,
    resizing.go:17-48): mode 'fit' preserves aspect ratio within the
    box (default when both dims given), 'fill' crops to fill the box
    exactly, one-dimension scales proportionally. Returns
    (bytes, mime); passthrough when not resizable."""
    if not _HAVE_PIL or mime not in RESIZABLE or (not width and
                                                  not height):
        return data, mime
    try:
        img = Image.open(io.BytesIO(data))
        w0, h0 = img.size
        if width and height:
            if mode == "fill":
                img = ImageOps.fit(img, (width, height))
            else:
                img.thumbnail((width, height))
        elif width:
            img = img.resize((width, max(1, h0 * width // w0)))
        else:
            img = img.resize((max(1, w0 * height // h0), height))
        out = io.BytesIO()
        save_kwargs = {"quality": 90} if mime == "image/jpeg" else {}
        if img.mode in ("P", "RGBA") and mime == "image/jpeg":
            img = img.convert("RGB")
        img.save(out, format=_format_of(mime), **save_kwargs)
        return out.getvalue(), mime
    except Exception:        # noqa: BLE001 — never break a read
        return data, mime
