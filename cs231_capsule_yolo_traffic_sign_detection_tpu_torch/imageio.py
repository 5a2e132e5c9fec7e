"""PNG files from numpy and zlib, without cv2 or an imaging library.

`write_png` stores a uint8 (H, W, 3) BGR frame (cv2's channel order,
the port's everywhere) as an 8-bit RGB PNG: no interlace, every row
with filter type 0, one IDAT chunk, CRCs from ``zlib.crc32``.  The JAX
package writes ``cv2.imwrite`` JPEGs; the port writes lossless PNGs
(README, the port's COMPAT notes).
"""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path, image_bgr):
    """A uint8 (H, W, 3) BGR frame to ``path`` as PNG."""
    img = np.asarray(image_bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: need uint8 (H, W, 3), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0                                   # filter type 0
    rows[:, 1:] = img[..., ::-1].reshape(h, 3 * w)   # BGR -> RGB
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))
