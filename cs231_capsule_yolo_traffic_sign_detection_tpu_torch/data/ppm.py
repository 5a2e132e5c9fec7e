"""Binary PPM (P6) frames in numpy, without cv2.

GTSDB ships its test frames as P6 PPM (1360 x 800, maxval 255).  The
JAX package reads them with ``cv2.imread``; the card's machine has no
cv2, so the port parses the format itself and returns the frame as
cv2 does: uint8 (H, W, 3) in BGR order, which the rest of the port
(ops/preprocess.py, ops/crop.py) assumes.
"""

import numpy as np


def _header_tokens(data, n):
    """The first ``n`` whitespace-separated header tokens of a PPM and
    the offset just past the single whitespace byte after the last.
    ``#`` starts a comment that runs to the end of its line."""
    tokens, i = [], 0
    while len(tokens) < n:
        if i >= len(data):
            raise ValueError("PPM header ends early")
        c = data[i:i + 1]
        if c == b"#":
            while i < len(data) and data[i:i + 1] not in (b"\n", b"\r"):
                i += 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < len(data) and not data[j:j + 1].isspace() \
                    and data[j:j + 1] != b"#":
                j += 1
            tokens.append(data[i:j])
            i = j
    # exactly one whitespace byte separates maxval from the raster
    if i >= len(data) or not data[i:i + 1].isspace():
        raise ValueError("PPM header: no whitespace before the raster")
    return tokens, i + 1


def read_ppm(path):
    """uint8 (H, W, 3) BGR frame from a binary PPM (P6, maxval 255).

    Any other file (ASCII P3, a PGM, maxval above 255, a short raster)
    raises ValueError; nothing falls back."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P6":
        raise ValueError(f"{path}: not a binary PPM (P6), magic "
                         f"{data[:2]!r}")
    (_, w, h, maxval), off = _header_tokens(data, 4)
    try:
        w, h, maxval = int(w), int(h), int(maxval)
    except ValueError:
        raise ValueError(f"{path}: PPM header is not numeric") from None
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}; only 255 is read")
    n = w * h * 3
    if len(data) - off < n:
        raise ValueError(f"{path}: PPM raster holds {len(data) - off} "
                         f"bytes, {w}x{h} needs {n}")
    rgb = np.frombuffer(data, np.uint8, count=n, offset=off)
    return np.ascontiguousarray(rgb.reshape(h, w, 3)[..., ::-1])
