"""Box drawing on host frames, in numpy (counterpart of the JAX viz.py,
which draws with cv2; the card's machine has no cv2).

`draw_boxes` draws each box as ``cv2.rectangle(img, p1, p2, color, 1)``
does: the four 1 px edges between the integer corners (``int()`` of
each coordinate), both ends included, clipped to the frame.  The class
name goes at the box centre, as the JAX package puts ``cv2.putText``'s
origin there, but in the port's own 5x7 bitmap font (`FONT`): cv2's
Hershey strokes cannot be reproduced without cv2, so the label pixels
differ from the JAX package's (README, the port's COMPAT notes).  The
crops are the frame's slices under each box, clipped to the frame as
JAX clips them (viz.py:44-51).
"""

import os

import numpy as np

from . import config

# 5x7 glyphs, one hex byte per row (bit 4 = leftmost column); lower
# case is drawn as upper case and any other character as "?"
FONT = {
    "0": "0E11131519110E", "1": "040C040404040E", "2": "0E11010204081F",
    "3": "1F02040201110E", "4": "02060A121F0202", "5": "1F101E0101110E",
    "6": "0608101E11110E", "7": "1F010204080808", "8": "0E11110E11110E",
    "9": "0E11110F01020C", "A": "0E1111111F1111", "B": "1E11111E11111E",
    "C": "0E11101010110E", "D": "1C12111111121C", "E": "1F10101E10101F",
    "F": "1F10101E101010", "G": "0E11101711110F", "H": "1111111F111111",
    "I": "0E04040404040E", "J": "0702020202120C", "K": "11121418141211",
    "L": "1010101010101F", "M": "111B1515111111", "N": "11111915131111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D",
    "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404040404",
    "U": "1111111111110E", "V": "11111111110A04", "W": "1111111515150A",
    "X": "11110A040A1111", "Y": "1111110A040404", "Z": "1F01020408101F",
    " ": "00000000000000", "-": "0000001F000000", ".": "00000000000C0C",
    "(": "02040808080402", ")": "08040202020408", "/": "00010204081000",
    "?": "0E110102040004", ":": "000C0C000C0C00", ",": "000000000C0408",
    "'": "0C040800000000",
}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def _glyph(ch):
    """(7, 5) bool mask of one character."""
    rows = np.frombuffer(bytes.fromhex(FONT.get(ch.upper(), FONT["?"])),
                         np.uint8)
    return (rows[:, None] >> np.arange(GLYPH_W - 1, -1, -1)) & 1 > 0


def class_names(path=None):
    """GTSDB class names, one a line in ``<GTSDB>/class_names.txt`` when
    it exists, else "0".."42" (JAX viz.py:18-30)."""
    path = path or config.GTSDB + "/class_names.txt"
    if os.path.exists(path):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [str(i) for i in range(43)]


def _paint(img, ys, xs, color):
    """Set the pixels (ys, xs) that lie inside ``img`` to ``color``."""
    h, w = img.shape[:2]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[inside], xs[inside]] = color


def draw_rectangle(img, p1, p2, color):
    """cv2.rectangle(img, p1, p2, color, 1) in place: the edges at
    x1, x2, y1 and y2 between the integer corners, ends included."""
    (x1, y1), (x2, y2) = p1, p2
    xs = np.arange(min(x1, x2), max(x1, x2) + 1)
    ys = np.arange(min(y1, y2), max(y1, y2) + 1)
    for y in (y1, y2):
        _paint(img, np.full(xs.shape, y), xs, color)
    for x in (x1, x2):
        _paint(img, ys, np.full(ys.shape, x), color)


def draw_text(img, text, org, color):
    """``text`` in the 5x7 font in place, its bottom-left at ``org``
    (cv2.putText's origin), one column between glyphs."""
    x0, y0 = org
    for k, ch in enumerate(text):
        gy, gx = np.nonzero(_glyph(ch))
        _paint(img, y0 - (GLYPH_H - 1) + gy, x0 + k * ADVANCE + gx, color)


def draw_boxes(image, xy, classes=None, color=(0, 255, 0), names=None):
    """One frame: (annotated copy, list of crops), JAX viz.draw_boxes.

    ``xy`` (n, 4) corner boxes in the frame's pixels; with ``classes``
    each box's class name (``names``, else `class_names`) is drawn at
    its centre."""
    new_img = image.copy()
    h, w = image.shape[:2]
    crops = [image[max(int(y1), 0):max(min(int(y2), h), 0),
                   max(int(x1), 0):max(min(int(x2), w), 0)]
             for x1, y1, x2, y2 in xy]
    if classes is not None and names is None:
        names = class_names()
    for i in range(xy.shape[0]):
        x1, y1, x2, y2 = xy[i].astype(int)
        draw_rectangle(new_img, (x1, y1), (x2, y2), color)
        if classes is not None:
            draw_text(new_img, str(names[int(classes[i])]),
                      ((x1 + x2) // 2, (y1 + y2) // 2), color)
    return new_img, crops


def draw_boxes_vec(images, image_indices, xy, classes=None,
                   color=(0, 255, 0)):
    """A batch of frames: (annotated copies, crops per frame), JAX
    viz.draw_boxes_vec.  Predictions are drawn green, ground truth red
    (``color=(0, 0, 255)``, BGR) by the callers."""
    names = class_names() if classes is not None else None
    new_images, crops_bch = [], []
    for i in range(len(images)):
        mask = image_indices == i
        new_img, crops = draw_boxes(
            images[i], xy[mask], None if classes is None else classes[mask],
            color=color, names=names)
        new_images.append(new_img)
        crops_bch.append(crops)
    return new_images, crops_bch
