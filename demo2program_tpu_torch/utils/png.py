"""A small PNG writer and reader, on zlib and struct only.

The trainer's image summaries are PNGs, and the GPU machine has no cv2, so
the port writes them itself: 8-bit gray (an (h, w) uint8 array, colour type
0) or RGB ((h, w, 3), colour type 2), every row unfiltered, one zlib
stream. `read_png` reads back what `write_png` writes (and any 8-bit gray or
RGB PNG whose rows are unfiltered): tests and tools check images with it.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {2: 0, 3: 2}  # array rank -> PNG colour type (gray, RGB)


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(image):
    """(h, w) or (h, w, 3) uint8 array -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {image.dtype}")
    if image.ndim not in _COLOR_TYPE or (image.ndim == 3
                                         and image.shape[2] != 3):
        raise ValueError(f"expected (h, w) gray or (h, w, 3) RGB, got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[image.ndim], 0, 0,
                         0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path, image):
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path):
    """-> (h, w) or (h, w, 3) uint8 array of an 8-bit gray or RGB PNG with
    unfiltered rows. Raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = len(_SIGNATURE), b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    pixels = raw[:, 1:].reshape(h, w, channels)
    return pixels[:, :, 0] if channels == 1 else pixels
