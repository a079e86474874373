"""PNG read/write (host-side, numpy + the standard library's zlib;
replaces the reference's cv2 loop loader at Texture.py:18-34 which
converted pixels one-by-one in Python).

The codec covers what the renderer needs: reading 8-bit, non-interlaced
greyscale, RGB and RGBA files (every vendored asset is one) and writing
8-bit RGB.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples/pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (spec section 9).  Sub, Average
    and Paeth depend on the reconstructed left neighbour, so they run
    byte by byte; None and Up are whole-row operations."""
    out = bytearray(h * stride)
    prev = bytearray(stride)
    for y in range(h):
        base = y * (stride + 1)
        ftype = raw[base]
        cur = bytearray(raw[base + 1:base + 1 + stride])
        if ftype == 2:
            cur = bytearray(((np.frombuffer(cur, np.uint8).astype(np.uint16)
                              + np.frombuffer(prev, np.uint8)) & 0xFF)
                            .astype(np.uint8).tobytes())
        elif ftype == 1:
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 3:
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            for i in range(stride):
                b = prev[i]
                if i >= bpp:
                    a, c = cur[i - bpp], prev[i - bpp]
                else:
                    a = c = 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y * stride:(y + 1) * stride] = cur
        prev = cur
    return np.frombuffer(bytes(out), np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 array (H, W, C) with C in {1, 2, 3, 4}."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    ihdr, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (depth {depth}, colour type {color}, "
            f"interlace {interlace}): only 8-bit non-interlaced "
            "grey/RGB/RGBA")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> PNG bytes (filter 0 on every scanline)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    assert ch == 3, img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1)

    def chunk(ctype, body):
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """Load a PNG as float32 RGB in [0,1], shape (H, W, 3), row 0 = top."""
    with open(path, "rb") as f:
        px = decode_png(f.read())
    if px.shape[2] <= 2:  # grey (+ alpha)
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.float32) / 255.0


def write_png(path: str, img: np.ndarray) -> None:
    """Save a float [0,1] RGB array (H, W, 3), row 0 = top, to PNG."""
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    with open(path, "wb") as f:
        f.write(encode_png((arr * 255.0 + 0.5).astype(np.uint8)))


def film_to_image(film_xy: np.ndarray) -> np.ndarray:
    """Convert the renderer's film layout (W, H, 3) indexed [x, y] with
    y=0 at the bottom (the reference's Taichi GUI convention,
    Example.py:44) into a standard top-row-first (H, W, 3) image."""
    return np.transpose(np.asarray(film_xy), (1, 0, 2))[::-1]


def image_to_film(img: np.ndarray) -> np.ndarray:
    """Inverse of film_to_image."""
    return np.transpose(np.asarray(img)[::-1], (1, 0, 2))
