"""Image I/O: LDR (via PIL) and Radiance HDR (pure numpy), PNG/HDR writers.

Port of `pathtracer_tpu/utils/image_io.py`, kept as the port's own copy so
that the port imports nothing of the JAX package.

Replaces the reference's vendored stb_image/stb_image_write
(reference: src/image.cpp:22-79, src/stb.cpp).  Matches the reference's load
conventions:
- images are float32 RGB in [0, inf)
- LDR images are loaded with gamma 1.0 by default (the reference calls
  stbi_ldr_to_hdr_gamma(gamma) with gamma defaulting to 1.f,
  reference: src/scene.h:60, src/image.cpp:22-38) — i.e. NO sRGB→linear
  conversion, just /255
- textures are flipped vertically at load
  (stbi_set_flip_vertically_on_load(true), reference: src/scene.cpp:56)

Unlike the JAX package's copy, it decodes 8-bit non-interlaced PNGs itself
(numpy and zlib; PIL only for other files), so that textures load where PIL
is not installed, with the same values as PIL's decode.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def load_image(path: str | Path, gamma: float = 1.0, flip_vertical: bool = True) -> np.ndarray:
    """Load any supported image as float32 (H, W, 3)."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        img = read_hdr(path)
    else:
        arr = read_png(path) if path.suffix.lower() == ".png" else _read_with_pil(path)
        if gamma != 1.0:
            arr = np.power(arr, gamma)
        img = arr
    if flip_vertical:
        img = img[::-1].copy()
    return np.ascontiguousarray(img, dtype=np.float32)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE) reader/writer


def read_hdr(path: str | Path) -> np.ndarray:
    """Decode a Radiance RGBE file (the format of scenes/env/*.hdr)."""
    data = Path(path).read_bytes()
    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line, e.g. "-Y 1024 +X 2048"
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and buf[bp] == 2
            and buf[bp + 1] == 2
            and ((int(buf[bp + 2]) << 8) | int(buf[bp + 3])) == width
        ):
            # adaptive RLE: 4 channel-planes per scanline
            bp += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bp])
                    bp += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[bp]
                        bp += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[bp : bp + count]
                        bp += count
                        x += count
        else:
            # flat scanline (possibly old-style RLE, rare; handle flat only)
            row = buf[bp : bp + width * 4].reshape(width, 4)
            rgbe[y] = row
            bp += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    # RGBE convention: v = (mantissa + 0.5?) — stb uses c * 2^(e-136) without
    # the +0.5 bias (matches stbi_loadf output for .hdr)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def write_hdr(path: str | Path, img: np.ndarray) -> None:
    """Write float32 (H, W, 3) as uncompressed Radiance RGBE."""
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    with np.errstate(divide="ignore"):
        exp = np.where(maxc > 1e-32, np.floor(np.log2(maxc)) + 1, 0).astype(np.int32)
    scale = np.where(maxc > 1e-32, np.ldexp(1.0, -exp) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    Path(path).write_bytes(header + rgbe.tobytes())


# ---------------------------------------------------------------------------
# PNG writer (pure numpy + zlib; mirrors image::savePNG clamping,
# reference: src/image.cpp:56-73)


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write (H, W, 3) float in [0,1] (or uint8) as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def _read_with_pil(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _unfilter_sequential(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """PNG filters 3 (average) and 4 (Paeth), whose bytes depend on the
    decoded bytes to their left: one byte at a time."""
    cur = [0] * len(line)
    ln, up = line.tolist(), prev.tolist()
    for i in range(len(ln)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (ln[i] + pred) & 255
    return np.asarray(cur, np.uint8)


def _decode_png(data: bytes) -> np.ndarray | None:
    """(H, W, 3) uint8 of an 8-bit, non-interlaced PNG (grey, RGB, palette,
    with or without alpha, which is dropped, as PIL's convert("RGB") does);
    None for any other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, hdr, plte = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        return None
    w, h, depth, ctype, _, _, interlace = hdr
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if depth != 8 or interlace or bpp is None or (ctype == 3 and plte is None):
        return None
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (stride + 1)]
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = _unfilter_sequential(kind, line, prev, bpp)
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    px = out.reshape(h, w, bpp)
    if ctype == 3:
        return plte[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., 0:1], 3, axis=-1)
    return np.ascontiguousarray(px[..., 0:3])


def read_png(path: str | Path) -> np.ndarray:
    """Read a PNG as float32 (H, W, 3) in [0,1] (PIL for a PNG that
    `_decode_png` does not take)."""
    rgb = _decode_png(Path(path).read_bytes())
    if rgb is None:
        return _read_with_pil(path)
    return rgb.astype(np.float32) / 255.0
