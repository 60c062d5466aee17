"""Image I/O (port of ``ngp_tpu/data/image_io.py``, numpy and zlib only):
EXR (a minimal single-part scanline codec: NONE / ZIPS / ZIP compression,
HALF / FLOAT / UINT channels), LDR through PIL (imported where used), and
the fp16 ``.bin`` format (ref: Testbed::load_binary_image,
src/testbed_image.cu:416-434 — int32 height, int32 width, then h*w*4
float16 RGBA).

LDR semantics mirror load_stbi (ref: common_device.cu:39-80 +
testbed_image.cu:400): sRGB → linear, alpha premultiplied in linear space.
"""
from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from ngp_tpu_torch.common import linear_to_srgb_np, srgb_to_linear_np

_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXELTYPE_INV = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
                  np.dtype(np.float32): 2}


# --------------------------------------------------------------------------
# EXR
# --------------------------------------------------------------------------

def _read_attrs(data: bytes, off: int):
    attrs = {}
    while True:
        end = data.index(b"\0", off)
        name = data[off:end].decode()
        off = end + 1
        if name == "":
            break
        end = data.index(b"\0", off)
        typ = data[off:end].decode()
        off = end + 1
        size = struct.unpack_from("<I", data, off)[0]
        off += 4
        attrs[name] = (typ, data[off:off + size])
        off += size
    return attrs, off


def _unzip_exr(block: bytes, expected: int) -> bytes:
    raw = zlib.decompress(block)
    # un-delta (OpenEXR ImfZip predictor), then un-interleave
    a = np.frombuffer(raw, np.uint8).astype(np.int64)
    a[1:] -= 128
    a = np.cumsum(a).astype(np.uint8)
    # un-interleave: first half = even output bytes, second half = odd
    n = len(a)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = a[:half]
    out[1::2] = a[half:]
    return out.tobytes()


def _zip_exr(raw: bytes) -> bytes:
    a = np.frombuffer(raw, np.uint8)
    n = len(a)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = a[0::2]
    inter[half:] = a[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16) + 128
    return zlib.compress(d.astype(np.uint8).tobytes(), 6)


def load_exr(path: str | Path) -> np.ndarray:
    """Read an EXR to float32 (H, W, C). Channels sorted as RGBA when the
    file has R/G/B(/A); otherwise alphabetical order."""
    data = Path(path).read_bytes()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    attrs, off = _read_attrs(data, 8)

    # channels
    chl = attrs["channels"][1]
    channels = []  # (name, dtype)
    o = 0
    while chl[o] != 0:
        e = chl.index(b"\0", o)
        cname = chl[o:e].decode()
        o = e + 1
        ptype = struct.unpack_from("<i", chl, o)[0]
        o += 16
        channels.append((cname, np.dtype(_PIXELTYPE[ptype])))
    comp = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = {0: 1, 2: 1, 3: 16}.get(comp)
    if lines_per_block is None:
        raise ValueError(f"unsupported EXR compression {comp}")

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, off)

    bytes_per_pixel = sum(d.itemsize for _, d in channels)
    planes = {name: np.empty((H, W), dt) for name, dt in channels}
    for boff in offsets:
        y, size = struct.unpack_from("<iI", data, boff)
        y -= ymin
        nlines = min(lines_per_block, H - y)
        raw_size = nlines * W * bytes_per_pixel
        block = data[boff + 8: boff + 8 + size]
        if comp == 0 or size >= raw_size:
            raw = block[:raw_size]
        else:
            raw = _unzip_exr(block, raw_size)
        ro = 0
        for line in range(nlines):
            for name, dt in channels:  # header order = alphabetical
                cnt = W * dt.itemsize
                planes[name][y + line] = np.frombuffer(raw, dt, W, ro)
                ro += cnt

    names = [c[0] for c in channels]
    if set("RGB").issubset(names):
        order = [n for n in ["R", "G", "B", "A"] if n in names]
        order += [n for n in names if n not in order]
    else:
        order = names
    img = np.stack([planes[n].astype(np.float32) for n in order], axis=-1)
    return img


def save_exr(path: str | Path, img: np.ndarray, dtype=np.float16):
    """Write (H, W, C) float array as a ZIP-compressed scanline EXR."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = ["R", "G", "B", "A"][:C] if C <= 4 else [f"C{i}" for i in range(C)]
    chan_sorted = sorted(zip(names, range(C)))
    dt = np.dtype(dtype)
    ptype = _PIXELTYPE_INV[dt]

    def attr(name, typ, payload):
        return name.encode() + b"\0" + typ.encode() + b"\0" + \
            struct.pack("<I", len(payload)) + payload

    chl = b""
    for n, _ in chan_sorted:
        chl += n.encode() + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
    chl += b"\0"
    header = b"\x76\x2f\x31\x01" + struct.pack("<I", 2)
    header += attr("channels", "chlist", chl)
    header += attr("compression", "compression", bytes([3]))  # ZIP
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", bytes([0]))
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_block = 16
    n_blocks = (H + lines_per_block - 1) // lines_per_block
    chunks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        nlines = min(lines_per_block, H - y0)
        rows = []
        for line in range(nlines):
            for n, ci in chan_sorted:
                rows.append(np.ascontiguousarray(
                    img[y0 + line, :, ci].astype(dt)).tobytes())
        raw = b"".join(rows)
        comp = _zip_exr(raw)
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<iI", y0, len(comp)) + comp)

    table_start = len(header) + 8 * n_blocks
    offsets, acc = [], table_start
    for c in chunks:
        offsets.append(acc)
        acc += len(c)
    out = header + struct.pack(f"<{n_blocks}Q", *offsets) + b"".join(chunks)
    Path(path).write_bytes(out)


# --------------------------------------------------------------------------
# LDR via PIL + .bin
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _srgb_lut() -> np.ndarray:
    """256-entry sRGB→linear LUT — exact for 8-bit sources and ~10×
    faster than evaluating the transfer curve per pixel. Read-only: the
    one array is shared by every caller."""
    lut = srgb_to_linear_np(
        np.arange(256, dtype=np.float32) / 255.0).astype(np.float32)
    lut.flags.writeable = False
    return lut


def u8_to_linear_rgba(u8: np.ndarray) -> np.ndarray:
    """sRGB uint8 RGBA (..., 4) → linear float32 premultiplied RGBA —
    the exact conversion load_stbi applies, factored out so lazy image
    views reproduce the eager path bit for bit."""
    rgb = _srgb_lut()[u8[..., :3]]
    a = u8[..., 3:4].astype(np.float32) / 255.0
    return np.concatenate([rgb * a, a], axis=-1)


def load_stbi(path: str | Path, premultiply: bool = True,
              return_u8: bool = False):
    """Load an LDR image → linear float32 RGBA (H, W, 4).
    sRGB → linear (via LUT); alpha premultiplied in linear space (ref:
    common_device.cu load_stbi + testbed_image.cu:400).
    ``return_u8`` additionally returns the raw sRGB uint8 RGBA — callers
    can ship that to the device (4× smaller) and convert per-sample."""
    from PIL import Image
    with Image.open(path) as im:
        u8 = np.asarray(im.convert("RGBA"), np.uint8)
    rgb = _srgb_lut()[u8[..., :3]]
    a = u8[..., 3:4].astype(np.float32) / 255.0
    if premultiply:
        rgb = rgb * a
    out = np.concatenate([rgb, a], axis=-1)
    return (out, u8) if return_u8 else out


def save_stbi(path: str | Path, img: np.ndarray, from_linear: bool = True):
    from PIL import Image
    img = np.asarray(img, np.float32)
    if from_linear:
        rgb = linear_to_srgb_np(np.clip(img[..., :3], 0.0, 1.0))
        img = np.concatenate([rgb, img[..., 3:]], -1) if img.shape[-1] == 4 else rgb
    arr = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_binary_image(path: str | Path) -> np.ndarray:
    """.bin fp16 image: int32 h, int32 w, then h*w*4 float16 RGBA."""
    raw = Path(path).read_bytes()
    h, w = struct.unpack_from("<2i", raw, 0)
    img = np.frombuffer(raw, np.float16, h * w * 4, 8).reshape(h, w, 4)
    return img.astype(np.float32)


def save_binary_image(path: str | Path, img: np.ndarray):
    img = np.asarray(img)
    h, w = img.shape[:2]
    if img.shape[-1] != 4:
        pad = np.ones((h, w, 4 - img.shape[-1]), img.dtype)
        img = np.concatenate([img, pad], -1)
    Path(path).write_bytes(struct.pack("<2i", h, w) +
                           img.astype(np.float16).tobytes())


def read_image(path: str | Path) -> np.ndarray:
    """Dispatch by extension, always returning linear float32."""
    p = Path(path)
    ext = p.suffix.lower()
    if ext == ".exr":
        return load_exr(p)
    if ext == ".bin":
        return load_binary_image(p)
    return load_stbi(p)
