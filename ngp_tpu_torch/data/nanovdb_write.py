"""NanoVDB (.nvdb) export — spec-conformant v32.3 FloatGrid writer (port
of ``ngp_tpu/data/nanovdb_write.py``, numpy only).

Builds the full Grid→Tree→Root→Upper(32³)→Lower(16³)→Leaf(8³) buffer with
the exact struct layouts of the NanoVDB 32.3 ABI (the version the reference
vendors, dependencies/nanovdb/nanovdb/NanoVDB.h: GridData :2184, TreeData
:2500, RootData+Tile :2686, InternalData :3042, LeafData :3354) and the
file header/metadata the reference's loader consumes
(ref: src/testbed_volume.cu:526-552, NanoVDBFileHeader/NanoVDBMetaData).

This is the write-side counterpart of ``nanovdb.py``. The JAX package's
copy is pinned to the real ABI by ``tests/test_nanovdb_real.py`` (a C++
check against the reference's own vendored header); this one writes the
same bytes (``tests/test_torch_volume.py``).

Gives the framework a real volume-export path: a trained/imported density
volume saved as .nvdb is consumable by OpenVDB/NanoVDB tooling and by the
reference itself.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ngp_tpu_torch.data.nanovdb import NANOVDB_MAGIC

VERSION = (32 << 21) | (3 << 10) | 3

GRID_TYPE_FLOAT = 1
GRID_CLASS_FOG = 2
# HasBBox | HasMinMax | HasAverage | HasStdDeviation | IsBreadthFirst
GRID_FLAGS = 2 | 4 | 8 | 16 | 32

GRID_DATA_SIZE = 672
TREE_DATA_SIZE = 64
ROOT_DATA_SIZE = 64          # BBox(24)+tableSize(4)+bg/min/max/avg/dev(20)→64
ROOT_TILE_SIZE = 32          # key(8)+child(8)+state(4)+value(4)→32
UPPER_SIZE = 8256 + (1 << 15) * 8    # bbox+flags(32)+masks(8192)+stats→8256
LOWER_SIZE = 1088 + (1 << 12) * 8    # bbox+flags(32)+masks(1024)+stats→1088
LEAF_SIZE = 96 + 512 * 4             # bboxMin/dif/flags(16)+mask(64)+stats(16)


def _mask_bytes(bits: np.ndarray) -> bytes:
    """Bit mask in NanoVDB order: word w bit b ↔ linear offset w*64+b
    (Mask<LOG2DIM> stores uint64 words little-endian)."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _leaf_offset(x, y, z):
    return ((x & 7) << 6) | ((y & 7) << 3) | (z & 7)


def write_nvdb(dense: np.ndarray, path, *, voxel_size: float = 1.0,
               origin=(0, 0, 0), name: str = "density",
               grid_class: int = GRID_CLASS_FOG,
               background: float = 0.0) -> None:
    """Write a dense (X, Y, Z) float32 array as a single-FloatGrid .nvdb.

    ``origin`` is the index-space coordinate of dense[0,0,0]. Voxels equal
    to ``background`` are inactive; 8³ blocks that are entirely background
    get no leaf (the accessor returns the background there).
    """
    dense = np.asarray(dense, np.float32)
    if dense.ndim != 3:
        raise ValueError("dense must be (X, Y, Z)")
    org = np.asarray(origin, np.int64)
    if np.any(org < 0) or np.any(org + dense.shape > 4096):
        # one root-key region (coords 0..4095) keeps the root table tiny;
        # plenty for every volume the pipeline produces
        raise ValueError("index bbox must lie in [0, 4096)³")

    active = dense != background
    if not active.any():
        raise ValueError("empty volume")
    ax, ay, az = np.nonzero(active)
    bbox_min = org + [ax.min(), ay.min(), az.min()]
    bbox_max = org + [ax.max(), ay.max(), az.max()]          # INCLUSIVE
    voxel_count = int(active.sum())
    vmin = float(dense[active].min())
    vmax = float(dense[active].max())
    vavg = float(dense[active].mean())
    vdev = float(dense[active].std())

    # ---- collect leaves (key: global leaf origin) --------------------
    leaves = {}                                              # org → (vals, mask)
    lx0, lx1 = int(bbox_min[0]) >> 3, int(bbox_max[0]) >> 3
    ly0, ly1 = int(bbox_min[1]) >> 3, int(bbox_max[1]) >> 3
    lz0, lz1 = int(bbox_min[2]) >> 3, int(bbox_max[2]) >> 3
    X, Y, Z = dense.shape
    for lx in range(lx0, lx1 + 1):
        for ly in range(ly0, ly1 + 1):
            for lz in range(lz0, lz1 + 1):
                g0 = np.array([lx << 3, ly << 3, lz << 3])
                i0 = g0 - org                                # into dense
                s = [slice(max(i0[d], 0), min(i0[d] + 8, dense.shape[d]))
                     for d in range(3)]
                sub = dense[s[0], s[1], s[2]]
                if not (sub != background).any():
                    continue
                vals = np.full((8, 8, 8), background, np.float32)
                d0 = [max(-i0[d], 0) for d in range(3)]
                vals[d0[0]:d0[0] + sub.shape[0],
                     d0[1]:d0[1] + sub.shape[1],
                     d0[2]:d0[2] + sub.shape[2]] = sub
                leaves[tuple(g0)] = vals

    # ---- group into lowers (128³) and uppers (4096³) -----------------
    lowers = {}                                              # org → [leaf orgs]
    for lo in sorted(leaves):
        k = (lo[0] & ~127, lo[1] & ~127, lo[2] & ~127)
        lowers.setdefault(k, []).append(lo)
    uppers = {}
    for lo in sorted(lowers):
        k = (lo[0] & ~4095, lo[1] & ~4095, lo[2] & ~4095)
        uppers.setdefault(k, []).append(lo)

    n_leaf, n_lower, n_upper = len(leaves), len(lowers), len(uppers)
    leaf_list = sorted(leaves)
    lower_list = sorted(lowers)
    upper_list = sorted(uppers)
    leaf_idx = {k: i for i, k in enumerate(leaf_list)}
    lower_idx = {k: i for i, k in enumerate(lower_list)}

    # breadth-first layout: Grid | Tree | Root+Tiles | uppers | lowers | leaves
    root_off = GRID_DATA_SIZE + TREE_DATA_SIZE               # from grid start
    upper_off = root_off + ROOT_DATA_SIZE + n_upper * ROOT_TILE_SIZE
    lower_off = upper_off + n_upper * UPPER_SIZE
    leaf_off = lower_off + n_lower * LOWER_SIZE
    grid_size = leaf_off + n_leaf * LEAF_SIZE

    buf = bytearray(grid_size)

    def leaf_stats(vals):
        m = vals != background
        a = vals[m] if m.any() else np.zeros(1, np.float32)
        return float(a.min()), float(a.max()), float(a.mean()), float(a.std())

    # ---- leaves -------------------------------------------------------
    for k in leaf_list:
        vals = leaves[k]
        base = leaf_off + leaf_idx[k] * LEAF_SIZE
        m = vals != background
        mx, my, mz = np.nonzero(m)
        bmin = np.array(k) + [mx.min(), my.min(), mz.min()]
        bdif = np.array([mx.max() - mx.min(), my.max() - my.min(),
                         mz.max() - mz.min()], np.uint8)
        struct.pack_into("<3i", buf, base, *bmin.astype(np.int32))
        struct.pack_into("<3B B", buf, base + 12, *bdif, 0)
        # valueMask: offset = x<<6 | y<<3 | z (LeafNode::CoordToOffset)
        mask = m.reshape(-1)                                 # x-major, z fastest
        buf[base + 16: base + 80] = _mask_bytes(mask)
        struct.pack_into("<4f", buf, base + 80, *leaf_stats(vals))
        buf[base + 96: base + 96 + 2048] = vals.astype("<f4").tobytes()

    # ---- lowers (LOG2DIM=4, child TOTAL=3) ----------------------------
    for k in lower_list:
        i = lower_idx[k]
        base = lower_off + i * LOWER_SIZE
        child_bits = np.zeros(4096, bool)
        table = np.zeros(4096, "<i8")
        for lk in lowers[k]:
            n = (((lk[0] & 127) >> 3) << 8) | (((lk[1] & 127) >> 3) << 4) \
                | ((lk[2] & 127) >> 3)
            child_bits[n] = True
            table[n] = (leaf_off + leaf_idx[lk] * LEAF_SIZE) - base
        allv = np.stack([leaves[lk] for lk in lowers[k]])
        bmin = np.minimum.reduce([np.frombuffer(
            buf[leaf_off + leaf_idx[lk] * LEAF_SIZE:
                leaf_off + leaf_idx[lk] * LEAF_SIZE + 12], "<i4")
            for lk in lowers[k]])
        bmax = np.maximum.reduce([np.frombuffer(
            buf[leaf_off + leaf_idx[lk] * LEAF_SIZE:
                leaf_off + leaf_idx[lk] * LEAF_SIZE + 12], "<i4") +
            np.frombuffer(buf[leaf_off + leaf_idx[lk] * LEAF_SIZE + 12:
                              leaf_off + leaf_idx[lk] * LEAF_SIZE + 15],
                          np.uint8).astype(np.int32)
            for lk in lowers[k]])
        struct.pack_into("<6i", buf, base, *bmin, *bmax)
        struct.pack_into("<Q", buf, base + 24, 0)            # flags
        buf[base + 32: base + 544] = b"\0" * 512             # valueMask off
        buf[base + 544: base + 1056] = _mask_bytes(child_bits)
        a = allv[allv != background]
        struct.pack_into("<4f", buf, base + 1056, float(a.min()),
                         float(a.max()), float(a.mean()), float(a.std()))
        buf[base + 1088: base + 1088 + 4096 * 8] = table.tobytes()

    # ---- uppers (LOG2DIM=5, child TOTAL=7) ----------------------------
    for ui, k in enumerate(upper_list):
        base = upper_off + ui * UPPER_SIZE
        child_bits = np.zeros(1 << 15, bool)
        table = np.zeros(1 << 15, "<i8")
        for lk in uppers[k]:
            n = (((lk[0] & 4095) >> 7) << 10) | \
                (((lk[1] & 4095) >> 7) << 5) | ((lk[2] & 4095) >> 7)
            child_bits[n] = True
            table[n] = (lower_off + lower_idx[lk] * LOWER_SIZE) - base
        struct.pack_into("<6i", buf, base, *bbox_min.astype(np.int32),
                         *bbox_max.astype(np.int32))
        struct.pack_into("<Q", buf, base + 24, 0)
        buf[base + 32: base + 4128] = b"\0" * 4096           # valueMask off
        buf[base + 4128: base + 8224] = _mask_bytes(child_bits)
        struct.pack_into("<4f", buf, base + 8224, vmin, vmax, vavg, vdev)
        buf[base + 8256: base + 8256 + (1 << 15) * 8] = table.tobytes()

    # ---- root + tiles --------------------------------------------------
    struct.pack_into("<6i", buf, root_off, *bbox_min.astype(np.int32),
                     *bbox_max.astype(np.int32))
    struct.pack_into("<I", buf, root_off + 24, n_upper)
    struct.pack_into("<5f", buf, root_off + 28, background, vmin, vmax,
                     vavg, vdev)
    for ti, k in enumerate(upper_list):
        tbase = root_off + ROOT_DATA_SIZE + ti * ROOT_TILE_SIZE
        # CoordToKey (USE_SINGLE_ROOT_KEY): z>>12 low 21 bits, y mid, x high
        key = ((k[2] >> 12) & 0x1FFFFF) | (((k[1] >> 12) & 0x1FFFFF) << 21) \
            | (((k[0] >> 12) & 0x1FFFFF) << 42)
        child = (upper_off + ti * UPPER_SIZE) - root_off
        struct.pack_into("<QqIf", buf, tbase, key, child, 1, 0.0)

    # ---- tree ----------------------------------------------------------
    t = GRID_DATA_SIZE
    struct.pack_into("<4Q", buf, t, leaf_off - t, lower_off - t,
                     upper_off - t, root_off - t)
    struct.pack_into("<3I", buf, t + 32, n_leaf, n_lower, n_upper)
    struct.pack_into("<3I", buf, t + 44, 0, 0, 0)            # active tiles
    struct.pack_into("<Q", buf, t + 56, voxel_count)

    # ---- grid ----------------------------------------------------------
    struct.pack_into("<QQ", buf, 0, NANOVDB_MAGIC, 0)        # magic, checksum
    struct.pack_into("<4I", buf, 16, VERSION, GRID_FLAGS, 0, 1)
    struct.pack_into("<Q", buf, 32, grid_size)
    nm = name.encode()[:255]
    buf[40: 40 + len(nm)] = nm
    # Map (264B): uniform scale voxel_size, zero translation
    map_off = 40 + 256
    eye = np.eye(3, dtype="<f4") * voxel_size
    inv = np.eye(3, dtype="<f4") / voxel_size
    buf[map_off: map_off + 36] = eye.tobytes()
    buf[map_off + 36: map_off + 72] = inv.tobytes()
    struct.pack_into("<3f f", buf, map_off + 72, 0, 0, 0, 0)
    eyed = np.eye(3, dtype="<f8") * voxel_size
    invd = np.eye(3, dtype="<f8") / voxel_size
    buf[map_off + 88: map_off + 160] = eyed.tobytes()
    buf[map_off + 160: map_off + 232] = invd.tobytes()
    struct.pack_into("<3d d", buf, map_off + 232, 0, 0, 0, 0)
    wb_off = map_off + 264
    wbb = np.array([bbox_min * voxel_size, (bbox_max + 1) * voxel_size],
                   "<f8")
    buf[wb_off: wb_off + 48] = wbb.tobytes()
    struct.pack_into("<3d", buf, wb_off + 48, voxel_size, voxel_size,
                     voxel_size)
    struct.pack_into("<II q I", buf, wb_off + 72, grid_class,
                     GRID_TYPE_FLOAT, 0, 0)

    # ---- file header + metadata + name --------------------------------
    hdr = struct.pack("<QIHH", NANOVDB_MAGIC, VERSION, 1, 0)
    meta = struct.pack(
        "<QQQQ II", grid_size, grid_size, 0, voxel_count, GRID_TYPE_FLOAT,
        grid_class)
    meta += wbb.tobytes()
    # file-level indexBBox: INCLUSIVE max (OpenVDB CoordBBox convention)
    meta += np.array([bbox_min, bbox_max], "<i4").tobytes()
    meta += np.array([voxel_size] * 3, "<f8").tobytes()
    meta += struct.pack("<I", len(nm) + 1)
    meta += struct.pack("<4I", n_leaf, n_lower, n_upper, 1)
    meta += struct.pack("<3I", 0, 0, 0)
    meta += struct.pack("<HHI", 0, 0, VERSION)
    assert len(meta) == 176, len(meta)
    Path(path).write_bytes(hdr + meta + nm + b"\0" + bytes(buf))
