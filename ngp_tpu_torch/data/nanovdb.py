"""NanoVDB (.nvdb) ingestion (port of ``ngp_tpu/data/nanovdb.py``, numpy
only).

The reference consumes uncompressed single-grid NanoVDB files and only
reads voxel values through a dense accessor (ref: Testbed::load_volume,
src/testbed_volume.cu:526-626 — header/metadata structs are fixed-layout
PODs). Here:

- ``read_header`` parses the file header + first grid's metadata (exact
  v32.x layout).
- ``load_volume_grid`` densifies the first FloatGrid over its indexBBox.
  Tree decoding targets the NanoVDB 32.x ABI (Grid→Tree→Root→Internal
  32³/16³→Leaf 8³). Files outside that ABI raise with a clear message.
- ``VolumeGrid`` also accepts raw dense arrays (.npy) and provides the
  world↔index mapping + 128³ occupancy bitgrid the renderer/trainer use,
  with the same scale/offset conventions as the reference.
"""
from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from ngp_tpu_torch.grid.occupancy import morton3d

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"


@dataclasses.dataclass
class NvdbMetadata:
    grid_size: int
    voxel_count: int
    grid_type: int
    grid_class: int
    world_bbox: np.ndarray
    index_bbox: np.ndarray
    voxel_size: np.ndarray
    name: str
    version: int


def read_header(raw: bytes):
    magic, version, grid_count, codec = struct.unpack_from("<QIHH", raw, 0)
    if magic != NANOVDB_MAGIC:
        raise ValueError("not a NanoVDB file")
    if grid_count == 0:
        raise ValueError("no grids in file")
    if codec != 0:
        raise ValueError("compressed .nvdb not supported (codec != 0)")
    off = 16
    (grid_size, file_size, name_key, voxel_count, grid_type, grid_class
     ) = struct.unpack_from("<QQQQII", raw, off)
    off += 40  # 4×u64 + 2×u32 (total metadata is 176 B, ref static_assert)
    world_bbox = np.frombuffer(raw, np.float64, 6, off).reshape(2, 3)
    off += 48
    index_bbox = np.frombuffer(raw, np.int32, 6, off).reshape(2, 3).copy()
    off += 24
    voxel_size = np.frombuffer(raw, np.float64, 3, off).copy()
    off += 24
    name_size, = struct.unpack_from("<I", raw, off)
    off += 4
    off += 16 + 12 + 2 + 2 + 4  # nodeCount, tileCount, codec, padding, version
    name = raw[off: off + name_size].split(b"\0")[0].decode()
    off += name_size
    meta = NvdbMetadata(grid_size, voxel_count, grid_type, grid_class,
                        world_bbox, index_bbox, voxel_size, name, version)
    return meta, off  # off = start of grid payload


def _densify_floatgrid(payload: bytes, meta: NvdbMetadata) -> np.ndarray:
    """Decode a NanoVDB 32.x FloatGrid into a dense (X, Y, Z) array over
    the index bbox. Uses the fixed ABI offsets of v32.3 (the version the
    reference vendors); leaves are 8³ float arrays with a value mask."""
    ib = meta.index_bbox
    # file indexBBox max is INCLUSIVE (OpenVDB CoordBBox convention; the
    # root's mBBox is a CoordBBox — NanoVDB.h:2719). Note the reference's
    # own loader iterates [min, max) and so drops the last slice of real
    # files (testbed_volume.cu:608-611); we decode the true extent.
    size = (ib[1] - ib[0]) + 1
    if np.any(size <= 0) or np.prod(size.astype(np.int64)) > (1 << 30):
        raise ValueError(f"unreasonable index bbox {ib}")
    dense = np.zeros(tuple(size), np.float32)

    # GridData (v32.3): magic(8) checksum(8) version(4) flags(4) gridIndex(4)
    # gridCount(4) gridSize(8) gridName(256) map(264) worldBBox(48)
    # voxelSize(24) gridClass(4) gridType(4) blindDataOffset(8)
    # blindDataCount(4) + padding → TreeData at 672.
    GRID_DATA_SIZE = 672
    magic = struct.unpack_from("<Q", payload, 0)[0]
    if magic != NANOVDB_MAGIC:
        raise ValueError("grid payload magic mismatch")
    # TreeData (v32.x): 4 node offsets (int64) + 4 node counts + 4 tile
    # counts... layout: bytes[64]: nodeOffset[4] (u64), nodeCount[3] (u32),
    # tileCount[3] (u32), voxelCount (u64)
    tree_off = GRID_DATA_SIZE
    node_off = struct.unpack_from("<4Q", payload, tree_off)
    leaf_count, lower_count, upper_count = struct.unpack_from(
        "<3I", payload, tree_off + 32)
    leaf_off = tree_off + node_off[0]

    # LeafData<float> (v32.3, NanoVDB.h:3354): mBBoxMin (12B=3×i32) +
    # mBBoxDif (3×u8) + mFlags (u8) + valueMask (64B) + min,max,avg,dev
    # (16B) + values[512] (2048B) → 2144B (32-aligned)
    LEAF_SIZE = 12 + 3 + 1 + 64 + 16 + 512 * 4
    for i in range(leaf_count):
        base = leaf_off + i * LEAF_SIZE
        bmin = np.frombuffer(payload, np.int32, 3, base)
        vals = np.frombuffer(payload, np.float32, 512, base + 96)
        # leaf origin is bbox min rounded down to multiple of 8; boundary
        # leaves may overhang the index bbox — copy the overlap only
        org = (bmin & ~7) - ib[0]
        v = vals.reshape(8, 8, 8)  # CoordToOffset: x-major, z fastest
        lo = np.maximum(org, 0)
        hi = np.minimum(org + 8, size)
        if (hi <= lo).any():
            continue
        dense[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = \
            v[lo[0] - org[0]:hi[0] - org[0],
              lo[1] - org[1]:hi[1] - org[1],
              lo[2] - org[2]:hi[2] - org[2]]
    return dense


class VolumeGrid:
    """Dense density volume + world↔index mapping (ref conventions:
    world2index_scale = max bbox extent, aabb centered at 0.5)."""

    def __init__(self, dense: np.ndarray, index_bbox_min=None):
        self.dense = np.asarray(dense, np.float32)
        sizes = np.asarray(self.dense.shape, np.float32)
        maxsize = float(sizes.max())
        self.world2index_scale = maxsize
        ib0 = np.zeros(3) if index_bbox_min is None else np.asarray(index_bbox_min)
        self.index_bbox_min = ib0
        self.world2index_offset = (ib0 + (ib0 + sizes)) * 0.5 - 0.5 * maxsize
        half = sizes / maxsize * 0.5
        self.aabb_min = 0.5 - half
        self.aabb_max = 0.5 + half
        self.global_majorant = float(self.dense.max())

    def density_at_index(self, idx: np.ndarray) -> np.ndarray:
        i = np.clip(idx - self.index_bbox_min, 0,
                    np.asarray(self.dense.shape) - 1).astype(np.int32)
        return self.dense[i[:, 0], i[:, 1], i[:, 2]]

    def occupancy_dense_128(self, threshold: float = 1e-3) -> np.ndarray:
        """(128,128,128) bool occupancy in normalized volume coords
        (x, y, z indexing) — the renderer's early-skip majorant mask
        (ref: bitgrid in load_volume / render_volume)."""
        xs, ys, zs = np.nonzero(self.dense > threshold)
        idx = np.stack([xs, ys, zs], -1) + self.index_bbox_min
        f = ((idx + 0.5) - self.world2index_offset) / self.world2index_scale
        cell = np.clip((f * 128).astype(np.int32), 0, 127)
        occ = np.zeros((128, 128, 128), bool)
        occ[cell[:, 0], cell[:, 1], cell[:, 2]] = True
        # dilate one cell so boundary samples never cull true content
        # (conservative majorant)
        d = occ.copy()
        for ax in range(3):
            d |= np.roll(occ, 1, ax) | np.roll(occ, -1, ax)
        return d

    def bitgrid_128(self, threshold: float = 1e-3) -> np.ndarray:
        """128³ occupancy bitfield in Morton order (ref: load_volume)."""
        xs, ys, zs = np.nonzero(self.dense > threshold)
        idx = np.stack([xs, ys, zs], -1) + self.index_bbox_min
        f = ((idx + 0.5) - self.world2index_offset) / self.world2index_scale
        cell = np.clip((f * 128 + 0.5).astype(np.int32), 0, 127)
        m = morton3d(cell[:, 0], cell[:, 1], cell[:, 2])
        bits = np.zeros(128 ** 3 // 8, np.uint8)
        np.bitwise_or.at(bits, m // 8, (1 << (m % 8)).astype(np.uint8))
        return bits


def load_volume_grid(path) -> VolumeGrid:
    path = Path(path)
    if path.suffix == ".npy":
        return VolumeGrid(np.load(path))
    raw = path.read_bytes()
    meta, off = read_header(raw)
    dense = _densify_floatgrid(raw[off: off + meta.grid_size], meta)
    return VolumeGrid(dense, index_bbox_min=meta.index_bbox[0])


def make_procedural_plume(res: int = 128, seed: int = 0) -> np.ndarray:
    """Synthetic smoke plume (for tests/bench — no .nvdb asset ships with
    the reference repo either)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*[np.linspace(0, 1, res)] * 3, indexing="ij")
    # rising column with noise-modulated radius
    r = np.sqrt((x - 0.5 - 0.15 * np.sin(3 * z)) ** 2 +
                (y - 0.5 - 0.1 * np.cos(4 * z)) ** 2)
    radius = 0.08 + 0.25 * z
    dens = np.clip(1.0 - r / np.maximum(radius, 1e-3), 0, 1) ** 1.5
    dens *= np.clip(1.2 - z, 0, 1)
    noise = rng.random((8, 8, 8))
    from scipy.ndimage import zoom
    noise = zoom(noise, res / 8, order=1)
    dens *= 0.5 + noise
    return (dens * 4.0).astype(np.float32)
