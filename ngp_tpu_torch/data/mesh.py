"""Mesh loading (OBJ, binary STL) and the host BVH (port of
``ngp_tpu/data/mesh.py``; ref: Testbed::load_mesh,
src/testbed_sdf.cu:989-1081, and src/triangle_bvh.cu).

The BVH is the port's own C++ (``ngp_tpu_torch/csrc/bvh.cpp``), built at
first use with ``g++ -O3 -march=native -shared -fPIC -pthread`` into
``build/ngp_tpu_torch/`` under a name hashed from the source and flags,
and called through ctypes; its queries run on all host cores and release
the GIL. ``-march=native`` is the JAX package's flag: with it the compiler
contracts the distance arithmetic into FMAs as the JAX package's build
does, so both give the same distances bit for bit (without it they
differ by an ulp).

Normalisation is the reference's: the AABB inflated by 0.5 % of its
diagonal, vertices mapped into the unit cube by the uniform scale 1 /
max extent, centred per axis (ref: src/testbed_sdf.cu:1032-1043).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC.parent.parent / "build" / "ngp_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((_CSRC / "bvh.cpp").read_bytes())
    return BUILD_DIR / f"libngp_tpu_torch_bvh_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    """Build (if the source changed) and load the BVH library."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                        str(_CSRC / "bvh.cpp")], check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bvh_build.restype = vp
    lib.bvh_build.argtypes = [vp, i64, vp, i64]
    lib.bvh_free.argtypes = [vp]
    lib.bvh_signed_distance.argtypes = [vp, vp, i64, vp, ctypes.c_int]
    lib.bvh_closest_points.argtypes = [vp, vp, i64, vp, vp]
    lib.bvh_raytrace.argtypes = [vp, vp, vp, i64, vp, vp, vp]
    _lib = lib
    return lib


def load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ: ``v`` and ``f`` lines (polygons fan-triangulated,
    negative indices relative to the end)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def load_stl(path) -> tuple[np.ndarray, np.ndarray]:
    """Binary STL: three vertices per triangle, unshared."""
    raw = Path(path).read_bytes()
    n = struct.unpack_from("<I", raw, 80)[0]
    tris = np.frombuffer(raw, np.uint8, n * 50, 84).reshape(n, 50)
    verts = tris[:, 12:48].copy().view(np.float32).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return verts.astype(np.float32), faces


def load_mesh(path) -> tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Load an OBJ or STL and normalise it into the unit cube. Returns
    (vertices, faces, mesh_scale, offset); the original coordinates are
    ``v * mesh_scale + offset``."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".obj":
        verts, faces = load_obj(path)
    elif suffix == ".stl":
        verts, faces = load_stl(path)
    else:
        raise ValueError(f"unsupported mesh format {path.suffix}")
    if len(verts) == 0:
        raise ValueError("empty mesh")
    bmin, bmax = verts.min(0), verts.max(0)
    inflation = 0.005 * np.linalg.norm(bmax - bmin)
    bmin, bmax = bmin - inflation, bmax + inflation
    mesh_scale = float((bmax - bmin).max())
    center_off = (bmax + bmin) / 2 - mesh_scale / 2
    verts = (verts - center_off) / mesh_scale
    return verts.astype(np.float32), faces, mesh_scale, center_off


class TriangleBvh:
    """Host BVH over a triangle mesh: signed distances, closest points, ray
    casts and area-weighted surface samples."""

    MODE_WATERTIGHT = 0
    MODE_RAYSTAB = 1
    MODE_PATHESCAPE = 2  # random-walk escape (ref: optix/pathescape.cu)

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self._handle = _load().bvh_build(
            self.vertices.ctypes.data, len(self.vertices),
            self.faces.ctypes.data, len(self.faces))
        # triangle areas → the surface-sampling CDF (ref:
        # DiscreteDistribution)
        a, b, c = (self.vertices[self.faces[:, k]] for k in range(3))
        self.tri_areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a),
                                              axis=-1)
        cdf = np.cumsum(self.tri_areas)
        self.area_cdf = cdf / cdf[-1]

    def __del__(self):
        if getattr(self, "_handle", None) and _lib is not None:
            _lib.bvh_free(self._handle)

    def signed_distance(self, points: np.ndarray,
                        mode: int = MODE_RAYSTAB) -> np.ndarray:
        """(N, 3) points → (N,) distances, negative inside; the sign by
        ``mode`` (watertight, raystab or pathescape)."""
        pts = np.ascontiguousarray(points, np.float32)
        out = np.empty(len(pts), np.float32)
        _load().bvh_signed_distance(self._handle, pts.ctypes.data, len(pts),
                                    out.ctypes.data, int(mode))
        return out

    def closest_points(self, points: np.ndarray):
        """(N, 3) points → (closest surface points (N, 3), triangles (N,))."""
        pts = np.ascontiguousarray(points, np.float32)
        out = np.empty_like(pts)
        tris = np.empty(len(pts), np.int32)
        _load().bvh_closest_points(self._handle, pts.ctypes.data, len(pts),
                                   out.ctypes.data, tris.ctypes.data)
        return out, tris

    def raytrace(self, origins: np.ndarray, dirs: np.ndarray):
        """Closest hits: (t (N,), triangle (N,), -1 for a miss, normal
        (N, 3))."""
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        t = np.empty(len(o), np.float32)
        tri = np.empty(len(o), np.int32)
        nrm = np.empty_like(o)
        _load().bvh_raytrace(self._handle, o.ctypes.data, d.ctypes.data,
                             len(o), t.ctypes.data, tri.ctypes.data,
                             nrm.ctypes.data)
        return t, tri, nrm

    def sample_surface(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """n area-weighted surface samples (ref:
        sample_uniform_on_triangle), drawn from ``rng`` in the JAX
        package's order."""
        ti = np.searchsorted(self.area_cdf, rng.random(n))
        ti = np.clip(ti, 0, len(self.faces) - 1)
        a = self.vertices[self.faces[ti, 0]]
        b = self.vertices[self.faces[ti, 1]]
        c = self.vertices[self.faces[ti, 2]]
        u, v = rng.random((2, n)).astype(np.float32)
        flip = u + v > 1
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        return (a + (b - a) * u[:, None]
                + (c - a) * v[:, None]).astype(np.float32)
