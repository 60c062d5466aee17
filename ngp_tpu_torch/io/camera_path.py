"""Camera paths: keyframes, cubic B-spline evaluation, JSON I/O (a copy of
``ngp_tpu/io/camera_path.py``, numpy and scipy only, so the two packages
read and write the same files).

Equivalent of the reference's camera path system (ref: src/camera_path.cu,
camera_path.h): ``CameraKeyframe{R (quaternion), T, slice, scale, fov,
aperture_size, glow_mode, glow_y_cutoff}``, evaluated with a cubic
B-spline over 4 consecutive keyframes with shortest-path quaternion
handling, saved as {"time": duration, "path": [keyframes]} JSON.

Also hosts ``log_space_lerp`` — SE(3) matrix log/exp interpolation used for
camera motion blur in offline renders (ref: src/common_device.cu:28-37).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np


@dataclasses.dataclass
class CameraKeyframe:
    R: np.ndarray            # quaternion (x, y, z, w) like Eigen coeffs
    T: np.ndarray            # (3,)
    slice_plane_z: float = 0.0
    scale: float = 1.0
    fov: float = 50.0
    aperture_size: float = 0.0
    glow_mode: int = 0
    glow_y_cutoff: float = 0.0

    @classmethod
    def from_matrix(cls, m: np.ndarray, **kw) -> "CameraKeyframe":
        q = rotmat_to_quat(np.asarray(m)[:3, :3])
        return cls(R=q, T=np.asarray(m)[:3, 3].copy(), **kw)

    def to_matrix(self) -> np.ndarray:
        m = np.zeros((3, 4), np.float32)
        m[:3, :3] = quat_to_rotmat(self.R / np.linalg.norm(self.R))
        m[:3, 3] = self.T
        return m


def rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """(3,3) → quaternion (x,y,z,w)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s], np.float32)
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4, np.float32)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _align_quats(kfs: List[CameraKeyframe]) -> List[CameraKeyframe]:
    """Shortest-path sign fix between consecutive keyframes
    (ref: camera_path.cu:30-50 quaternion short-path handling)."""
    out = [kfs[0]]
    for k in kfs[1:]:
        q = k.R.copy()
        if np.dot(q, out[-1].R) < 0:
            q = -q
        out.append(dataclasses.replace(k, R=q))
    return out


def _kf_lerp_raw(a: CameraKeyframe, b: CameraKeyframe, t: float):
    """Component-wise lerp used by the spline basis combination."""
    return np.concatenate([a.R * (1 - t) + b.R * t,
                           a.T * (1 - t) + b.T * t,
                           [a.slice_plane_z * (1 - t) + b.slice_plane_z * t,
                            a.scale * (1 - t) + b.scale * t,
                            a.fov * (1 - t) + b.fov * t,
                            a.aperture_size * (1 - t) + b.aperture_size * t]])


def spline_eval(t: float, k0: CameraKeyframe, k1: CameraKeyframe,
                k2: CameraKeyframe, k3: CameraKeyframe) -> CameraKeyframe:
    """Cubic B-spline over 4 keyframes (ref: spline(), camera_path.cu:52-71 —
    the Catmull-Rom branch is compiled out in the reference too)."""
    k0, k1, k2, k3 = _align_quats([k0, k1, k2, k3])
    tt = t * t
    ttt = t * t * t
    # uniform cubic B-spline basis
    w0 = (1 - t) ** 3 / 6.0
    w1 = (3 * ttt - 6 * tt + 4) / 6.0
    w2 = (-3 * ttt + 3 * tt + 3 * t + 1) / 6.0
    w3 = ttt / 6.0

    def vec(k: CameraKeyframe):
        return np.concatenate([k.R, k.T, [k.slice_plane_z, k.scale, k.fov,
                                          k.aperture_size]])

    v = w0 * vec(k0) + w1 * vec(k1) + w2 * vec(k2) + w3 * vec(k3)
    q = v[:4]
    q = q / max(np.linalg.norm(q), 1e-9)
    return CameraKeyframe(R=q.astype(np.float32), T=v[4:7].astype(np.float32),
                          slice_plane_z=float(v[7]), scale=float(v[8]),
                          fov=float(v[9]), aperture_size=float(v[10]))


class CameraPath:
    """Keyframe sequence with normalized-time evaluation
    (ref: CameraPath::eval_camera_path, camera_path.h:89-96)."""

    def __init__(self, keyframes: List[CameraKeyframe] = None,
                 duration_seconds: float = 3.0, loop: bool = False):
        self.keyframes = keyframes or []
        self.duration_seconds = duration_seconds
        self.loop = loop

    def get_keyframe(self, i: int) -> CameraKeyframe:
        n = len(self.keyframes)
        if self.loop:
            return self.keyframes[i % n]
        return self.keyframes[int(np.clip(i, 0, n - 1))]

    def eval(self, t: float) -> CameraKeyframe:
        """t ∈ [0,1] over the whole path."""
        n = len(self.keyframes)
        if n == 0:
            raise ValueError("empty camera path")
        if n == 1:
            return self.keyframes[0]
        segs = n if self.loop else n - 1
        x = np.clip(t, 0.0, 1.0 - 1e-6) * segs
        i = int(x)
        u = x - i
        return spline_eval(u, self.get_keyframe(i - 1), self.get_keyframe(i),
                           self.get_keyframe(i + 1), self.get_keyframe(i + 2))

    # JSON I/O (ref: camera_path.cu:78-108, legacy "dof" key honored) ------

    def save(self, path):
        doc = {"time": self.duration_seconds, "loop": self.loop,
               "path": [{
                   "R": [float(x) for x in k.R],
                   "T": [float(x) for x in k.T],
                   "slice": k.slice_plane_z, "scale": k.scale, "fov": k.fov,
                   "aperture_size": k.aperture_size,
                   "glow_mode": k.glow_mode,
                   "glow_y_cutoff": k.glow_y_cutoff,
               } for k in self.keyframes]}
        Path(path).write_text(json.dumps(doc, indent=2))

    @classmethod
    def load(cls, path) -> "CameraPath":
        doc = json.loads(Path(path).read_text())
        kfs = []
        for e in doc.get("path", []):
            kfs.append(CameraKeyframe(
                R=np.asarray(e["R"], np.float32),
                T=np.asarray(e["T"], np.float32),
                slice_plane_z=float(e.get("slice", 0.0)),
                scale=float(e.get("scale", 1.0)),
                fov=float(e.get("fov", 50.0)),
                aperture_size=float(e.get("aperture_size", e.get("dof", 0.0))),
                glow_mode=int(e.get("glow_mode", 0)),
                glow_y_cutoff=float(e.get("glow_y_cutoff", 0.0))))
        return cls(kfs, duration_seconds=float(doc.get("time", 3.0)),
                   loop=bool(doc.get("loop", False)))


def log_space_lerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    """SE(3) interpolation via matrix log/exp (ref: log_space_lerp,
    src/common_device.cu:28-37) — used for camera motion blur."""
    A = np.eye(4)
    B = np.eye(4)
    A[:3, :4] = a
    B[:3, :4] = b
    from scipy.linalg import expm, logm
    M = B @ np.linalg.inv(A)
    L = np.real(logm(M))
    return (expm(L * t) @ A)[:3, :4].astype(np.float32)
