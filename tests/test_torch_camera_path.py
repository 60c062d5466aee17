"""The port's camera paths, quaternion helpers and render-buffer curves
against the JAX package's (1e-6): camera-path JSON files written by either
package load in the other, the B-spline evaluation, ``log_space_lerp``,
the legacy ``dof`` key, the per-ray camera interpolation of motion blur,
and the tonemap curves of ``render/buffer.py``."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.common import TonemapCurve as JTonemapCurve
from ngp_tpu.io import camera_path as jcp
from ngp_tpu.rays import camera as jcam
from ngp_tpu.render import buffer as jbuf
from ngp_tpu_torch.common import TonemapCurve
from ngp_tpu_torch.io import camera_path as tcp
from ngp_tpu_torch.rays import camera as tcam
from ngp_tpu_torch.render import buffer as tbuf

TOL = 1e-6


def _rotation(rng):
    q = rng.standard_normal(4)
    return np.asarray(jcp.quat_to_rotmat(q / np.linalg.norm(q)), np.float64)


def _keyframes(mod, rng, n=4):
    out = []
    for i in range(n):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = _rotation(rng)
        m[:, 3] = rng.standard_normal(3)
        out.append(mod.CameraKeyframe.from_matrix(
            m, slice_plane_z=0.1 * i, scale=1.0 + 0.2 * i, fov=40.0 + i,
            aperture_size=0.01 * i, glow_mode=i % 3, glow_y_cutoff=0.5 * i))
    return out


def _same_keyframe(a, b):
    np.testing.assert_allclose(a.R, b.R, atol=TOL)
    np.testing.assert_allclose(a.T, b.T, atol=TOL)
    for f in ("slice_plane_z", "scale", "fov", "aperture_size",
              "glow_y_cutoff"):
        assert getattr(a, f) == pytest.approx(getattr(b, f), abs=TOL)
    assert a.glow_mode == b.glow_mode


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_camera_path_files_load_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(0)
    w, r = (tcp, jcp) if writer == "port" else (jcp, tcp)
    path = w.CameraPath(_keyframes(w, rng), duration_seconds=2.5, loop=True)
    f = tmp_path / "path.json"
    path.save(f)
    back = r.CameraPath.load(f)
    assert back.duration_seconds == 2.5 and back.loop
    for a, b in zip(path.keyframes, back.keyframes):
        _same_keyframe(a, b)


@pytest.mark.parametrize("loop", [False, True])
def test_spline_eval_matches_jax(loop):
    rng = np.random.default_rng(1)
    kfs = _keyframes(jcp, rng, 5)
    jpath = jcp.CameraPath(kfs, loop=loop)
    tpath = tcp.CameraPath([tcp.CameraKeyframe(**vars(k)) for k in kfs],
                           loop=loop)
    for t in np.linspace(0.0, 1.0, 17):
        _same_keyframe(tpath.eval(t), jpath.eval(t))
        np.testing.assert_allclose(tpath.eval(t).to_matrix(),
                                   jpath.eval(t).to_matrix(), atol=TOL)


def test_legacy_dof_key_is_the_aperture(tmp_path):
    f = tmp_path / "legacy.json"
    f.write_text(json.dumps({"time": 1.0, "path": [
        {"R": [0.0, 0.0, 0.0, 1.0], "T": [0.0, 1.0, 2.0], "dof": 0.25}]}))
    assert tcp.CameraPath.load(f).keyframes[0].aperture_size == 0.25
    _same_keyframe(tcp.CameraPath.load(f).keyframes[0],
                   jcp.CameraPath.load(f).keyframes[0])


def test_log_space_lerp_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(4):
        a = np.concatenate([_rotation(rng), rng.standard_normal((3, 1))], 1)
        b = np.concatenate([_rotation(rng), rng.standard_normal((3, 1))], 1)
        for t in (0.0, 0.3, 0.5, 1.0):
            np.testing.assert_allclose(tcp.log_space_lerp(a, b, t),
                                       jcp.log_space_lerp(a, b, t),
                                       atol=TOL)


def test_quaternion_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    mats = [_rotation(rng) for _ in range(16)]
    # every pivot of Shepperd's method: 180° turns about each axis too
    mats += [np.diag(d).astype(np.float64) for d in
             ((1, -1, -1), (-1, 1, -1), (-1, -1, 1))]
    for m in mats:
        q_np = tcp.rotmat_to_quat(m.astype(np.float32))
        np.testing.assert_allclose(q_np, jcp.rotmat_to_quat(
            m.astype(np.float32)), atol=TOL)
        np.testing.assert_allclose(tcp.quat_to_rotmat(q_np), m, atol=1e-5)
    stack = torch.from_numpy(np.stack(mats).astype(np.float32))
    q = tcam.quat_from_mat(stack)
    jq = np.stack([np.asarray(jcam.quat_from_mat(jnp.asarray(m, jnp.float32)))
                   for m in mats])
    np.testing.assert_allclose(q.numpy(), jq, atol=TOL)
    np.testing.assert_allclose(tcam.quat_to_mat(q).numpy(),
                               np.stack(mats), atol=1e-5)
    np.testing.assert_allclose(tcam.quat_to_mat(q).numpy(),
                               np.asarray(jcam.quat_to_mat(jnp.asarray(jq))),
                               atol=TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_xform_slerp_matches_jax(batched):
    rng = np.random.default_rng(4)
    n = 32
    t = rng.random(n).astype(np.float32)

    def xf(k):
        return np.concatenate([_rotation(rng), rng.standard_normal((3, 1))],
                              1).astype(np.float32) if k is None else \
            np.stack([xf(None) for _ in range(k)])
    a, b = (xf(n), xf(n)) if batched else (xf(None), xf(None))
    got = tcam.xform_slerp(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(t))
    ref = jcam.xform_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("curve", list(TonemapCurve), ids=lambda c: c.value)
def test_tonemap_curves_match_jax(curve):
    x = np.linspace(0.0, 8.0, 2001, dtype=np.float32)
    got = tbuf.tonemap(torch.from_numpy(x), curve).numpy()
    ref = np.asarray(jbuf.tonemap(jnp.asarray(x), JTonemapCurve(curve.value)))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    rgba = np.random.default_rng(5).random((6, 5, 4)).astype(np.float32) * 3
    for to_srgb in (False, True):
        got = tbuf.finalize_frame(torch.from_numpy(rgba), 0.7, curve,
                                  to_srgb).numpy()
        ref = jbuf.finalize_frame(jnp.asarray(rgba), 0.7,
                                  JTonemapCurve(curve.value), to_srgb)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


def test_accumulate_matches_jax():
    rng = np.random.default_rng(6)
    prev, new = rng.random((2, 4, 4, 4)).astype(np.float32)
    for spp in (0, 1, 5):
        np.testing.assert_allclose(
            tbuf.accumulate(torch.from_numpy(prev), torch.from_numpy(new),
                            spp).numpy(),
            np.asarray(jbuf.accumulate(jnp.asarray(prev), jnp.asarray(new),
                                       spp)), atol=TOL)
