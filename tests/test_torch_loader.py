"""Parity of the port's NeRF loader and image I/O with the JAX package: a
small scene written here as PNG (the sRGB uint8 path) and as EXR (the
float path), with OpenCV intrinsics, several transforms files, a world
scale/offset and a downscale, loads into equal ``NerfDataset`` fields."""
import json

import numpy as np
import pytest

import ngp_tpu.data.image_io as jio
import ngp_tpu.data.nerf_loader as jload
import ngp_tpu_torch.data.image_io as tio
import ngp_tpu_torch.data.nerf_loader as tload

W, H = 24, 16
FIELDS = ("xforms", "xforms_end", "focal", "principal", "resolution",
          "lens_params", "lens_is_opencv", "aabb_scale", "scale", "offset",
          "n_extra_learnable_dims", "sharpness", "up", "lens_mode")


def _frames(rng, n, ext, start):
    out = []
    for i in range(n):
        a = 2 * np.pi * (start + i) / 8
        m = np.eye(4)
        m[:3, 3] = [2 * np.cos(a), 2 * np.sin(a), 0.5]
        out.append({"file_path": f"images/{start + i:03d}{ext}",
                    "transform_matrix": m.tolist(),
                    "sharpness": float(rng.uniform(10.0, 100.0))})
    return out


def _write_scene(root, kind: str):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    ext = ".png" if kind == "png" else ".exr"
    common = {"fl_x": 30.0, "fl_y": 31.0, "cx": 12.5, "cy": 7.5, "w": W,
              "h": H, "k1": -0.05, "k2": 0.01, "p1": 1e-3, "p2": -1e-3,
              "aabb_scale": 4, "scale": 0.5, "offset": [0.5, 0.4, 0.6]}
    for name, start, n in (("transforms_train.json", 0, 3),
                           ("transforms_val.json", 3, 2)):
        frames = _frames(rng, n, ext, start)
        (root / name).write_text(json.dumps({**common, "frames": frames}))
        for f in frames:
            img = rng.random((H, W, 4)).astype(np.float32)
            img[..., 3] = np.where(rng.random((H, W)) < 0.2, 0.0, 1.0)
            if kind == "png":
                from PIL import Image
                Image.fromarray((img * 255).round().astype(np.uint8),
                                "RGBA").save(root / f["file_path"])
            else:
                jio.save_exr(root / f["file_path"], img)
    return [root / "transforms_train.json", root / "transforms_val.json"]


@pytest.mark.parametrize("kind", ["png", "exr"])
@pytest.mark.parametrize("downscale", [1, 2])
def test_load_nerf_matches_jax(tmp_path, kind, downscale):
    paths = _write_scene(tmp_path, kind)
    t = tload.load_nerf(paths, downscale=downscale)
    j = jload.load_nerf(paths, downscale=downscale)
    assert t.n_images == j.n_images == 5
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f)
        else:
            assert a == b, f
    np.testing.assert_allclose(np.asarray(t.images), np.asarray(j.images),
                               rtol=1e-6, atol=1e-7)
    assert (t.images_u8 is None) == (j.images_u8 is None)
    if j.images_u8 is not None:
        np.testing.assert_array_equal(t.images_u8, j.images_u8)
    assert t.lens_is_opencv and t.resolution[0].tolist() == [W // downscale,
                                                            H // downscale]


def test_sharpness_culling_matches_jax_and_sidecars_raise(tmp_path):
    paths = _write_scene(tmp_path, "png")
    t = tload.load_nerf(paths, sharpness_discard_threshold=0.9)
    j = jload.load_nerf(paths, sharpness_discard_threshold=0.9)
    assert 0 < t.n_images == j.n_images < 5
    np.testing.assert_array_equal(t.sharpness, j.sharpness)
    np.testing.assert_array_equal(t.xforms, j.xforms)
    # an alpha sidecar loads as in the JAX package (every sidecar:
    # tests/test_torch_captures.py); a missing envmap still raises in both
    from PIL import Image
    Image.new("RGBA", (W, H)).save(tmp_path / "images" / "000.alpha.png")
    t, j = tload.load_nerf(paths), jload.load_nerf(paths)
    np.testing.assert_array_equal(np.asarray(t.images), np.asarray(j.images))
    assert t.images_u8 is None and np.asarray(t.images)[0, ..., 3].max() == 0
    cfg = json.loads(paths[0].read_text())
    paths[0].write_text(json.dumps({**cfg, "envmap": "absent.exr"}))
    for load in (tload.load_nerf, jload.load_nerf):
        with pytest.raises(FileNotFoundError, match="Environment map"):
            load(paths)


def test_image_io_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.random((H, W, 4)) * 4).astype(np.float32)
    for dtype in (np.float16, np.float32):
        tio.save_exr(tmp_path / "a.exr", img, dtype=dtype)
        np.testing.assert_array_equal(tio.load_exr(tmp_path / "a.exr"),
                                      jio.load_exr(tmp_path / "a.exr"))
    # .bin images hold f16
    tio.save_binary_image(tmp_path / "b.bin", img)
    img16 = img.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(jio.load_binary_image(tmp_path / "b.bin"),
                                  img16)
    np.testing.assert_array_equal(tio.load_binary_image(tmp_path / "b.bin"),
                                  img16)
    u8 = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    np.testing.assert_array_equal(tio.u8_to_linear_rgba(u8),
                                  jio.u8_to_linear_rgba(u8))
    tio.save_stbi(tmp_path / "c.png", img.clip(0, 1))
    np.testing.assert_array_equal(tio.load_stbi(tmp_path / "c.png"),
                                  jio.load_stbi(tmp_path / "c.png"))


def test_matrix_conversions_round_trip():
    rng = np.random.default_rng(2)
    m = np.eye(4)
    m[:3, :3], _ = np.linalg.qr(rng.standard_normal((3, 3)))
    m[:3, 3] = rng.standard_normal(3)
    off = np.array([0.5, 0.4, 0.6])
    t = tload.nerf_matrix_to_ngp(m, 0.33, off)
    np.testing.assert_allclose(t, jload.nerf_matrix_to_ngp(m, 0.33, off),
                               rtol=1e-6)
    np.testing.assert_allclose(tload.ngp_matrix_to_nerf(t, 0.33, off)[:3],
                               m[:3], atol=1e-6)
