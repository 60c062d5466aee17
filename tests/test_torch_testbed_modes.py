"""The port's user surface in image and SDF mode against the JAX
package's: the ``Testbed`` of both on a PNG and a torus OBJ written to
disk, on the CPU at a tiny size (4 levels, 16-wide MLPs, batches of 2^12,
frames of 16 × 12); then the port's CLI and runner with ``--mode image``
and ``--mode sdf`` and ``--device cpu``.

Parameters move between the two testbeds as the pyngp ``params`` vector
(image: no EMA) or by snapshot (SDF: the EMA renders). Frames and metrics
of the same parameters: the bf16 tolerances of test_torch_image and
test_torch_sdf. ``train(n)`` runs exactly n steps in both packages in
these modes. Intended divergence: ``testbed.image.random_mode`` and
``testbed.sdf.mesh_sdf_mode`` take effect at every ``train`` call in the
port; the JAX testbed reads neither after building its trainer."""
import json
import re

import numpy as np
import pytest
import torch
from PIL import Image

from ngp_tpu.api.testbed import Testbed as JTestbed
from ngp_tpu.io.snapshot import load_snapshot as j_load_snapshot
from ngp_tpu_torch import __main__ as cli
from ngp_tpu_torch import run
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.train.image import ImageTrainer
from ngp_tpu_torch.train.sdf import SdfTrainer
from test_torch_image import small_config as image_config
from test_torch_image import synth_image
from test_torch_sdf import private_jax_bvh
from test_torch_sdf import small_config as sdf_config
from test_torch_sdf import write_torus_obj

BATCH = 1 << 12
FW, FH = 16, 12
CAMERA = np.array([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, -0.6]],
                  np.float32)


@pytest.fixture(scope="module", autouse=True)
def _jax_bvh(tmp_path_factory):
    private_jax_bvh(tmp_path_factory.mktemp("jax_bvh"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    img = synth_image()
    rgb = np.clip(img[..., :3], 0, 1) ** (1 / 2.2)
    Image.fromarray(np.round(rgb * 255).astype(np.uint8)).save(
        root / "image.png")
    write_torus_obj(root / "torus.obj")
    (root / "image.json").write_text(json.dumps(image_config()))
    (root / "sdf.json").write_text(json.dumps(sdf_config()))
    return root


def _testbeds(files, mode, scene, **ns):
    """The JAX and the port's Testbed (CPU) on ``scene`` with the tiny
    config; ``ns`` sets knobs of the mode's namespace first."""
    out = []
    for tb in (JTestbed(mode), Testbed(mode, device="cpu")):
        tb.training_batch_size = BATCH
        for k, v in ns.items():
            setattr(getattr(tb, mode), k, v)
        tb.reload_network_from_file(files / f"{mode}.json")
        tb.load_training_data(files / scene)
        out.append(tb)
    return out


def _mostly_close(got, ref, tol=1e-5, mostly=0.999, bf16=2e-2):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= tol + tol * np.abs(ref)).mean() >= mostly, err.max()
    assert err.max() <= bf16


def test_image_testbed_matches_jax(files, tmp_path):
    jtb, tb = _testbeds(files, "image", "image.png")
    assert tb.mode.value == "image" and tb.trainer.resolution == (48, 40)
    assert tb.n_params() == jtb.n_params()
    assert tb.n_encoding_params() == jtb.n_encoding_params()
    tb.params = jtb.params
    np.testing.assert_array_equal(tb.params, jtb.params)
    for linear in (True, False):
        _mostly_close(tb.render(FW, FH, linear=linear),
                      jtb.render(FW, FH, linear=linear))
    for q in (False, True):
        np.testing.assert_allclose(tb.compute_image_mse(q),
                                   jtb.compute_image_mse(q), rtol=1e-4)
    # the namespace's random mode takes effect (halton: the same batches in
    # both, which the JAX trainer is given directly)
    tb.image.random_mode = "halton"
    jtb.trainer.random_mode = "halton"
    t_loss, j_loss = tb.train(3), jtb.train(3)
    assert tb.trainer.random_mode == "halton"
    assert tb.training_step == jtb.training_step == 3
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert len(tb.gather_histograms()) == 4
    # snapshots both ways
    tb.save_snapshot(tmp_path / "t.msgpack")
    other = JTestbed("image")
    other.training_batch_size = BATCH
    other.reload_network_from_file(files / "image.json")
    other.load_training_data(files / "image.png")
    other.load_snapshot(tmp_path / "t.msgpack")
    assert other.training_step == 3
    np.testing.assert_array_equal(other.params, tb.params)
    jtb.save_snapshot(tmp_path / "j.msgpack")
    tb.load_snapshot(tmp_path / "j.msgpack")
    np.testing.assert_array_equal(tb.params, jtb.params)
    shot = tmp_path / "shot.png"
    tb.screenshot(shot, FW, FH)
    assert np.asarray(Image.open(shot)).shape == (FH, FW, 4)


def test_sdf_testbed_matches_jax(files, tmp_path):
    jtb, tb = _testbeds(files, "sdf", "torus.obj", mesh_sdf_mode=0)
    assert tb.trainer.sign_mode == jtb.trainer.sign_mode == 0
    assert tb.sdf.mesh_scale == jtb.sdf.mesh_scale
    jtb.train(2)
    assert jtb.training_step == 2
    jtb.save_snapshot(tmp_path / "j.msgpack")
    tb.load_snapshot(tmp_path / "j.msgpack")
    assert tb.training_step == 2
    for t in (tb, jtb):
        t.set_camera_matrix(CAMERA)
    got, ref = tb.render(FW, FH), jtb.render(FW, FH)
    assert got.shape == ref.shape == (FH, FW, 4)
    assert (got[..., 3] == ref[..., 3]).mean() >= 0.99
    assert float(np.abs(got - ref).mean()) <= 1e-3
    tb.sdf.analytic_normals = True
    np.testing.assert_array_equal(tb.render(FW, FH)[..., 3], got[..., 3])
    np.testing.assert_allclose(tb.calculate_iou(1 << 14),
                               jtb.calculate_iou(1 << 14), atol=2e-3)
    # the namespace's sign mode takes effect at the next train call
    tb.sdf.mesh_sdf_mode = 1
    tb.train(1)
    assert tb.trainer.sign_mode == 1 and tb.training_step == 3
    tb.save_snapshot(tmp_path / "t.msgpack")
    assert j_load_snapshot(tmp_path / "t.msgpack")["snapshot"][
        "training_step"] == 3


def test_override_sdf_training_data_matches_jax(files):
    jtb, tb = _testbeds(files, "sdf", "torus.obj")
    rng = np.random.default_rng(0)
    pts = rng.random((300, 3), dtype=np.float32)
    dist = rng.standard_normal(300).astype(np.float32)
    for t in (tb, jtb):
        t.override_sdf_training_data(pts, dist)
    for _ in range(2):
        (tp, td), (jp, jd) = (tb.trainer.generate_training_batch(),
                              jtb.trainer.generate_training_batch())
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(td, jd)
    assert tp.shape == (BATCH, 3)
    tb.train(2)
    assert tb.training_step == 2


def _iterations(out):
    """The steps of the ``iteration=`` lines (the runner's end with a
    rate)."""
    return [int(m[0]) for m in re.findall(
        r"^iteration=(\d+) loss=[\d.e+-]+( \(\S+ steps/s\))?$", out,
        re.M)]


def test_cli_and_runner_in_image_and_sdf_mode(files, tmp_path, capsys,
                                              monkeypatch):
    snap, shot = tmp_path / "cli.msgpack", tmp_path / "cli.png"
    cli.main(["--scene", str(files / "image.png"), "--network",
              str(files / "image.json"), "--n_steps", "6", "--batch_size",
              str(BATCH), "--save_snapshot", str(snap), "--screenshot",
              str(shot), "--width", str(FW), "--height", str(FH),
              "--device", "cpu"])
    assert _iterations(capsys.readouterr().out) == [1, 2, 3, 4, 5, 6]
    assert np.asarray(Image.open(shot)).shape == (FH, FW, 4)
    jtb = JTestbed("image")
    jtb.training_batch_size = BATCH
    jtb.reload_network_from_file(files / "image.json")
    jtb.load_training_data(files / "image.png")
    jtb.load_snapshot(snap)
    assert jtb.training_step == 6
    # the runner in SDF mode, the mode given; screenshots at the cameras of
    # a transforms file
    (tmp_path / "cams.json").write_text(json.dumps({"frames": [
        {"file_path": "view", "transform_matrix": np.eye(4).tolist()}]}))
    monkeypatch.setenv("NGP_TPU_TESTBED_BATCH", str(BATCH))
    common = ["--mode", "sdf", "--scene", str(files / "torus.obj"),
              "--network", str(files / "sdf.json"), "--device", "cpu"]
    run.main(common + ["--n_steps", "4", "--save_snapshot",
                       str(tmp_path / "run.msgpack"),
                       "--screenshot_transforms", str(tmp_path / "cams.json"),
                       "--screenshot_dir", str(tmp_path / "shots"),
                       "--screenshot_spp", "1", "--width", str(FW),
                       "--height", str(FH)])
    out = capsys.readouterr().out
    assert _iterations(out) == [1, 2, 3, 4]
    assert np.asarray(Image.open(tmp_path / "shots" / "view.png")).shape \
        == (FH, FW, 4)
    assert j_load_snapshot(tmp_path / "run.msgpack")["snapshot"][
        "training_step"] == 4
    # the SDF's mesh from the snapshot, by marching tetrahedra
    assert run.main(common + ["--load_snapshot",
                              str(tmp_path / "run.msgpack"), "--save_mesh",
                              str(tmp_path / "m.obj"),
                              "--marching_cubes_res", "24"]) == 0
    m = re.search(r"^saved mesh \((\d+) verts, (\d+) faces\) to ",
                  capsys.readouterr().out, re.M)
    assert m and (tmp_path / "m.obj").exists()


def test_image_and_sdf_entry_points_default_to_the_card(files):
    """Without CUDA, and without an explicit CPU device, each entry point
    raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the entry points would run there")
    for mode in ("image", "sdf"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Testbed(mode)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageTrainer(synth_image(), image_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        SdfTrainer(files / "torus.obj", sdf_config())
    for main, args in ((cli.main, ["--scene", str(files / "image.png")]),
                       (run.main, ["--mode", "sdf", "--scene",
                                   str(files / "torus.obj")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args + ["--n_steps", "0"])
