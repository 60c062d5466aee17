"""Parity of the port's image engine (ngp_tpu_torch/train/image.py) with the
JAX package's: the image lookup in all four modes, a training step on
deterministic (Halton) positions, rendering, the MSE, generic snapshots in
both directions and the encoded reference-snapshot codec. Parameters go
from the JAX trainer to the port's through bridge.py; a small config (4
levels, 16-wide MLP) and a 48 × 40 image keep it fast on the CPU."""
import copy

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from ngp_tpu.config import load_network_config as j_load
from ngp_tpu.io import snapshot as jsnap
from ngp_tpu.train import image as jimage
from ngp_tpu_torch import bridge
from ngp_tpu_torch.config import autofill_hashgrid_config as t_autofill
from ngp_tpu_torch.io import snapshot as tsnap
from ngp_tpu_torch.nn.models import EncodedNetwork as TEncodedNetwork
from ngp_tpu_torch.train import image as timage

W, H, BATCH = 48, 40, 1 << 12
# forward and loss: f32 sums in another order; the bf16 re-rounding
# between MLP layers moves a few outputs by a bf16 ulp (as in
# test_torch_encoded_network), so all but MOSTLY meet TOL
TOL, MOSTLY, BF16_TOL = 1e-5, 0.999, 2e-2


def small_config():
    cfg = j_load("configs/image/base.json")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"].update(n_neurons=16)
    return cfg


def synth_image():
    """A linear float RGBA image: smooth gradients, a hard-edged disc and
    a fine grating."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W, 4), np.float32)
    img[..., 0] = x / W
    img[..., 1] = y / H
    img[..., 2] = 0.5 + 0.5 * np.sin(x * 1.3)
    disc = (x - 20) ** 2 + (y - 18) ** 2 < 64
    img[disc, :3] = [0.9, 0.1, 0.2]
    img[..., 3] = 1.0
    return img


def _mostly_close(got, ref):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    ok = err <= TOL + TOL * np.abs(ref)
    assert ok.mean() >= MOSTLY, (ok.mean(), err.max())
    assert err.max() <= BF16_TOL, err.max()


@pytest.fixture(scope="module")
def pair():
    """A JAX ImageTrainer with a seeded table (well above tcnn's init) and
    the port's on the CPU with the same parameters, both in Halton mode."""
    cfg = small_config()
    img = synth_image()
    jtr = jimage.ImageTrainer(img, cfg, batch_size=BATCH)
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jtr.params)
    params["encoding"] = (rng.standard_normal(params["encoding"].shape)
                          * 0.3).astype(np.float32)
    # copies: the JAX step donates its parameter and state buffers
    jtr.params = jax.tree.map(jnp.array, params)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array,
                                                           params))
    ttr = timage.ImageTrainer(img, cfg, batch_size=BATCH, device="cpu")
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(params,
                                                     ttr.model).items():
            ttr.params[k].copy_(v)
            ttr.opt_state.ema_params[k].copy_(v)
    for tr in (jtr, ttr):
        tr.random_mode = "halton"
    return cfg, img, jtr, ttr


@pytest.mark.parametrize("snap", [False, True])
@pytest.mark.parametrize("linear", [False, True])
def test_eval_image_matches_jax(snap, linear):
    img = synth_image()
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.random((4000, 2), dtype=np.float32),
                          np.array([[0, 0], [1 - 1e-7, 1 - 1e-7],
                                    [0.5, 0.5]], np.float32)])
    got, got_pos = timage._eval_image(torch.from_numpy(img[..., :3]),
                                      torch.from_numpy(pos), snap, linear)
    ref, ref_pos = jimage._eval_image(jnp.asarray(img[..., :3]),
                                      jnp.asarray(pos), snap, linear)
    # the same f32 operations in the same order: the bilinear sum to an
    # ulp of its terms, the snapped positions exactly
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(ref_pos))


def test_training_step_matches_jax(pair):
    """One step of each on the same Halton positions: the loss, and the
    Adam-updated parameters (the first Adam step moves each parameter by
    about lr · sign(g), so entries whose gradient is at the rounding level
    of the sums may step the other way: all but MOSTLY match to 1e-6,
    every one within 2·lr, and the table entries no sample touched stay
    untouched in both)."""
    cfg, img, jtr, ttr = pair
    j0 = copy.deepcopy(jax.tree.map(np.asarray, jtr.params))
    pos = ttr.sample_batch()
    np.testing.assert_array_equal(pos.numpy(), np.asarray(
        jimage.sample_positions("halton", None, BATCH, 0)))
    t_loss = float(ttr.step(pos))
    j_loss = jtr.train(1)
    assert ttr.training_step == jtr.training_step == 1
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    lr = ttr.opt_cfg.learning_rate
    got = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    ref = jax.tree.map(np.asarray, jtr.params)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        err = np.abs(g - r)
        assert (err <= 1e-6).mean() >= MOSTLY
        assert err.max() <= 2 * lr + 1e-6
    moved_t = got["encoding"] != j0["encoding"]
    moved_j = ref["encoding"] != j0["encoding"]
    np.testing.assert_array_equal(moved_t, moved_j)
    assert 0.01 < moved_t.mean() < 0.99


def test_render_and_mse_match_jax(pair):
    cfg, img, jtr, ttr = pair
    for linear in (True, False):
        _mostly_close(ttr.render(W // 2, H // 2, linear=linear),
                      jtr.render(W // 2, H // 2, linear=linear))
    for q in (False, True):
        np.testing.assert_allclose(ttr.compute_mse(q), jtr.compute_mse(q),
                                   rtol=1e-4)
    np.testing.assert_allclose(ttr.psnr(), jtr.psnr(), rtol=1e-5)


def test_train_runs_exactly_n_steps_and_learns():
    """``train(n)`` takes n steps (the JAX image trainer does too); a short
    stratified fit lowers the MSE."""
    cfg = small_config()
    tr = timage.ImageTrainer(synth_image(), cfg, batch_size=BATCH,
                             device="cpu")
    mse0 = tr.compute_mse()
    loss = tr.train(24)
    assert tr.training_step == 24 and np.isfinite(loss)
    assert tr.compute_mse() < 0.5 * mse0


def test_stratified_draws_come_from_the_generator():
    """Intended divergence: the stratified draws come from the trainer's
    torch.Generator, so one seed repeats them and another does not."""
    cfg = small_config()
    a, b, c = (timage.ImageTrainer(synth_image(), cfg, seed=s,
                                   batch_size=BATCH, device="cpu")
               for s in (3, 3, 4))
    pa, pb, pc = a.sample_batch(), b.sample_batch(), c.sample_batch()
    torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert not torch.equal(pa, pc)


def test_snapshots_load_in_either_package(pair, tmp_path):
    cfg, img, jtr, ttr = pair
    # the port's snapshot in the JAX package's loader
    ttr.training_step = 5
    ttr.save_snapshot(tmp_path / "t.msgpack", cfg)
    doc = jsnap.load_snapshot(tmp_path / "t.msgpack")
    want = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    for key in ("ngp_tpu_params", "ngp_tpu_ema_params"):
        got = doc["snapshot"][key]
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert doc["snapshot"]["training_step"] == 5
    # a JAX snapshot in the port's trainer
    other = timage.ImageTrainer(img, cfg, batch_size=BATCH, device="cpu")
    jparams = jax.tree.map(np.asarray, jtr.params)
    jsnap.save_snapshot(tmp_path / "j.msgpack", cfg, params=jparams,
                        ema_params=jparams, training_step=9)
    other.load_snapshot_state(tmp_path / "j.msgpack")
    assert other.training_step == 9
    for k, v in bridge.encoded_params_from_numpy(jparams,
                                                 other.model).items():
        torch.testing.assert_close(other.params[k].detach(), v, rtol=0,
                                   atol=0)


def _tcnn_image_network(cfg):
    enc = t_autofill(cfg["encoding"], 2, max(W, H) / 2)
    return TEncodedNetwork(2, 3, enc, cfg["network"], grid_impl="tcnn",
                           generator=torch.Generator().manual_seed(0))


def test_encoded_reference_snapshot_codec_matches_jax(tmp_path, monkeypatch):
    cfg = small_config()
    model = _tcnn_image_network(cfg)
    tree = bridge.encoded_params_to_numpy(dict(model.named_parameters()),
                                          model)
    tree["encoding"] = np.random.default_rng(4).standard_normal(
        tree["encoding"].shape).astype(np.float32) * 0.1
    res = max(W, H) / 2.0
    tsnap.export_reference_snapshot_encoded(tmp_path / "t.msgpack", cfg,
                                            tree, 2, 3, res)
    jsnap.export_reference_snapshot_encoded(tmp_path / "j.msgpack", cfg,
                                            tree, 2, 3, res)
    assert (tmp_path / "t.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    _, jtree, _ = jsnap.import_reference_snapshot_encoded(
        tmp_path / "t.msgpack", 2, 3, res)
    _, ttree, snap = tsnap.import_reference_snapshot_encoded(
        tmp_path / "j.msgpack", 2, 3, res)
    assert snap["params_type"] == "__half"
    for a, b in zip(jax.tree.leaves(ttree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    # fp16 round trip of the exported values; the tree loads into the model
    np.testing.assert_allclose(ttree["encoding"], tree["encoding"],
                               rtol=1e-3, atol=1e-4)
    assert set(bridge.encoded_params_from_numpy(ttree, model)) == \
        set(dict(model.named_parameters()))


def test_encoded_importer_reads_params_type(tmp_path):
    """Intended divergence: the port decodes params_binary by params_type
    (f32 for "float"); the JAX importer decodes fp16 always."""
    cfg = small_config()
    model = _tcnn_image_network(cfg)
    tree = bridge.encoded_params_to_numpy(dict(model.named_parameters()),
                                          model)
    res = max(W, H) / 2.0
    tsnap.export_reference_snapshot_encoded(tmp_path / "h.msgpack", cfg,
                                            tree, 2, 3, res)
    doc = msgpack.unpackb((tmp_path / "h.msgpack").read_bytes(), raw=False)
    snap = doc["snapshot"]
    flat = np.frombuffer(snap["params_binary"], np.float16).astype(
        np.float32)
    snap.update(params_type="float", params_binary=flat.tobytes())
    (tmp_path / "f.msgpack").write_bytes(msgpack.packb(doc,
                                                       use_bin_type=True))
    _, half, _ = tsnap.import_reference_snapshot_encoded(
        tmp_path / "h.msgpack", 2, 3, res)
    _, full, _ = tsnap.import_reference_snapshot_encoded(
        tmp_path / "f.msgpack", 2, 3, res)
    for a, b in zip(jax.tree.leaves(full), jax.tree.leaves(half)):
        np.testing.assert_array_equal(a, b)
    del snap["params_type"]      # absent reads as fp16
    (tmp_path / "n.msgpack").write_bytes(msgpack.packb(
        dict(doc, snapshot=dict(snap, params_binary=flat.astype(
            np.float16).tobytes())), use_bin_type=True))
    _, none, _ = tsnap.import_reference_snapshot_encoded(
        tmp_path / "n.msgpack", 2, 3, res)
    np.testing.assert_array_equal(none["encoding"], half["encoding"])
    snap["params_type"] = "bfloat16"
    (tmp_path / "b.msgpack").write_bytes(msgpack.packb(doc,
                                                       use_bin_type=True))
    with pytest.raises(ValueError, match="params_type"):
        tsnap.import_reference_snapshot_encoded(tmp_path / "b.msgpack", 2,
                                                3, res)
