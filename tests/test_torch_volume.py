"""Parity of the port's volume engine (data/nanovdb.py, data/nanovdb_write.py,
train/volume.py, render/volume_render.py and the Testbed's volume mode)
with the JAX package's: the .nvdb bytes both ways, the grids read back,
the occupancy masks, the Woodcock walk fed the JAX key splits' draws, one
training step, a rendered frame, the Testbed's training, snapshots and
refusal to render, and the CLI on a .nvdb. A 32³ plume, a 4-level grid and
16-wide MLPs keep it fast on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngp_tpu.api.testbed import Testbed as JTestbed
from ngp_tpu.data import nanovdb as jvdb
from ngp_tpu.data import nanovdb_write as jvdbw
from ngp_tpu.render import volume_render as jrender
from ngp_tpu.train import volume as jvolume
from ngp_tpu_torch import __main__ as tcli
from ngp_tpu_torch import bridge
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.data import nanovdb as tvdb
from ngp_tpu_torch.data import nanovdb_write as tvdbw
from ngp_tpu_torch.render import volume_render as trender
from ngp_tpu_torch.train import volume as tvolume

RES, BATCH = 32, 1 << 12
E = tvolume.VolumeTrainer.N_EVENTS
# f32 arithmetic in the same order: positions and targets of the walk to
# a few ulps of their size; forward and loss as test_torch_image holds
# them (the bf16 re-rounding between MLP layers: all but MOSTLY within
# TOL, every one within BF16_TOL)
WALK_TOL, TOL, MOSTLY, BF16_TOL = 1e-5, 1e-5, 0.999, 2e-2


def tiny_config():
    with open("configs/volume/base.json") as f:
        cfg = json.load(f)
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"].update(n_neurons=16)
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 1e-2
    return cfg


@pytest.fixture(autouse=True)
def _no_jax_knobs(monkeypatch):
    for k in ("NGP_TPU_BLOCKED_LOG2_ROWS", "NGP_TPU_BLOCKED_HASH",
              "NGP_TPU_ENCODE_INT8", "NGP_TPU_GRID_IMPL"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def plume():
    d = tvdb.make_procedural_plume(RES, seed=3)
    np.testing.assert_array_equal(d, jvdb.make_procedural_plume(RES, seed=3))
    return d


def _mostly_close(got, ref):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    ok = err <= TOL + TOL * np.abs(ref)
    assert ok.mean() >= MOSTLY, (ok.mean(), err.max())
    assert err.max() <= BF16_TOL, err.max()


@pytest.mark.parametrize("origin", [(0, 0, 0), (5, 130, 7)])
def test_write_nvdb_bytes_and_read_back_match_jax(plume, origin, tmp_path):
    """Both writers give the same bytes (origins inside one lower node and
    across lower nodes); each package reads either file to the same grid:
    dense values, AABB, world↔index mapping and majorant."""
    t, j = tmp_path / "t.nvdb", tmp_path / "j.nvdb"
    tvdbw.write_nvdb(plume, t, origin=origin, voxel_size=0.5)
    jvdbw.write_nvdb(plume, j, origin=origin, voxel_size=0.5)
    assert t.read_bytes() == j.read_bytes()
    tm, _ = tvdb.read_header(t.read_bytes())
    jm, _ = jvdb.read_header(t.read_bytes())
    np.testing.assert_array_equal(tm.index_bbox, jm.index_bbox)
    for path in (t, j):
        tg, jg = tvdb.load_volume_grid(path), jvdb.load_volume_grid(path)
        np.testing.assert_array_equal(tg.dense, jg.dense)
        for k in ("aabb_min", "aabb_max", "world2index_offset",
                  "index_bbox_min"):
            np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
        assert tg.world2index_scale == jg.world2index_scale
        assert tg.global_majorant == jg.global_majorant
    # the active voxels come back where they were written
    ib = tm.index_bbox[0] - np.asarray(origin)
    tg = tvdb.load_volume_grid(t)
    sub = plume[ib[0]:ib[0] + tg.dense.shape[0],
                ib[1]:ib[1] + tg.dense.shape[1],
                ib[2]:ib[2] + tg.dense.shape[2]]
    np.testing.assert_array_equal(tg.dense, sub)


def test_occupancy_and_bitgrid_match_jax(plume):
    for off in (None, np.array([3, 0, 9])):
        tg, jg = tvdb.VolumeGrid(plume, off), jvdb.VolumeGrid(plume, off)
        np.testing.assert_array_equal(tg.occupancy_dense_128(),
                                      jg.occupancy_dense_128())
        np.testing.assert_array_equal(tg.bitgrid_128(), jg.bitgrid_128())
        assert 0 < tg.occupancy_dense_128().mean() < 1


def jax_draws(key, n: int) -> dict:
    """The draws of the JAX trainer's walk from ``key`` (the key
    ``_woodcock_targets`` is given), by its own splits
    (ngp_tpu/train/volume.py:101,118,141), as the port's
    ``woodcock_draws`` names them."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    out = {"p0": jax.random.normal(k1, (n, 3)),
           "tgt": jax.random.uniform(k2, (n, 3))}
    ev = {k: [] for k in ("u_step", "u_event", "u_jitter", "n_dir")}
    for k in jax.random.split(k3, E):
        ku, kd, kj, ks = jax.random.split(k, 4)
        ev["u_step"].append(jax.random.uniform(ku, (n,)))
        ev["u_event"].append(jax.random.uniform(kd, (n,)))
        ev["u_jitter"].append(jax.random.uniform(kj, (n, 3)))
        ev["n_dir"].append(jax.random.normal(ks, (n, 3)))
    out.update({k: jnp.stack(v) for k, v in ev.items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def pair(plume):
    """A JAX VolumeTrainer and the port's on the CPU, with the same
    parameters and EMA (the JAX initialisation)."""
    cfg = tiny_config()
    jtr = jvolume.VolumeTrainer(jvdb.VolumeGrid(plume), cfg,
                                batch_size=BATCH)
    ttr = tvolume.VolumeTrainer(tvdb.VolumeGrid(plume), cfg,
                                batch_size=BATCH, device="cpu")
    params = jax.tree.map(np.asarray, jtr.params)
    # copies: the JAX step donates its parameter and state buffers
    jtr.params = jax.tree.map(jnp.array, params)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array,
                                                           params))
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(params,
                                                     ttr.model).items():
            ttr.params[k].copy_(v)
            ttr.opt_state.ema_params[k].copy_(v)
    return cfg, jtr, ttr, params


_norm = jnp.linalg.norm


def _row_norm(x, ord=None, axis=None, keepdims=False):
    """``jnp.linalg.norm`` with the JAX walk's ``-1`` read as the axis it
    means (it is the ``ord`` argument there: a matrix norm of the batch)."""
    if ord == -1 and axis is None:
        return _norm(x, axis=-1, keepdims=keepdims)
    return _norm(x, ord, axis, keepdims)


def test_jax_walk_directions_are_not_unit(pair):
    """Why the port's walk diverges from the JAX package's as written: the
    JAX walk normalises by ``jnp.linalg.norm(d, -1, keepdims=True)``, a
    matrix norm of the batch, so its first event moves each ray a few
    hundredths of the free-flight distance the reference's unit directions
    give (tests below hold the port to the JAX walk with -1 read as the
    axis)."""
    _, jtr, ttr, _ = pair
    key = jax.random.PRNGKey(11)
    as_written = np.asarray(jtr._woodcock_targets(key, 256)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp.linalg, "norm", _row_norm)
        meant = np.asarray(jtr._woodcock_targets(key, 256)[0])
    pos, _, _ = ttr.woodcock_targets(jax_draws(key, 256))
    np.testing.assert_allclose(pos.numpy(), meant, rtol=WALK_TOL,
                               atol=WALK_TOL)
    # the span of the recorded positions along the walk
    span = np.ptp(as_written.reshape(E, 256, 3), axis=0).max(-1)
    assert np.median(span) < 0.05 * np.median(
        np.ptp(meant.reshape(E, 256, 3), axis=0).max(-1))


def test_woodcock_targets_match_jax_on_its_draws(pair, monkeypatch):
    """Fed the draws of the JAX key splits, the port's walk records the
    same vertices as the JAX walk with unit directions (``_row_norm``):
    positions and targets to a few f32 ulps, the record mask equal."""
    _, jtr, ttr, _ = pair
    monkeypatch.setattr(jnp.linalg, "norm", _row_norm)
    key = jax.random.PRNGKey(11)
    n = 512
    jpos, jtgt, jrec = (np.asarray(a) for a in jtr._woodcock_targets(key,
                                                                     n))
    pos, tgt, rec = ttr.woodcock_targets(jax_draws(key, n))
    assert pos.shape == (E * n, 3) and tgt.shape == (E * n, 4)
    np.testing.assert_array_equal(rec.numpy(), jrec)
    assert 0.05 < jrec.mean() < 0.95
    np.testing.assert_allclose(pos.numpy(), jpos, rtol=WALK_TOL,
                               atol=WALK_TOL)
    np.testing.assert_allclose(tgt.numpy(), jtgt, rtol=WALK_TOL,
                               atol=WALK_TOL)
    assert (jtgt[jrec, 3] > 0).mean() > 0.05     # the walk finds density


def test_woodcock_draws_come_from_the_generator():
    """Intended divergence: the port's draws come from its
    torch.Generator, with the shapes the walk takes."""
    a = tvolume.woodcock_draws(torch.Generator().manual_seed(5), 64, E,
                               "cpu")
    b = tvolume.woodcock_draws(torch.Generator().manual_seed(5), 64, E,
                               "cpu")
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["u_jitter"].shape == (E, 64, 3) and a["p0"].shape == (64, 3)


def test_training_step_matches_jax(pair, monkeypatch):
    """One step of each on the same walk (the JAX step's own key splits,
    its directions unit as in ``test_woodcock_targets_match_jax_on_its_
    draws``): the loss, and the Adam-updated parameters (as
    test_torch_image holds them: all but MOSTLY within 1e-6, every entry
    within 2·lr)."""
    _, jtr, ttr, params = pair
    monkeypatch.setattr(jnp.linalg, "norm", _row_norm)
    key = jax.random.PRNGKey(7)              # the JAX trainer's step key
    walk_key, _ = jax.random.split(key)
    t_loss = float(ttr.step(jax_draws(walk_key, BATCH // E)))
    j_loss = jtr.train(1)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    lr = ttr.opt_cfg.learning_rate
    got = bridge.encoded_params_to_numpy(ttr.params, ttr.model)
    ref = jax.tree.map(np.asarray, jtr.params)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        err = np.abs(g - r)
        assert (err <= 1e-6).mean() >= MOSTLY
        assert err.max() <= 2 * lr + 1e-6
    moved_t = got["encoding"] != params["encoding"]
    moved_j = ref["encoding"] != params["encoding"]
    np.testing.assert_array_equal(moved_t, moved_j)
    assert moved_t.any()


def _camera():
    """NGP camera→world (x right, y down, z forward) looking at the
    volume's centre from outside it."""
    fwd = np.array([0.6, 0.7, 0.3])
    fwd /= np.linalg.norm(fwd)
    eye = 0.5 - 1.6 * fwd
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd, eye],
                    axis=1).astype(np.float32)


def test_render_matches_jax(pair):
    """A 16×16 frame of 12 march steps on the same inference parameters
    (the table drawn at std 0.5, so the field has density): rgb and
    opacity as the forward is held; some rays see the plume."""
    _, jtr, ttr, _ = pair
    jp = bridge.encoded_params_to_numpy(ttr.inference_params(), ttr.model)
    jp["encoding"] = (np.random.default_rng(8).standard_normal(
        jp["encoding"].shape) * 0.5).astype(np.float32)
    with torch.no_grad():
        for k, v in bridge.encoded_params_from_numpy(jp, ttr.model).items():
            ttr.params[k].copy_(v)
            ttr.opt_state.ema_params[k].copy_(v)
    jtr.params = jax.tree.map(jnp.array, jp)
    jtr.state = jtr.state._replace(ema_params=jax.tree.map(jnp.array, jp))
    opts = dict(n_steps=12, chunk=128, focal=20.0)
    got = trender.VolumeRenderer(ttr, trender.VolumeRenderOptions(
        **opts)).render(_camera(), 16, 16)
    ref = jrender.VolumeRenderer(jtr, jrender.VolumeRenderOptions(
        **opts)).render(_camera(), 16, 16)
    assert got.shape == ref.shape == (16, 16, 4)
    _mostly_close(got, ref)
    assert np.isfinite(got).all() and 0 <= got[..., 3].min()
    assert got[..., 3].max() <= 1 and (got[..., 3] > 1e-3).mean() > 0.05
    dirs = np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        tvolume.sky_color(torch.from_numpy(dirs), ttr.sun_dir).numpy(),
        np.asarray(jvolume.sky_color(jnp.asarray(dirs), ttr.sun_dir)),
        rtol=1e-6, atol=1e-7)


def test_testbed_trains_snapshots_and_reloads(plume, tmp_path):
    """Testbed("volume") on a .nvdb: trains exactly n steps, saves a
    snapshot the JAX testbed loads and a new port Testbed restores
    bit for bit; ``render`` raises ValueError as the JAX testbed's
    does."""
    path = tmp_path / "plume.nvdb"
    tvdbw.write_nvdb(plume, path)
    net = tmp_path / "tiny.json"
    net.write_text(json.dumps(tiny_config()))
    tb = Testbed("volume", device="cpu")
    tb.training_batch_size = BATCH
    tb.reload_network_from_file(net)
    tb.load_training_data(path)
    loss = tb.train(3)
    assert tb.training_step == 3 and np.isfinite(loss)
    tb.save_snapshot(tmp_path / "v.msgpack")
    other = Testbed("volume", device="cpu")
    other.training_batch_size = BATCH
    other.reload_network_from_file(net)
    other.load_training_data(path)
    other.load_snapshot(tmp_path / "v.msgpack")
    assert other.training_step == 3
    for k, v in tb.trainer.params.items():
        torch.testing.assert_close(other.trainer.params[k], v, rtol=0,
                                   atol=0)
    jtb = JTestbed("volume")
    jtb.training_batch_size = BATCH
    jtb.reload_network_from_file(str(net))
    jtb.load_training_data(str(path))
    jtb.load_snapshot(str(tmp_path / "v.msgpack"))
    np.testing.assert_array_equal(
        np.asarray(jtb.trainer.params["encoding"]),
        tb.trainer.params["encoding.table"].detach().numpy())
    with pytest.raises(ValueError, match="render"):
        jtb.render(8, 8)
    with pytest.raises(ValueError, match="render"):
        tb.render(8, 8)
    with pytest.raises(ValueError, match="render"):
        tb.screenshot(tmp_path / "s.png", 8, 8)


def test_cli_infers_volume_mode_from_nvdb(plume, tmp_path, capsys):
    path = tmp_path / "plume.nvdb"
    tvdbw.write_nvdb(plume, path)
    net = tmp_path / "tiny.json"
    net.write_text(json.dumps(tiny_config()))
    snap = tmp_path / "cli.msgpack"
    assert tcli.main(["--scene", str(path), "--network", str(net),
                      "--n_steps", "2", "--batch_size", str(BATCH),
                      "--device", "cpu", "--save_snapshot", str(snap)]) == 0
    out = capsys.readouterr().out
    assert "iteration=2 " in out
    tb = Testbed("volume", device="cpu")
    tb.training_batch_size = BATCH
    tb.reload_network_from_file(net)
    tb.load_training_data(path)
    tb.load_snapshot(snap)
    assert tb.training_step == 2 and tb.trainer.grid.dense.shape[0] > 0
    assert isinstance(tb.trainer, tvolume.VolumeTrainer)
