"""The training slice as a whole, on the CPU path: ``train(n)`` runs exactly
n steps across a grid boundary, a snapshot the port's trainer writes loads
into the JAX ``NerfTrainer`` and renders there as it renders in the port,
and a short run on the analytic sphere lowers the loss."""
import numpy as np
import pytest
import torch

import ngp_tpu.train.nerf as jnerf
import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu.opt.optimizers import inference_params as j_inference_params
from ngp_tpu.render.nerf_render import NerfRenderer as JRenderer
from ngp_tpu.render.nerf_render import RenderOptions as JOptions
from ngp_tpu_torch.render.nerf_render import NerfRenderer as TRenderer
from ngp_tpu_torch.render.nerf_render import RenderOptions as TOptions
from test_torch_train_step import FOCAL, RES, sphere_scene

TRAIN_KW = dict(n_rays=256, adapt_rays=False, dynamic_rays=True,
                target_batch_size=1 << 15,
                sample_image_proportional_to_error=True,
                sample_focal_plane_proportional_to_error=True,
                grid_int8=True)
OPTS = dict(width=RES, height=RES, fov_axis_focal=FOCAL, chunk=256,
            march_steps=1024, background=(0.0, 0.0, 0.0, 0.0),
            linear_out=True)
# the squared error of a rendered training view after 64 steps is below
# this fraction of that after 20 (0.75 in the run this margin was set
# from: 18.00 dB → 19.25 dB). The per-step loss is no measure of progress
# here: it averages over the rays that have samples, and the grid culls
# the easy, empty rays from that set as it learns.
MSE_DROP = 0.85


def _view_mse(tr, ds, view=0):
    img = TRenderer.for_trainer(tr, TOptions(**OPTS)).render(
        tr.inference_params(), tr.grid.bitfield, ds.xforms[view], RES, RES,
        focal=(FOCAL, FOCAL), spp=1).numpy()
    return float(np.mean((img[..., :3] - ds.images[view][..., :3]) ** 2))


@pytest.fixture(scope="module")
def trained():
    """The sphere scene at aabb_scale 1, trained 20 steps and then 44
    more, with the squared error of a training view after each call."""
    ds, cfg = sphere_scene(n_images=8, aabb_scale=1)
    tr = tnerf.NerfTrainer(ds, cfg, seed=3, device="cpu",
                           tcfg=tnerf.NerfTrainerConfig(**TRAIN_KW))
    loss = [tr.train(20)]
    state = dict(step=tr.training_step, ema_step=tr.grid.ema_step,
                 adam_step=tr.opt_state.step)
    mse = [_view_mse(tr, ds)]
    loss.append(tr.train(44))
    mse.append(_view_mse(tr, ds))
    return dict(ds=ds, cfg=cfg, tr=tr, loss=loss, mse=mse, state=state)


def test_train_runs_exactly_n_steps(trained):
    """Intended divergence: the JAX trainer runs ``train(20)`` on to step
    32, the next grid boundary; the port runs 20 steps. The grid was swept
    at steps 0 and 16, and every step updated the optimizer."""
    assert trained["state"] == dict(step=20, ema_step=2, adam_step=20)
    tr = trained["tr"]
    assert tr.training_step == 64 and tr.grid.ema_step == 4
    assert tr._n_live <= tr.tcfg.n_rays


def test_short_run_lowers_the_loss(trained):
    (m0, m1), loss = trained["mse"], trained["loss"]
    print(f"training view: {-10 * np.log10(m0):.2f} dB after 20 steps, "
          f"{-10 * np.log10(m1):.2f} dB after 64; step losses {loss}")
    assert np.isfinite(loss).all() and m1 < MSE_DROP * m0
    tr = trained["tr"]
    inside, outside = tr.density_at(np.array([[0.5, 0.5, 0.5],
                                              [0.5, 0.5, 0.95]]))
    assert inside > outside


def test_port_snapshot_renders_in_jax_as_in_the_port(trained, tmp_path):
    """The port writes a snapshot with its optimizer state; the JAX trainer
    and a fresh port trainer load it, and the two renders of a training
    view with the EMA parameters agree (mean |Δ| ≤ 2e-4, as the render
    slice's test)."""
    tr, ds, cfg = trained["tr"], trained["ds"], trained["cfg"]
    path = tmp_path / "port.msgpack"
    tr.save_snapshot(path, cfg, include_optimizer_state=True)

    jtr = jnerf.NerfTrainer(ds, cfg, tcfg=jnerf.NerfTrainerConfig(
        n_rays=256, adapt_rays=False))
    jtr.load_snapshot_state(path)
    assert jtr.training_step == 64 and int(jtr.opt_state.step) == 64
    np.testing.assert_array_equal(
        np.asarray(jtr.opt_state.nu["pos_encoding"]),
        tr.opt_state.nu["pos_encoding.table"].numpy())
    back = tnerf.NerfTrainer(ds, cfg, device="cpu",
                             tcfg=tnerf.NerfTrainerConfig(n_rays=256,
                                                          adapt_rays=False))
    back.load_snapshot_state(path)
    assert back.opt_state.step == 64
    for k, v in tr.params.items():
        assert torch.equal(back.params[k], v), k
    np.testing.assert_array_equal(back.grid.bitfield.numpy(),
                                  np.asarray(jtr.grid.bitfield))

    pts = np.random.default_rng(4).random((512, 3)).astype(np.float32)
    np.testing.assert_allclose(back.density_at(pts), jtr.density_at(pts),
                               rtol=1e-4, atol=1e-6)

    cam = ds.xforms[1]
    ref = JRenderer.for_trainer(jtr, JOptions(**OPTS)).render(
        j_inference_params(jtr.params, jtr.opt_state, jtr.opt_cfg),
        jtr.grid.bitfield, cam, RES, RES, focal=(FOCAL, FOCAL), spp=1)
    got = TRenderer.for_trainer(back, TOptions(**OPTS)).render(
        back.inference_params(), back.grid.bitfield, cam, RES, RES,
        focal=(FOCAL, FOCAL), spp=1).numpy()
    err = np.abs(got - np.asarray(ref))
    print(f"render: mean |Δ| {err.mean():.3e}, max {err.max():.3e}; mean "
          f"opacity {got[..., 3].mean():.3f}")
    assert np.isfinite(got).all() and got[..., 3].mean() > 0.02
    assert err.mean() <= 2e-4
