"""Parity of the port's optimizer stack and NeRF losses with the JAX
package: Ema(ExponentialDecay(Adam)) over several steps of seeded
gradients, the config parser, and the seven per-element losses with their
gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ngp_tpu.opt.losses as jlosses
import ngp_tpu.opt.optimizers as jopt
import ngp_tpu_torch.opt.losses as tlosses
import ngp_tpu_torch.opt.optimizers as topt
from ngp_tpu.common import LossType as JLossType
from ngp_tpu.config import load_network_config
from ngp_tpu_torch.common import (LOSS_SCALE, LossType, linear_to_srgb,
                                  linear_to_srgb_np, loss_type_from_str,
                                  mse2psnr, srgb_to_linear_np)


def test_adam_config_from_base_json_matches_jax():
    cfg = load_network_config("configs/nerf/base.json")["optimizer"]
    t = topt.AdamConfig.from_config(cfg, loss_scale=LOSS_SCALE)
    j = jopt.AdamConfig.from_config(cfg, loss_scale=LOSS_SCALE)
    for f in ("learning_rate", "beta1", "beta2", "epsilon", "l2_reg",
              "decay_start", "decay_interval", "decay_base", "decay_end",
              "ema_decay", "loss_scale", "skip_zero_grad"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.ema_decay, t.decay_start, t.decay_base) == (0.95, 20000, 0.33)
    for step in (1, 19999, 20000, 29999, 30000, 95000):
        assert float(topt.lr_at_step(t, step)) == float(
            jopt.lr_at_step(j, jnp.int32(step))), step


def test_apply_update_matches_jax_over_five_steps():
    """Five steps of seeded gradients with exact zeros in the table and an
    ExponentialDecay that starts inside the window: parameters, moments
    and EMA to rtol 1e-6 each step."""
    kw = dict(learning_rate=1e-2, beta1=0.9, beta2=0.99, epsilon=1e-15,
              l2_reg=1e-6, decay_start=2, decay_interval=2, decay_base=0.33,
              ema_decay=0.95, loss_scale=LOSS_SCALE)
    t_cfg, j_cfg = topt.AdamConfig(**kw), jopt.AdamConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"pos_encoding.table": (4, 16, 128), "density_net.w0": (32, 64),
              "rgb_net.w1": (64, 16)}
    matrix = {"density_net.w0", "rgb_net.w1"}
    p0 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in shapes.items()}
    t_params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    t_state = topt.init_state(t_params)
    j_params = {k: jnp.asarray(v) for k, v in p0.items()}
    j_state = jopt.init_state(j_params, j_cfg)
    j_mask = {k: k in matrix for k in shapes}
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * LOSS_SCALE * 1e-3).astype(
            np.float32) for k, s in shapes.items()}
        tbl = grads["pos_encoding.table"]
        tbl[rng.random(tbl.shape) < 0.5] = 0.0         # rows not hit
        t_state = topt.apply_update(
            t_params, {k: torch.from_numpy(v) for k, v in grads.items()},
            t_state, t_cfg, matrix)
        j_params, j_state = jopt.apply_update(
            j_params, {k: jnp.asarray(v) for k, v in grads.items()},
            j_state, j_cfg, j_mask)
        assert t_state.step == int(j_state.step) == step + 1
        for got, want in [(t_params, j_params), (t_state.mu, j_state.mu),
                          (t_state.nu, j_state.nu),
                          (t_state.ema_params, j_state.ema_params)]:
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-9, err_msg=f"{step} {k}")
    assert topt.inference_params(t_params, t_state, t_cfg) is t_state.ema_params


def test_zero_gradient_entries_freeze():
    cfg = topt.AdamConfig(loss_scale=1.0)
    params = {"table": torch.ones(8), "w": torch.ones(8)}
    state = topt.init_state(params)
    g = torch.tensor([0.0, 1.0] * 4)
    state = topt.apply_update(params, {"table": g, "w": g}, state, cfg,
                              {"w"})
    assert torch.equal(params["table"][::2], torch.ones(4))
    assert torch.equal(state.mu["table"][::2], torch.zeros(4))
    assert (params["table"][1::2] < 1).all() and (params["w"] < 1).all()


@pytest.mark.parametrize("loss", list(LossType), ids=lambda t: t.value)
def test_nerf_losses_and_gradients_match_jax(loss):
    """Per-element loss and d/d(pred), normalisers held constant."""
    rng = np.random.default_rng(1)
    target = rng.random((512, 3)).astype(np.float32)
    pred = (target + rng.standard_normal((512, 3)) * 0.2).astype(np.float32)
    pred[:8] = target[:8] + 0.05          # inside Huber's 0.1 knee
    assert loss_type_from_str(loss.value) == loss
    t_fn = tlosses.loss_fn(loss)
    j_fn = jlosses.loss_fn(JLossType(loss.value))
    p = torch.from_numpy(pred).requires_grad_()
    t_val = t_fn(torch.from_numpy(target), p)
    t_grad, = torch.autograd.grad(t_val.sum(), p)
    j_val, j_grad = jax.value_and_grad(
        lambda q: jnp.sum(j_fn(target, q)))(pred)
    np.testing.assert_allclose(t_val.detach().numpy(),
                               np.asarray(j_fn(target, pred)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError):
        loss_type_from_str("nope")


def test_colour_helpers_match_jax():
    from ngp_tpu import common as jc
    x = np.linspace(-0.1, 1.5, 4001).astype(np.float32)
    np.testing.assert_allclose(linear_to_srgb(torch.from_numpy(x)).numpy(),
                               np.asarray(jc.linear_to_srgb(x)), rtol=1e-6)
    np.testing.assert_array_equal(linear_to_srgb_np(x), jc.linear_to_srgb_np(x))
    np.testing.assert_array_equal(srgb_to_linear_np(x), jc.srgb_to_linear_np(x))
    assert mse2psnr(1e-3) == jc.mse2psnr(1e-3) == pytest.approx(30.0)
