"""Parameter sets on which the fused Adam kernel is held bit for bit against
the eager update (``apply_update_plain``), on any device: on the CPU
through the emulated kernel (``test_torch_fused_adam.py``), on the card
through the kernel itself (``test_torch_fused_adam_card.py``). No JAX, so
the card's machine can import it."""
from typing import Callable, NamedTuple

import torch

from ngp_tpu_torch.opt import optimizers as topt


class Case(NamedTuple):
    params: dict
    state: topt.AdamState
    cfg: topt.AdamConfig
    matrix_names: set
    grads_of: Callable      # step → gradients by name


def assert_bits(got: torch.Tensor, want: torch.Tensor, what: str):
    """Bit for bit, NaNs at the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32)), what


def copy_at(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` at the same offset from a 16-byte boundary (a fresh
    tensor is aligned: a clone of a view 4 bytes into a buffer is not)."""
    off = t.data_ptr() % 16 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _clone_state(state: topt.AdamState, params: dict,
                 new_params: dict) -> topt.AdamState:
    """A copy of ``state`` for ``new_params``: Ema entries that are their
    parameter stay the (new) parameter."""
    return state._replace(
        mu={k: copy_at(t) for k, t in state.mu.items()},
        nu={k: copy_at(t) for k, t in state.nu.items()},
        ema_params={k: new_params[k] if e is params[k] else copy_at(e)
                    for k, e in state.ema_params.items()})


def run_both(case: Case, steps: int):
    """``steps`` steps of the kernel (``apply_update_fused``) and of the
    eager update from copies of the same parameters and state, on the
    gradients ``grads_of(step)``; every tensor compared bit for bit after
    each step. Returns the kernel's parameters and state."""
    kp = {k: copy_at(p) for k, p in case.params.items()}
    ks = _clone_state(case.state, case.params, kp)
    pp = {k: copy_at(p) for k, p in case.params.items()}
    ps = _clone_state(case.state, case.params, pp)
    for step in range(steps):
        grads = case.grads_of(step)
        ks = topt.apply_update_fused(kp, grads, ks, case.cfg,
                                     case.matrix_names)
        ps = topt.apply_update_plain(pp, grads, ps, case.cfg,
                                     case.matrix_names)
        assert ks.step == ps.step == case.state.step + step + 1
        for k in kp:
            assert_bits(kp[k], pp[k], f"p {k} step {step}")
            assert_bits(ks.mu[k], ps.mu[k], f"m {k} step {step}")
            assert_bits(ks.nu[k], ps.nu[k], f"v {k} step {step}")
            assert_bits(ks.ema_params[k], ps.ema_params[k],
                        f"e {k} step {step}")
    return kp, ks


MATRICES = {"w0": (16, 64), "w1": (64, 64), "w2": (64, 3)}


def _table_grads(gen, shape, lanes: int = 8):
    """A table gradient (levels, rows, 128) that touches ~6 % of its rows,
    ``lanes`` neighbouring lanes in each: what one position's corners
    write in a row."""
    levels, rows = shape[0], shape[1]
    dev = gen.device
    n = max(1, levels * rows // 16)
    lv = torch.randint(0, levels, (n,), generator=gen, device=dev)
    row = torch.randint(0, rows, (n,), generator=gen, device=dev)
    lane = torch.randint(0, 128 - lanes, (n,), generator=gen, device=dev)
    flat = ((lv * rows + row) * 128 + lane)[:, None] \
        + torch.arange(lanes, device=dev)
    g = torch.zeros(shape, device=dev)
    g.view(-1)[flat.reshape(-1)] = torch.randn(flat.numel(), generator=gen,
                                               device=dev)
    return g


def _matrix_grads(gen):
    return {k: torch.randn(s, generator=gen, device=gen.device)
            for k, s in MATRICES.items()}


def _params(gen, shapes: dict) -> dict:
    return {k: torch.randn(s, generator=gen, device=gen.device)
            for k, s in shapes.items()}


def image_like(device, rows: int, seed: int = 0) -> Case:
    """A 2D table (16, rows, 128) with ~6 % of its rows touched a step,
    three matrices, L2, the loss scale, no Ema (the Ema is the
    parameters)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _params(gen, {"table": (16, rows, 128), **MATRICES})
    cfg = topt.AdamConfig(learning_rate=1e-2, beta1=0.9, beta2=0.99,
                          epsilon=1e-15, l2_reg=1e-6, loss_scale=128.0)

    def grads_of(step):
        return {"table": _table_grads(gen, params["table"].shape),
                **_matrix_grads(gen)}
    return Case(params, topt.init_state(params, cfg), cfg, set(MATRICES),
                grads_of)


def nerf_like(device, rows: int, seed: int = 1) -> Case:
    """A 3D-like table (16, rows, 128), three matrices, Ema 0.95, L2, and
    a learning-rate decay that crosses its start, several intervals and
    its end within 20 steps."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = _params(gen, {"table": (16, rows, 128), **MATRICES})
    cfg = topt.AdamConfig(learning_rate=1e-2, beta1=0.9, beta2=0.99,
                          epsilon=1e-15, l2_reg=1e-6, decay_start=5,
                          decay_interval=3, decay_base=0.33, decay_end=15,
                          ema_decay=0.95, loss_scale=128.0)

    def grads_of(step):
        return {"table": _table_grads(gen, params["table"].shape, 16),
                **_matrix_grads(gen)}
    return Case(params, topt.init_state(params, cfg), cfg, set(MATRICES),
                grads_of)


ODD_SIZES = [1, 3, 5, 4, 4097, 0, 4096 * 2 + 7] + [6] * 30


def odd_sizes(device, seed: int = 2) -> Case:
    """Sizes that are no multiple of 4, a zero-size tensor, tensors not
    16-byte aligned (views 4 bytes into a buffer: scalar loads), lone
    non-zeros, a -0.0 and a NaN in otherwise-zero gradients, an Ema of its
    own with no Ema configured (set to p every step), more tensors than
    one launch takes (two launches a step)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.zeros(sum(ODD_SIZES) + 64, device=device)
    params, off = {}, 1
    for i, n in enumerate(ODD_SIZES):
        if i % 3 == 0:
            params[f"t{i}"] = torch.randn(n, generator=gen, device=device)
        else:
            params[f"t{i}"] = buf[off:off + n]
            params[f"t{i}"].copy_(torch.randn(n, generator=gen,
                                              device=device))
            off += n
    cfg = topt.AdamConfig(learning_rate=3e-3, beta1=0.9, beta2=0.99,
                          epsilon=1e-15, l2_reg=0.0)

    def grads_of(step):
        out = {}
        for k, p in params.items():
            g = torch.zeros(p.numel(), device=device)
            if g.numel():
                idx = torch.randint(0, g.numel(), (max(1, g.numel() // 50),),
                                    generator=gen, device=device)
                g[idx] = torch.randn(idx.numel(), generator=gen,
                                     device=device)
                g[int(torch.randint(0, g.numel(), (1,), generator=gen,
                                    device=device))] = -0.0
            out[k] = g
        out["t6"][5] = float("nan")
        return out
    state = topt.init_state(params, cfg)._replace(
        ema_params={k: p.clone() for k, p in params.items()})
    return Case(params, state, cfg, {"t0", "t3"}, grads_of)
