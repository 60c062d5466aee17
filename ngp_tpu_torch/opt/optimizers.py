"""The optimizer stack of the reference's tcnn configuration,
Ema(ExponentialDecay(Adam)) (port of ``ngp_tpu/opt/optimizers.py``; ref:
configs/*/base.json, consumed at src/testbed.cu:2337-2422).

The update runs under ``torch.no_grad()`` over named tensors and changes
parameters and moments in place (the JAX package returns new pytrees):

- Adam with tcnn semantics: the gradient is divided by the loss scale,
  L2 regularisation applies to matrix parameters (MLP weights) only, and
  non-matrix entries whose gradient is exactly 0 are frozen, moments
  included (``skip_zero_grad``; the hash table, where a step touches only
  the rows its samples hit).
- ExponentialDecay: one factor of ``decay_base`` every ``decay_interval``
  steps from ``decay_start``, up to ``decay_end``.
- Ema: an exponential moving average of the parameters, which inference
  uses.

Learning rate and bias corrections are computed in f32, as the JAX package
computes them.

``apply_update`` picks by the device of the tensors it is given: CPU
tensors take the eager update (``apply_update_plain``), CUDA tensors the
hand-written fused kernel (``kernels/fused_adam_cuda.py``), one launch a
step over every tensor, bit-identical to the eager update on the card;
anything else raises. There is no fallback from the kernel to the eager
update.

With no Ema (``ema_decay`` 0) the JAX package's step returns ``ema =
params_out``: here ``init_state`` given the config makes each Ema entry
the parameter tensor itself, so no step copies it. A state whose Ema
entries are tensors of their own (a shard's, or one built with
``state._replace(ema_params=...)``) is still set to the parameters every
step.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import torch

from ngp_tpu_torch.kernels import fused_adam_cuda
from ngp_tpu_torch.utils.profiling import count, spanned


class AdamState(NamedTuple):
    step: int
    mu: dict            # parameter name → first moment
    nu: dict            # parameter name → second moment
    ema_params: dict    # parameter name → EMA copy of the parameter


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    learning_rate: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.99
    epsilon: float = 1e-15
    l2_reg: float = 1e-6
    # ExponentialDecay wrapper (0 interval → disabled)
    decay_start: int = 0
    decay_interval: int = 0
    decay_base: float = 1.0
    decay_end: int = 2 ** 31 - 1
    # Ema wrapper (0 → disabled)
    ema_decay: float = 0.0
    loss_scale: float = 1.0
    skip_zero_grad: bool = True

    @classmethod
    def from_config(cls, cfg: dict, loss_scale: float = 1.0) -> "AdamConfig":
        """Parse the nested tcnn optimizer JSON (Ema → ExponentialDecay →
        Adam)."""
        ema_decay = 0.0
        decay = {}
        node = cfg
        while True:
            otype = node.get("otype", "Adam").lower()
            if otype == "ema":
                ema_decay = float(node.get("decay", 0.99))
                node = node["nested"]
            elif otype == "exponentialdecay":
                decay = node
                node = node["nested"]
            else:
                break
        return cls(
            learning_rate=float(node.get("learning_rate", 1e-3)),
            beta1=float(node.get("beta1", 0.9)),
            beta2=float(node.get("beta2", 0.999)),
            epsilon=float(node.get("epsilon", 1e-8)),
            l2_reg=float(node.get("l2_reg", 0.0)),
            decay_start=int(decay.get("decay_start", 0)),
            decay_interval=int(decay.get("decay_interval", 0)),
            decay_base=float(decay.get("decay_base", 1.0)),
            decay_end=int(decay.get("decay_end", 2 ** 31 - 1)),
            ema_decay=ema_decay,
            loss_scale=loss_scale,
        )


def init_state(params: Mapping[str, torch.Tensor],
               cfg: AdamConfig) -> AdamState:
    """Zero moments and an EMA that starts as a copy of the parameters; the
    parameter tensors themselves where ``cfg`` has no Ema (a restore then
    writes the Ema before the parameters, so the parameters win)."""
    alias = cfg.ema_decay <= 0.0
    return AdamState(
        step=0,
        mu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()},
        ema_params={k: p if alias else p.detach().clone()
                    for k, p in params.items()})


def _f32_pow(base: float, exponent: int, device) -> torch.Tensor:
    """base**exponent as the JAX package computes it: powf of two f32s."""
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                     torch.tensor(float(exponent), dtype=torch.float32,
                                  device=device))


def lr_at_step(cfg: AdamConfig, step: int, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (f32, 0-d)."""
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=device)
    if cfg.decay_interval > 0 and cfg.decay_base != 1.0:
        eff = min(step, cfg.decay_end)
        n_decays = 0 if eff < cfg.decay_start else max(
            0, (eff - cfg.decay_start) // cfg.decay_interval + 1)
        lr = lr * _f32_pow(cfg.decay_base, n_decays, device)
    return lr


@torch.no_grad()
@spanned("ngp.adam")
def apply_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamState,
                 cfg: AdamConfig, matrix_names=None) -> AdamState:
    """One Adam(+decay+EMA) step, in place on ``params`` and the state's
    tensors; returns the state with its step advanced. ``matrix_names``:
    the parameters that get L2 regularisation and no zero-gradient skip
    (None: all). CPU tensors take the eager update, CUDA tensors the fused
    kernel."""
    dev = next(iter(params.values())).device
    if dev.type == "cpu":
        return apply_update_plain(params, grads, state, cfg, matrix_names)
    if dev.type != "cuda":
        raise ValueError(f"apply_update takes CPU or CUDA tensors, got "
                         f"{dev}")
    return apply_update_fused(params, grads, state, cfg, matrix_names)


def apply_update_fused(params: Mapping[str, torch.Tensor],
                       grads: Mapping[str, torch.Tensor], state: AdamState,
                       cfg: AdamConfig, matrix_names=None) -> AdamState:
    """``apply_update`` as one launch of the fused kernel over every tensor
    (which must lie on one CUDA device); counts the entries it updated
    under ``adam_fused``. With no Ema an Ema entry that is its parameter's
    memory is left alone, any other set to the parameter."""
    step = state.step + 1
    rows = []
    for name, p in params.items():
        is_matrix = matrix_names is None or name in matrix_names
        e = state.ema_params[name]
        ema = (fused_adam_cuda.EMA_DECAY if cfg.ema_decay > 0.0
               else fused_adam_cuda.EMA_NONE if e.data_ptr() == p.data_ptr()
               else fused_adam_cuda.EMA_COPY)
        rows.append(fused_adam_cuda.Entry(
            p, grads[name], state.mu[name], state.nu[name], e,
            dense=not (cfg.skip_zero_grad and not is_matrix),
            l2=cfg.l2_reg > 0.0 and is_matrix, ema=ema))
    count("adam_fused", fused_adam_cuda.launch(rows, _scalars(cfg, step)))
    return state._replace(step=step)


def _scalars(cfg: AdamConfig, step: int) -> "fused_adam_cuda.AdamScalars":
    """The kernel's scalars: each Python float rounded to f32 as PyTorch
    rounds a scalar operand (1 - x taken in double first, as the eager
    expressions do); the kernel computes the learning rate and the bias
    corrections from ``step`` as ``lr_at_step`` and ``_f32_pow`` do."""
    return fused_adam_cuda.AdamScalars(
        lr=cfg.learning_rate, decay_base=cfg.decay_base,
        b1=cfg.beta1, omb1=1.0 - cfg.beta1, b2=cfg.beta2,
        omb2=1.0 - cfg.beta2, eps=cfg.epsilon, l2=cfg.l2_reg,
        inv_ls=1.0 / cfg.loss_scale, ema_d=cfg.ema_decay,
        ema_omd=1.0 - cfg.ema_decay, step=step,
        decay_on=int(cfg.decay_interval > 0 and cfg.decay_base != 1.0),
        decay_start=cfg.decay_start, decay_interval=cfg.decay_interval,
        decay_end=cfg.decay_end)


@torch.no_grad()
def apply_update_plain(params: Mapping[str, torch.Tensor],
                       grads: Mapping[str, torch.Tensor], state: AdamState,
                       cfg: AdamConfig, matrix_names=None) -> AdamState:
    """``apply_update`` as eager PyTorch, on any device: the plain version
    that the CPU takes and the fused kernel is held to."""
    step = state.step + 1
    dev = next(iter(params.values())).device
    lr = lr_at_step(cfg, step, dev)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - _f32_pow(b1, step, dev)
    bc2 = 1.0 - _f32_pow(b2, step, dev)
    inv_ls = 1.0 / cfg.loss_scale
    for name, p in params.items():
        g_raw = grads[name]
        m, v = state.mu[name], state.nu[name]
        is_matrix = matrix_names is None or name in matrix_names
        g = g_raw.to(torch.float32) * inv_ls
        if cfg.l2_reg > 0.0 and is_matrix:
            g = g + cfg.l2_reg * p
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        p_new = p - lr * mhat / (torch.sqrt(vhat) + cfg.epsilon)
        if cfg.skip_zero_grad and not is_matrix:
            touched = g_raw != 0
            p_new = torch.where(touched, p_new, p)
            m_new = torch.where(touched, m_new, m)
            v_new = torch.where(touched, v_new, v)
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
    if cfg.ema_decay > 0.0:
        d = cfg.ema_decay
        for name, e in state.ema_params.items():
            e.copy_(d * e + (1.0 - d) * params[name])
    else:
        for name, e in state.ema_params.items():
            if e is not params[name]:
                e.copy_(params[name])
    return state._replace(step=step)


def inference_params(params: Mapping[str, torch.Tensor], state: AdamState,
                     cfg: AdamConfig) -> Mapping[str, torch.Tensor]:
    """The parameters inference uses: the EMA copy when Ema is configured."""
    return state.ema_params if cfg.ema_decay > 0.0 else params
