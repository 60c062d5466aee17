"""Bias-free MLP with tiny-cuda-nn's FullyFusedMLP semantics (port of
``ngp_tpu/nn/mlp.py``).

Numerics follow the JAX package: inputs and weights are rounded to bf16,
each product is accumulated in f32 (``jnp.dot(bf16, bf16,
preferred_element_type=f32)``), and activations are re-rounded to bf16
between layers. ``torch.matmul`` on bf16 tensors would return bf16 and
round the last layer's output too, so the bf16-rounded operands are
multiplied in f32 instead. On the card that product must run in full
f32: callers set ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""
from __future__ import annotations

import torch
from torch import nn


def _softplus(x):
    # log(1 + e^x) for every x, as jax.nn.softplus (logaddexp(x, 0));
    # torch's softplus returns x itself above a threshold
    return torch.logaddexp(x, torch.zeros_like(x))


# tcnn's activations by name (the JAX package's ``_activation``)
_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "leakyrelu": lambda x: torch.where(x > 0, x, 0.01 * x),
    "exponential": torch.exp,
    "sigmoid": torch.sigmoid,
    "logistic": torch.sigmoid,
    "sine": torch.sin,
    "squareplus": lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0)),
    "softplus": _softplus,
    "tanh": torch.tanh,
}


def _activation(name: str):
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


class MLP(nn.Module):
    """Weights are f32 matrices of shape (in_features, out_features), the
    JAX package's layout, held as ``weights.<i>``."""

    def __init__(self, n_input_dims: int, n_output_dims: int,
                 n_neurons: int = 64, n_hidden_layers: int = 1,
                 activation: str = "ReLU", output_activation: str = "None",
                 generator=None, device=None):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.activation = _activation(activation)
        self.output_activation = _activation(output_activation)
        if n_hidden_layers == 0:
            shapes = [(n_input_dims, n_output_dims)]
        else:
            shapes = ([(n_input_dims, n_neurons)]
                      + [(n_neurons, n_neurons)] * (n_hidden_layers - 1)
                      + [(n_neurons, n_output_dims)])
        # Xavier/Glorot-uniform init (tcnn's default for MLP layers)
        ws = []
        for fan_in, fan_out in shapes:
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            u = torch.rand((fan_in, fan_out), generator=generator,
                           device=device, dtype=torch.float32)
            ws.append(nn.Parameter(u * (2 * limit) - limit))
        self.weights = nn.ParameterList(ws)

    @classmethod
    def from_config(cls, n_input_dims: int, n_output_dims: int, cfg: dict,
                    generator=None, device=None) -> "MLP":
        return cls(n_input_dims, n_output_dims,
                   n_neurons=int(cfg.get("n_neurons", 64)),
                   n_hidden_layers=int(cfg.get("n_hidden_layers", 1)),
                   activation=str(cfg.get("activation", "ReLU")),
                   output_activation=str(cfg.get("output_activation", "None")),
                   generator=generator, device=device)

    def forward(self, x):
        h = _bf16(x)
        n = len(self.weights)
        for i, w in enumerate(self.weights):
            h = h @ _bf16(w)
            if i < n - 1:
                h = _bf16(self.activation(h))
        return self.output_activation(h)
