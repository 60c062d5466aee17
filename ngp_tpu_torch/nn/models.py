"""Model composition (port of ``ngp_tpu/nn/models.py``):

- ``EncodedNetwork``: encoding → MLP, tcnn's NetworkWithInputEncoding, the
  network of the image and SDF engines.
- ``NerfNetwork`` (ref: include/neural-graphics-primitives/
  nerf_network.h:77-548): pos → hash encoding → density MLP (16 outputs,
  [0] = raw density); [density MLP outputs ⊕ dir encoding ⊕ extra dims] →
  RGB MLP → 3 outputs."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from ngp_tpu_torch.common import NerfActivation, network_activation
from ngp_tpu_torch.config import autofill_hashgrid_config
from ngp_tpu_torch.nn.encodings import create_encoding, encode
from ngp_tpu_torch.nn.mlp import MLP
from ngp_tpu_torch.utils.profiling import spanned

# 1 density + 15 latent features fed to the RGB head
DENSITY_MLP_OUT = 16


class EncodedNetwork(nn.Module):
    """encoding(x) → MLP, with the encoding and MLP configs as given (a
    grid config already auto-filled by the caller, as the trainers do).
    Parameters: ``encoding.*`` (a grid's table; none for the analytic
    encodings) and ``net.weights.<i>``. ``grid_impl`` as in
    ``create_encoding``: ``"tcnn"`` builds the tcnn-layout grid whose flat
    table a reference snapshot holds. ``encoding``, a module already built
    (the SDF trainer's Takikawa encoding), takes the place of
    ``encoding_cfg``. ``forward(x, int8, tile)`` encodes in the blocked
    grid's int8 mode ``int8`` (``""``, ``"fwd"`` or ``"full"``;
    ``nn/encodings.encode``)."""

    def __init__(self, n_input_dims: int, n_output_dims: int,
                 encoding_cfg: Optional[dict], network_cfg: dict,
                 generator: Optional[torch.Generator] = None, device=None,
                 grid_impl: str = "blocked",
                 encoding: Optional[nn.Module] = None):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.encoding = encoding if encoding is not None else \
            create_encoding(n_input_dims, encoding_cfg, generator, device,
                            grid_impl)
        self.net = MLP.from_config(self.encoding.n_output_dims,
                                   n_output_dims, network_cfg, generator,
                                   device)

    @spanned("ngp.network")
    def forward(self, x, int8: str = "", tile: Optional[int] = None):
        return self.net(encode(self.encoding, x, int8, tile))

    def matrix_param_names(self) -> set[str]:
        """The MLP matrices: L2-regularised and never frozen by the
        zero-gradient skip; the encoding's table is not (the JAX package's
        ``matrix_mask``)."""
        return {name for name, _ in self.named_parameters()
                if name.startswith("net.")}


class NerfNetwork(nn.Module):
    """Density + RGB composition with directional encoding.

    ``config`` is a network config as loaded from ``configs/nerf/*.json``;
    the hash grid is auto-filled for ``aabb_scale`` like the trainer does
    (desired resolution 2048 · aabb_scale). Inputs are warped: positions in
    [0,1]^3 (AABB-relative) and directions as (d+1)/2 (ref:
    warp_position/warp_direction, src/testbed_nerf.cu:267-305).

    ``forward(pos01)`` returns the raw density MLP output (N, 16);
    ``forward(pos01, dir01)`` returns (rgb_raw (N,3), density_raw (N,)),
    pre-activation. Both forms work under ``torch.func.functional_call``,
    which is how the renderer evaluates a given parameter dict.

    ``n_extra_dims`` per-image latent dims (trained by the trainer) join
    the direction: the dir encoding runs over 3 + E dims, and
    ``forward``/``apply`` then need ``extra`` (N, E).

    ``grid_impl="tcnn"`` builds the position encoding as the tcnn-layout
    grid (``nn/encodings.GridEncoding``), whose flat table a reference
    snapshot's ``params_binary`` holds; ``"blocked"``, the default, the
    blocked grid of the CUDA kernels.
    """

    def __init__(self, config: dict, aabb_scale: int = 1,
                 generator: Optional[torch.Generator] = None, device=None,
                 n_extra_dims: int = 0, grid_impl: str = "blocked"):
        super().__init__()
        self.n_extra_dims = n_extra_dims
        enc_cfg = autofill_hashgrid_config(config["encoding"], 3, 2048.0,
                                           aabb_scale=aabb_scale)
        self.pos_encoding = create_encoding(3, enc_cfg, generator, device,
                                            grid_impl)
        self.dir_encoding = create_encoding(
            3 + n_extra_dims,
            config.get("dir_encoding", {"otype": "SphericalHarmonics",
                                        "degree": 4}), generator, device,
            grid_impl)
        self.density_net = MLP.from_config(
            self.pos_encoding.n_output_dims, DENSITY_MLP_OUT,
            config["network"], generator, device)
        self.rgb_net = MLP.from_config(
            self.dir_encoding.n_output_dims + DENSITY_MLP_OUT, 3,
            config.get("rgb_network", config["network"]), generator, device)

    @spanned("ngp.network")
    def forward(self, pos01, dir01=None, max_level=None, extra=None,
                int8: str = "", tile: Optional[int] = None, quantized=None):
        h = self.density_net(self.pos_encoding(pos01, max_level=max_level,
                                               int8=int8, tile=tile,
                                               quantized=quantized))
        if dir01 is None:
            return h
        if (extra is None) != (self.n_extra_dims == 0):
            raise ValueError(f"the network has {self.n_extra_dims} extra "
                             "dims: pass extra (N, E) exactly when E > 0")
        din = dir01 if extra is None else torch.cat([dir01, extra], -1)
        dfeat = self.dir_encoding(din)
        rgb_raw = self.rgb_net(torch.cat([h, dfeat.to(torch.float32)], -1))
        return rgb_raw, h[..., 0]

    def apply(self, pos01, dir01, extra=None, max_level=None, int8: str = "",
              tile: Optional[int] = None):
        """Full forward: (rgb_raw (N,3), density_raw (N,)), pre-activation
        (ref: the network's 4-channel output). ``int8`` and ``tile`` select
        the encode's int8 mode (``BlockedGridEncoding``)."""
        return self(pos01, dir01, max_level=max_level, extra=extra, int8=int8,
                    tile=tile)

    def rgb_sigma(self, pos01, dir01, extra=None, max_level=None,
                  int8: str = "", params=None):
        """Activated (rgb (N, 3), σ (N,)): the logistic colour and the
        exponential density (port of ``NerfNetwork.rgb_sigma``). With
        ``params`` the network runs on that parameter dict
        (``functional_call``), as the renderer evaluates the EMA copy."""
        kw = {"extra": extra, "max_level": max_level, "int8": int8}
        rgb_raw, d_raw = (self(pos01, dir01, **kw) if params is None else
                          functional_call(self, params, (pos01, dir01), kw))
        return (network_activation(rgb_raw, NerfActivation.LOGISTIC),
                network_activation(d_raw, NerfActivation.EXPONENTIAL))

    def density(self, pos01, max_level=None, int8: str = "",
                quantized=None):
        """Activated density σ, (N,). ref: network_to_density. ``int8``
        encodes through the int8-quantised table; ``quantized``, the
        encoding's table as ``quantize_table_i8`` gave it, through that
        pair without quantising again (the trainer's grid sweep)."""
        raw = self(pos01, max_level=max_level, int8=int8,
                   quantized=quantized)
        return network_activation(raw[..., 0], NerfActivation.EXPONENTIAL)

    def matrix_param_names(self) -> set[str]:
        """Parameters that are MLP weight matrices: L2-regularised and
        never frozen by the zero-gradient skip (ref: optimize_matrix_params
        split; the JAX package's ``matrix_mask``). The rest — the hash
        table — are the non-matrix parameters."""
        return {name for name, _ in self.named_parameters()
                if name.startswith(("density_net.", "rgb_net."))}
