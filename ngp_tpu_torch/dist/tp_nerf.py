"""Table-parallel NeRF training (port of ``ngp_tpu/dist/tp_nerf.py``): the
blocked hash table row-sharded over the mesh's ``model`` axis, composable
with ray parallelism over ``data``.

Every model rank computes the global lookup geometry, contributes the
lookups whose rows it holds and the partial features are summed over the
``model`` group (``dist.mesh.tp_encode``); the rest of the step (march,
compaction, MLPs, composite, loss, Adam) is the trainer's own step. The
table and its Adam moments and EMA are the rank's row shard, so table
memory and the table gradient's bandwidth scale as 1/M.

The JAX step takes its gradient inside ``shard_map`` through
``psum(out, "model")``, which the transpose turns into a second sum: each
shard's table gradient there is M times the single-device one (Adam's
first update hides the scale). The sum here has the identity as its
backward (``dist.mesh.sum_over``), so each shard's gradient is the
single-device gradient's rows.
"""
from __future__ import annotations

from torch import nn

from ngp_tpu_torch.dist.mesh import Mesh, table_sharding, tp_encode
from ngp_tpu_torch.dist.nerf_dp import rank_generator
from ngp_tpu_torch.kernels.hashgrid import mask_levels
from ngp_tpu_torch.nn.encodings import BlockedGridEncoding
from ngp_tpu_torch.opt.optimizers import AdamState

# the parameter that shards over ``model``, and its sharded axis
TABLE_PARAM = "pos_encoding.table"
TABLE_AXIS = 1


class TpBlockedGridEncoding(nn.Module):
    """A rank's view of a ``BlockedGridEncoding`` whose (L, R, 128) table
    is row-sharded over the mesh's ``model`` axis: ``table`` is the
    rank's (L, R/M, 128) shard, and ``forward`` sums the partial features
    over the ``model`` group (every rank of the group calls it on the same
    positions). The f32 encode only: no int8 mode."""

    def __init__(self, base: BlockedGridEncoding, mesh: Mesh):
        super().__init__()
        meta = base.meta
        if meta.rows % mesh.n_model:
            raise ValueError(f"rows {meta.rows} not divisible by "
                             f"model={mesh.n_model}")
        self.meta = meta
        self.n_output_dims = base.n_output_dims
        self.mesh = mesh
        self.rows = table_sharding(mesh, meta.rows)
        self.table = nn.Parameter(base.table.detach()[:, self.rows].clone())

    def resolved_config(self) -> dict:
        return {"row_hash": self.meta.row_hash,
                "log2_rows": self.meta.log2_rows}

    def forward(self, x, max_level=None, int8: str = "", tile=None,
                quantized=None):
        if int8 or quantized is not None:
            raise NotImplementedError("the table-parallel encode is f32 "
                                      "only")
        out = tp_encode(self.meta, self.table, x, self.mesh.model_index,
                        self.mesh.n_model, self.mesh.model_group)
        return mask_levels(out, max_level, self.meta.n_levels,
                           self.meta.n_features_per_level)


def _table_specs(names) -> dict:
    """{parameter name: its sharded axis, or None}: the position
    encoding's table shards on axis 1 over ``model``, everything else is
    replicated (the JAX package's spec tree)."""
    return {k: TABLE_AXIS if k == TABLE_PARAM else None for k in names}


def shard_state(state: AdamState, mesh: Mesh) -> AdamState:
    """The rank's shard of an Adam state of the whole network: the
    table's moments and EMA cut to the rank's rows, as ``_table_specs``
    shards the parameters."""
    def cut(d):
        specs = _table_specs(d)
        return {k: v if specs[k] is None else
                v[:, table_sharding(mesh, v.shape[TABLE_AXIS])].clone()
                for k, v in d.items()}
    return AdamState(state.step, cut(state.mu), cut(state.nu),
                     cut(state.ema_params))


def make_tp_nerf_train_step(trainer, mesh: Mesh,
                            n_rays_per_device: int = 256,
                            samples_per_device: int = 1 << 13):
    """step(error_state, draws=None) → StepStats: a DP×TP step of
    ``trainer``, whose model this binds to the table-parallel encoding
    (use a trainer of its own): its table, the table's Adam moments and
    EMA become the rank's row shard. Rays split over ``data`` (the ranks
    of one model row draw the same rays), the table over ``model``.
    The grid sweeps and the renderer are not table-parallel."""
    base = trainer.model.pos_encoding
    if not isinstance(base, BlockedGridEncoding):
        raise ValueError("table-parallel NeRF needs the blocked-grid "
                         "encoding")
    trainer.model.pos_encoding = TpBlockedGridEncoding(base, mesh)
    trainer.params = dict(trainer.model.named_parameters())
    trainer.opt_state = shard_state(trainer.opt_state, mesh)
    gen = rank_generator(trainer.seed, mesh.data_index, trainer.device)

    def step(error_state: dict, draws=None):
        if draws is None:
            draws = trainer.draws(n_rays_per_device, gen)
        return trainer._train_step(draws, error_state,
                                   capacity=samples_per_device,
                                   group=mesh.data_group)
    return step
