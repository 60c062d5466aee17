"""The rank grid and the table-parallel encode (port of
``ngp_tpu/dist/mesh.py``).

The JAX package builds a ``Mesh`` of devices with axes ``("data",
"model")`` and places arrays on it by ``NamedSharding``. Here each rank is
a process: ``make_mesh`` lays the ranks out row-major over an (n_data,
n_model) grid, as JAX's ``reshape(n_data, n_model)`` lays out its devices,
and gives each rank its coordinates and the process groups of its row
(``model``: the ranks that share its data shard) and of its column
(``data``: the ranks that hold the same table rows). The shardings become
slices: ``batch_sharding`` is a rank's range of batch rows,
``table_sharding`` its range of table rows on axis 1 of the (L, R, 128)
table, ``replicated`` the whole range.

``run_ranks`` spawns the processes of one world over a ``file://`` store,
which is how a test or the smoke run starts a world on one machine.
``backend_for`` picks the backend by the device: NCCL where every rank has
a card of its own, gloo for CPU tensors or for ranks that share a card
(NCCL refuses two ranks of one communicator on one device).

A collective over ``None`` is no collective: ``sum_over(x, None)`` is x.
(``torch.distributed`` reads ``group=None`` as the default group, so the
helpers here never pass ``None`` through.)
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ngp_tpu_torch.kernels.blocked_grid import (LANES, BlockedGridMeta,
                                                corner_lanes_and_weights,
                                                lookup_geometry)
from ngp_tpu_torch.kernels.hashgrid import mask_levels

# a 1-D parameter shards over ``model`` from this many elements on
# (``shard_params``; the JAX package's rule)
MIN_SHARD_ELEMENTS = 1 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_model) grid of ranks: its
    coordinates, and the groups of ranks that share its model index
    (``data_group``: the gradient sum of data parallelism) and its data
    index (``model_group``: the sum of a row-sharded encode)."""
    ranks: tuple                 # the grid's global ranks, row-major
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The (n_data, n_model) grid over ``ranks`` (default: every rank of
    the default group), laid out row-major. Creating a process group is
    collective over the default group, so every rank calls this with the
    same arguments; a rank outside ``ranks`` gets None."""
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model > len(ranks) or max(ranks) >= world:
        raise ValueError(f"a {n_data} x {n_model} grid needs that many of "
                         f"the world's {world} ranks, got {list(ranks)}")
    grid = [list(ranks[d * n_model:(d + 1) * n_model])
            for d in range(n_data)]
    # every rank makes every group, in one order
    data_groups = [dist.new_group([grid[d][m] for d in range(n_data)])
                   for m in range(n_model)]
    model_groups = [dist.new_group(grid[d]) for d in range(n_data)]
    me = dist.get_rank()
    for d in range(n_data):
        if me in grid[d]:
            m = grid[d].index(me)
            return Mesh(tuple(r for row in grid for r in row), n_data,
                        n_model, d, m, data_groups[m], model_groups[d])
    return None


def _range(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by {parts}")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of ``n`` split over ``data``."""
    return _range(n, mesh.n_data, mesh.data_index, "batch")


def table_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a table of ``rows`` rows split over ``model``
    (axis 1 of the (L, R, 128) table)."""
    return _range(rows, mesh.n_model, mesh.model_index, "rows")


def replicated(mesh: Mesh, n: int) -> slice:
    """Every row: a replicated array is whole on every rank."""
    return slice(0, n)


def shard_params(params: dict, mesh: Mesh, shard_tables: bool = False
                 ) -> dict:
    """A rank's view of a {name: tensor} dict: with ``shard_tables``, a
    1-D parameter of at least MIN_SHARD_ELEMENTS elements becomes this
    rank's contiguous slice of it over ``model``; the rest stay whole. No
    blocked (L, R, 128) table is 1-D, so none shards by this rule (the
    JAX package's; a blocked table shards by ``table_sharding``)."""
    def place(x):
        if shard_tables and x.dim() == 1 and x.numel() >= MIN_SHARD_ELEMENTS:
            return x[_range(x.numel(), mesh.n_model, mesh.model_index,
                            "elements")]
        return x
    return {k: place(v) for k, v in params.items()}


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (nothing for None)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_flat_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, through one flat buffer
    (one collective for all of them)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum of ``x`` over the group. Backward: the identity.
    The output is replicated over the group and its cotangent is the same
    on every rank, so each rank's share of the gradient is that cotangent
    itself: summing it over the group again would scale every shard's
    gradient by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, with the identity as its backward
    (``_SumOverGroup``); ``x`` itself for None."""
    return x if group is None else _SumOverGroup.apply(x, group)


def tp_encode(meta: BlockedGridMeta, table_local: torch.Tensor,
              pos: torch.Tensor, model_index: int, n_model: int,
              group) -> torch.Tensor:
    """The encode of (N, D) positions on a table row-sharded over
    ``n_model`` ranks: every rank computes the global lookup geometry,
    takes the lookups whose row it holds (all corners of one lookup lie in
    one row) with the rest masked to zero, and the partial features are
    summed over ``group``. (N, L·F); autograd gives each rank the gradient
    of its own rows (a gather's backward: an index_add)."""
    L, F = meta.n_levels, meta.n_features_per_level
    rows_local = meta.rows // n_model
    if table_local.shape[1] != rows_local:
        raise ValueError(f"table shard has {table_local.shape[1]} rows, "
                         f"expected {rows_local} of {meta.rows}")
    N = pos.shape[0]
    rows, local, frac = lookup_geometry(meta, pos)             # global rows
    lanes, weights = corner_lanes_and_weights(meta, local, frac)
    lrows = rows - model_index * rows_local
    inside = ((lrows >= 0) & (lrows < rows_local)).to(weights.dtype)
    idx = torch.clamp(lrows, 0, rows_local - 1)[:, :, None] * LANES + lanes
    flat = table_local.reshape(L, -1)
    feats = []
    for f in range(F):
        vals = torch.gather(flat, 1, (idx + f).reshape(L, -1)).view(idx.shape)
        feats.append(torch.sum(vals * weights, dim=-1) * inside)
    out = torch.stack(feats, -1).transpose(0, 1).reshape(N, L * F)
    return sum_over(out, group)


def make_tp_blocked_encode(meta: BlockedGridMeta, mesh: Mesh
                           ) -> Callable[..., torch.Tensor]:
    """encode(table_local, pos, max_level=None) → (N, L·F): the encode of
    the rank's positions (its data shard, or any positions its model row
    shares) on its row shard of the (L, R, 128) table, summed over
    ``model``. Every rank of a model row calls it on the same positions."""
    if meta.rows % mesh.n_model:
        raise ValueError(f"rows {meta.rows} not divisible by "
                         f"model={mesh.n_model}")

    def encode(table_local, pos, max_level=None):
        out = tp_encode(meta, table_local, pos, mesh.model_index,
                        mesh.n_model, mesh.model_group)
        return mask_levels(out, max_level, meta.n_levels,
                           meta.n_features_per_level)
    return encode


def backend_for(device, world: int) -> str:
    """NCCL where every one of ``world`` ranks has a card of its own
    (cuda:rank), gloo for CPU tensors or for ranks that share a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _side_file(store_path: str, what: str) -> Path:
    return Path(f"{store_path}.{what}.pkl")


def _rank_main(rank: int, world: int, backend: str, store_path: str,
               timeout_s: float):
    with open(_side_file(store_path, "args"), "rb") as f:
        fn, args = pickle.load(f)
    dist.init_process_group(
        backend, init_method=f"file://{store_path}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(_side_file(store_path, f"rank{rank}"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, backend: str, store_path,
              args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one process group (``backend``, a ``file://`` store at
    ``store_path``, which must not exist yet); returns each rank's result.
    ``fn`` and ``args`` reach the ranks, and the results come back, pickled
    through files beside the store (a spawned process reads what it is
    given only once it has started, so large arguments passed to the spawn
    itself would start the ranks one after another); ``fn`` is a
    module-level function. A rank that raises makes this raise, and the
    other ranks are stopped."""
    import torch.multiprocessing as mp
    store_path = str(store_path)
    if os.path.exists(store_path):
        raise FileExistsError(f"the store {store_path} exists already")
    with open(_side_file(store_path, "args"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    for r in range(world):
        _side_file(store_path, f"rank{r}").unlink(missing_ok=True)
    mp.spawn(_rank_main, args=(world, backend, store_path, timeout_s),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(_side_file(store_path, f"rank{r}"), "rb") as f:
            out.append(pickle.load(f))
    return out
