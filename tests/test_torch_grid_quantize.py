"""The int8 grid sweep quantises the table once per ``_grid_update``, not
once per network call of ``SWEEP_CHUNK`` positions: the table does not
change inside a sweep, so the densities must be bit-identical to the
per-chunk quantisation the JAX package's sweep does."""
import numpy as np
import pytest
import torch

import ngp_tpu_torch.train.nerf as tnerf
from ngp_tpu_torch.kernels import blocked_grid as tbg
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from test_torch_train_step import sphere_scene


def _per_chunk(model):
    """``model.density`` as the sweep called it before: each chunk
    quantises the table itself (the ``"fwd"`` int8 mode) instead of taking
    the sweep's pair."""
    density = model.density

    def per_chunk(pos01, quantized=None, **kw):
        return density(pos01, int8="fwd" if quantized is not None else "",
                       **kw)
    return per_chunk


@pytest.mark.parametrize("full_sweep", [True, False], ids=["full", "partial"])
def test_sweep_quantises_once_to_the_same_densities(monkeypatch, full_sweep):
    ds, cfg = sphere_scene(n_images=2, aabb_scale=1)
    tr = tnerf.NerfTrainer(ds, cfg, device="cpu", tcfg=tnerf.NerfTrainerConfig(
        n_rays=256, adapt_rays=False, grid_int8=True))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():    # a table with structure, as after training
        tr.model.pos_encoding.table.normal_(0.0, 0.5, generator=g)
    n_cells = tnerf.occ.GRID_VOLUME * (tr.max_cascade + 1)
    n = n_cells if full_sweep else tnerf.occ.GRID_VOLUME // 2
    jitter = torch.from_numpy(np.random.default_rng(2).random(
        (n, 3), dtype=np.float32))
    # four network calls in either sweep
    monkeypatch.setattr(tnerf, "SWEEP_CHUNK", n // 4)
    calls = []
    quantize = tbg.quantize_table_i8

    def counted(table):
        calls.append(table.shape)
        return quantize(table)
    grid0 = tr.grid
    results = {}
    for name in ("once", "per_chunk"):
        calls.clear()
        tr.grid = grid0
        with monkeypatch.context() as m:
            # the sweep's own call and the int8 encode's
            m.setattr(tnerf, "quantize_table_i8", counted)
            m.setattr(bgc, "quantize_table_i8", counted)
            if name == "per_chunk":
                m.setattr(tr.model, "density", _per_chunk(tr.model))
            tr._grid_update(full_sweep, jitter=jitter)
        results[name] = (tr.grid.density.clone(), len(calls))
    (d_once, n_once), (d_chunk, n_chunk) = (results["once"],
                                            results["per_chunk"])
    # per chunk: the sweep's own pair, unused, and one in each of 4 chunks
    assert (n_once, n_chunk) == (1, 1 + 4)
    assert torch.equal(d_once, d_chunk)
    # the sweep reached cells and moved them
    assert bool((d_once != grid0.density).any())
