"""The frozen lookup geometry is the program's, and the byte, touched-entry
and operation counts match hand counts on tiny grids."""
import pytest
import torch

from portbench.lib import geometry as geo


@pytest.mark.parametrize("n_dims,enc,res", [
    (3, {"n_levels": 16, "log2_hashmap_size": 19, "base_resolution": 16},
     2048.0),
    (2, {"n_levels": 16, "log2_hashmap_size": 24, "base_resolution": 16},
     4096.0),
    (2, {"n_levels": 16, "log2_hashmap_size": 24, "base_resolution": 16},
     32.0)])
def test_geometry_is_the_programs(n_dims, enc, res):
    from ngp_tpu_torch.config import autofill_hashgrid_config
    from ngp_tpu_torch.kernels.blocked_grid import (BlockedGridMeta,
                                                    _corner_index)
    pm = BlockedGridMeta.from_hashgrid_config(
        autofill_hashgrid_config(dict(enc), n_dims, res))
    m = geo.grid_meta(enc, n_dims, res)
    assert (m.n_levels, m.rows, m.base_resolution) == (
        pm.n_levels, pm.rows, pm.base_resolution)
    assert m.per_level_scale == pytest.approx(pm.per_level_scale, rel=1e-12)
    pos = torch.rand((4096, n_dims),
                     generator=torch.Generator().manual_seed(1))
    i1, w1 = geo.corner_index(m, pos)
    i2, w2 = _corner_index(pm, pos)
    assert torch.equal(i1, i2) and torch.equal(w1, w2)


def test_flops_per_lookup_by_hand():
    # 3D: geometry 9, weights 8·2 + 3, corners 8·4 (K1) or 8·2 (K2)
    assert geo.flops_per_lookup("fwd", 3) == 60
    assert geo.flops_per_lookup("bwd", 3) == 44
    # 2D: geometry 6, weights 4·1 + 2, corners 4·4
    assert geo.flops_per_lookup("fwd", 2) == 28


def test_touched_entries_by_hand():
    meta = geo.GridMeta(3, 2, 4, 2.0, 6)        # two dense levels
    one = torch.tensor([[0.3, 0.4, 0.6]])
    # 8 distinct corners × 2 features a level
    assert geo.touched_entries(meta, one) == 2 * 8 * 2
    assert geo.touched_entries(meta, one.repeat(5, 1)) == 32
    # bytes: positions 12, features 4·2·2, touched entries 4·32
    assert geo.encode_bytes("fwd", meta, one) == 12 + 16 + 128
    assert geo.encode_bytes("bwd", meta, one) == 12 + 16 + 128
    assert geo.encode_bytes("fwd_i8", meta, one) == 12 + 16 + 8 + 32


def test_table_gradient_counts_the_entries_touched():
    meta = geo.grid_meta({"n_levels": 16, "log2_hashmap_size": 24}, 2, 4096.0)
    pos = torch.rand((1 << 12, 2), generator=torch.Generator().manual_seed(2))
    bwd = geo.encode_bytes("bwd", meta, pos)
    # far below the dense gradient the old count held a kernel to
    assert bwd < 0.05 * 4 * meta.n_params
    assert bwd == geo.encode_bytes("fwd", meta, pos)
    least = geo.encode_least_s("bwd", meta, pos)
    assert least == pytest.approx(bwd / geo.HBM_BYTES_PER_S)
