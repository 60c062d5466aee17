"""The 2D table backward's plan (``blocked_grid_cuda.table_bwd_plan_2d``)
and the port's ``level_needed_rows``, which the plan reads, against the
JAX package's on the grids the engines build: the image (configs/image/
base.json at a 2048² image), NeRF base at aabb_scale 4, SDF base and the
Takikawa octree's grid."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import pytest

import ngp_tpu.config as jcfg
import ngp_tpu.kernels.blocked_grid as jbg
from ngp_tpu_torch import config as tcfg
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc
from ngp_tpu_torch.kernels.blocked_grid import BlockedGridMeta
from ngp_tpu_torch.nn.takikawa import TakikawaMeta

ROOT = bgc.CSRC.parent.parent


def _hashgrid_configs(name: str):
    """The (port, JAX) hash-grid configs of grid ``name``, each package's
    own config code filling them in."""
    if name == "takikawa":
        enc = tcfg.load_network_config(ROOT / "configs/sdf/takikawa.json")[
            "encoding"]
        m = TakikawaMeta.from_config(enc)
        c = {"n_pos_dims": 3, "n_levels": m.n_levels,
             "n_features_per_level": m.n_features_per_level,
             "log2_hashmap_size": m.log2_hashmap_size,
             "base_resolution": 1 << m.start_depth, "per_level_scale": 2.0}
        return c, dict(c)
    path, dims, res, aabb = {
        "image": ("configs/image/base.json", 2, 1024.0, 1),
        "nerf": ("configs/nerf/base.json", 3, 2048.0, 4),
        "sdf": ("configs/sdf/base.json", 3, 2048.0, 1)}[name]
    return (tcfg.autofill_hashgrid_config(
        tcfg.load_network_config(ROOT / path)["encoding"], dims, res,
        aabb_scale=aabb),
        jcfg.autofill_hashgrid_config(
            jcfg.load_network_config(str(ROOT / path))["encoding"], dims,
            res, aabb_scale=aabb))


@pytest.mark.parametrize("name", ["image", "nerf", "sdf", "takikawa"])
def test_level_needed_rows_matches_jax(name):
    """Rows per level, dense levels' blocks^D rounded up to a power of two
    (min 8), hashed levels the whole table: the port's equal the JAX
    package's, level for level."""
    ours, theirs = _hashgrid_configs(name)
    meta = BlockedGridMeta.from_hashgrid_config(ours)
    jmeta = jbg.BlockedGridMeta.from_hashgrid_config(theirs)
    assert (meta.n_levels, meta.rows) == (jmeta.n_levels, jmeta.rows)
    assert meta.level_needed_rows == jmeta.level_needed_rows
    assert all(n >= b ** meta.n_dims or not dense for n, b, dense in zip(
        meta.level_needed_rows, meta.level_blocks_per_dim,
        meta.level_is_dense))


def test_image_grid_plan():
    """On the image grid (16 levels × 32768 rows, every level dense): the
    levels whose needed rows fit in a level's share of 64 KiB summed in
    shared memory, the others in L2; K2 in groups of 2 levels (share 64
    rows: levels 0-4; a block's largest pair 16 + 36 rows) and chunks of
    1024 samples, K5 in groups of 4 (share 32: levels 0-2, 9 + 16 + 16
    rows) and chunks of the tile; 256 threads (128 for a tile of 32)."""
    meta = BlockedGridMeta.from_hashgrid_config(_hashgrid_configs("image")[0])
    assert all(meta.level_is_dense) and meta.rows == 32768
    reach = sum(b * b for b in meta.level_blocks_per_dim)
    assert reach == 50940                  # 26.1 MB of the 268 MB gradient
    plan = bgc.table_bwd_plan_2d(1 << 18, meta)
    assert plan.where == (bgc.SUM_LEVEL,) * 5 + (bgc.SUM_L2,) * 11
    assert (plan.chunk, plan.width, plan.threads, plan.chunks,
            plan.smem_bytes) == (1024, 2, 256, 256, 52 * 512)
    for tile, threads in ((32, 128), (64, 256), (2048, 256)):
        p5 = bgc.table_bwd_plan_2d((1 << 18) + 5, meta, tile)
        assert p5.where == (bgc.SUM_LEVEL,) * 3 + (bgc.SUM_L2,) * 13
        assert (p5.chunk, p5.width, p5.threads, p5.chunks,
                p5.smem_bytes) == (tile, 4, threads,
                                   -(-((1 << 18) + 5) // tile), 41 * 512)


def test_table_bwd_plan_sums_hashed_levels_in_l2():
    """A 2D grid with hashed levels: those go to L2, and a grid with no
    dense level launches without shared memory; 6 and 7 levels take
    groups of 2 and 1; a chunk that is not a power of two ≥ 32 is
    refused."""
    meta = BlockedGridMeta(2, 8, 16, 2.0, log2_rows=8)
    plan = bgc.table_bwd_plan_2d(1000, meta)
    assert plan.where[:2] == (bgc.SUM_LEVEL,) * 2
    assert set(plan.where[2:]) == {bgc.SUM_L2}
    for levels, width in ((6, 2), (7, 1)):
        odd = BlockedGridMeta(2, levels, 16, 2.0, log2_rows=8)
        assert bgc.table_bwd_plan_2d(1000, odd, 32).width == width
    hashed = BlockedGridMeta(2, 4, 512, 2.0, log2_rows=6)
    assert not any(hashed.level_is_dense)
    assert bgc.table_bwd_plan_2d(1000, hashed).smem_bytes == 0
    for tile in (16, 48):
        with pytest.raises(ValueError):
            bgc.table_bwd_plan_2d(1000, meta, tile)
