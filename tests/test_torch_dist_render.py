"""Frame-sharded rendering (``NerfRenderer.render_multichip``) and the
multi-scene orchestrator of the port (``ngp_tpu_torch.dist``): in a gloo
world of two CPU ranks against the JAX package's ``render_multichip`` on
a 2-device mesh and against the port's own ``render``; the orchestrator
in one process (two scenes in turn) and in the world (one scene on a
group of both ranks, the in-group DP step). About 45 s alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import make_orbit_dataset
from torch_dist_ranks import nerf_trainer, render_world, run_scenes
from ngp_tpu_torch.dist.mesh import run_ranks

TCFG = dict(n_rays=256, target_batch_size=2048, march_steps=256)
OPTS = dict(width=32, height=16, march_steps=256, chunk=256,
            linear_out=False)
FOCAL = (20.0, 20.0)
# (width, height, spp, snap to pixel centres): spp 2 with jitter draws
# numbers; 48 × 16 has 3 chunks, padded to 2 a rank
CASES = [(32, 16, 1, False), (32, 16, 2, False), (32, 16, 2, True),
         (48, 16, 1, False)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """tests/test_render_multichip.py's trainer and live grid, and the
    numpy setup the ranks rebuild it from."""
    from ngp_tpu.config import load_network_config
    from ngp_tpu.train.nerf import NerfTrainer, NerfTrainerConfig
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    ds = make_orbit_dataset(res=16)
    tr = NerfTrainer(ds, cfg, tcfg=NerfTrainerConfig(**TCFG))
    tr.grid = tr.grid._replace(bitfield=jnp.full_like(tr.grid.bitfield, 255))
    setup = {"fields": {f.name: getattr(ds, f.name)
                        for f in dataclasses.fields(ds)},
             "cfg": cfg, "tcfg": TCFG,
             "tree": jax.tree.map(np.array, tr.params),
             "grid": jax.tree.map(np.array, tr.grid._asdict()),
             "camera": np.asarray(ds.xforms[0]), "focal": FOCAL}
    return tr, setup


@pytest.fixture(scope="module")
def world(scene, tmp_path_factory):
    _, setup = scene
    return run_ranks(render_world, 2, "gloo",
                     tmp_path_factory.mktemp("render") / "store",
                     args=(setup, OPTS, CASES, {"group": ["solo"]}))


def _port_render(setup, case):
    from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions
    w, h, spp, snap = case
    tr = nerf_trainer(setup)
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        **OPTS, snap_to_pixel_centers=snap))
    return r.render(dict(tr.params), tr.grid.bitfield, setup["camera"], w, h,
                    focal=FOCAL, spp=spp).numpy()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_render_multichip_is_render(scene, world, case):
    """Every rank assembles the whole frame, and it is ``render``'s: each
    chunk took ``render``'s draws, whichever rank rendered it."""
    ref = _port_render(scene[1], CASES[case])
    for r in world:
        assert r["frames"][case].shape == ref.shape
        np.testing.assert_array_equal(r["frames"][case], ref)


@pytest.mark.parametrize("case", [0, 2])
def test_render_multichip_matches_jax(scene, world, case):
    """Against the JAX package's ``render_multichip`` on a 2-device mesh
    (tests/test_render_multichip.py's tolerance): a still frame, and spp 2
    at pixel centres (the two packages jitter from other generators)."""
    from ngp_tpu.dist.mesh import make_mesh
    from ngp_tpu.render.nerf_render import NerfRenderer, RenderOptions
    tr, setup = scene
    w, h, spp, snap = CASES[case]
    r = NerfRenderer.for_trainer(tr, RenderOptions(
        **OPTS, snap_to_pixel_centers=snap))
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    ref = r.render_multichip(mesh, tr.params, tr.grid.bitfield,
                             setup["camera"], w, h, focal=FOCAL, spp=spp)
    for rk in world:
        np.testing.assert_allclose(rk["frames"][case], ref, atol=2e-5)


def test_orchestrator_in_one_process_interleaves_scenes(scene):
    """Two scenes on one device train in turn, a slice each
    (tests/test_multiscene_tp.py's order), each to exactly its steps."""
    from ngp_tpu_torch.train.nerf import NerfTrainer
    seen = []
    orch = run_scenes(scene[1], ["scene0", "scene1"],
                      progress=lambda n, s, loss: seen.append((n, s, loss)))
    assert [(n, s) for n, s, _ in seen] == [
        ("scene0", 3), ("scene1", 3), ("scene0", 6), ("scene1", 6)]
    assert all(np.isfinite(loss) for *_, loss in seen)
    for job in orch.jobs:
        assert job.ranks == [0]
        tr = orch.trainers[job.name]
        assert type(tr) is NerfTrainer and tr.training_step == 6


def test_orchestrator_group_of_two_runs_the_dp_step(world):
    """One scene over a world of two: one group of both ranks, which runs
    the data-parallel step; the ranks end with the same parameters."""
    a, b = (r["group"]["solo"] for r in world)
    assert a["type"] == b["type"] == "_DpGroupRunner"
    assert a["step"] == b["step"] == 6
    assert np.isfinite(a["loss"]) and a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
