"""chip_smoke.py's capture of the render path's own encode inputs (the
ray-ordered positions K1 and K2 are timed on), on the CPU: a tiny scene
(4 levels, a 32×32 frame in 256-ray chunks) with a seeded density grid."""
import numpy as np
import torch

import chip_smoke as cs
from ngp_tpu_torch.config import load_network_config
from ngp_tpu_torch.grid import occupancy as tocc
from ngp_tpu_torch.nn.models import NerfNetwork
from ngp_tpu_torch.render.nerf_render import NerfRenderer, RenderOptions

RES, FOCAL = 32, (32.0, 32.0)


def test_capture_returns_the_largest_encode_call_in_stream_order(
        monkeypatch):
    cfg = load_network_config("configs/nerf/base.json")
    cfg["encoding"]["n_levels"] = 4
    cfg["encoding"]["log2_hashmap_size"] = 12
    model = NerfNetwork(cfg, 1, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    rng = np.random.default_rng(0)
    density = (rng.random(tocc.GRID_VOLUME) < 0.3).astype(np.float32)
    grid = tocc.rebuild_bitfield(tocc.init_grid(0)._replace(
        density=torch.from_numpy(density)))
    renderer = NerfRenderer(model, 0.0, 1.0, 0.0, 0,
                            RenderOptions(chunk=256, march_steps=1024))

    received = []
    encode = model.pos_encoding.forward

    def spy(x, *args, **kwargs):
        received.append(x.clone())
        return encode(x, *args, **kwargs)
    monkeypatch.setattr(model.pos_encoding, "forward", spy)
    cam = cs.orbit_camera(0.4)
    pos, rays = cs.capture_ray_positions(renderer, grid.bitfield, cam, RES,
                                         RES, FOCAL)

    # 4 chunks × 4 segments, and the capture is the largest of them
    assert len(received) == 16
    largest = max(received, key=lambda x: x.shape[0])
    assert pos.shape == largest.shape and pos.shape[0] > 1000
    assert torch.equal(pos, largest)
    # stream order: ray-major, and t rising along each ray
    assert rays.shape == (pos.shape[0],)
    assert bool((rays[1:] >= rays[:-1]).all())
    assert int(torch.unique(rays).numel()) > 100
    dist = torch.linalg.vector_norm(pos - torch.from_numpy(cam[:, 3]), dim=-1)
    same_ray = rays[1:] == rays[:-1]
    assert bool((dist[1:][same_ray] > dist[:-1][same_ray]).all())
