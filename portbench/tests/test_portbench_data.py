"""The seeded data repeat bit for bit, and the frozen packing matches the
program's."""
import numpy as np
import torch

from portbench.lib import scenes, weights
from portbench.lib import geometry as geo

SCENE = {"scene_seed": 7, "n_spheres": 6, "radius_range": [0.04, 0.15],
         "centre_range": [0.2, 0.8], "n_views": 3, "n_held_out": 2,
         "resolution": 24, "camera_angle_x": 0.6911, "camera_radius": 1.5,
         "height_range": [0.05, 0.95]}
IMAGE = {"image_seed": 11, "resolution": 64, "grating_px": 12, "n_discs": 5,
         "disc_radius_range": [0.01, 0.08]}


def test_views_and_orbit_repeat():
    xfs, held = scenes.orbit(SCENE)
    xfs2, held2 = scenes.orbit(SCENE)
    assert np.array_equal(xfs, xfs2) and np.array_equal(held, held2)
    a = scenes.views(SCENE, xfs, "cpu")
    assert torch.equal(a, scenes.views(SCENE, xfs, "cpu"))
    assert a.shape == (3, 24, 24, 4) and a.dtype == torch.uint8
    # opaque spheres on a transparent background: alpha is 0 or 255
    assert set(a[..., 3].unique().tolist()) == {0, 255}
    other = scenes.views({**SCENE, "scene_seed": 8}, xfs, "cpu")
    assert not torch.equal(a, other)


def test_cameras_look_at_the_centre():
    xfs, _ = scenes.orbit(SCENE)
    for xf in xfs:
        fwd = np.array([0.5, 0.5, 0.5]) - xf[:, 3]
        assert np.allclose(xf[:, 2], fwd / np.linalg.norm(fwd), atol=1e-6)
        assert xf[2, 3] > 0.5          # the upper hemisphere


def test_image_repeats():
    a = scenes.synth_image(IMAGE, "cpu")
    assert torch.equal(a, scenes.synth_image(IMAGE, "cpu"))
    assert a.shape == (64, 64, 3) and a.dtype == torch.uint8
    assert not torch.equal(a, scenes.synth_image({**IMAGE, "image_seed": 12},
                                                 "cpu"))


def test_weights_repeat():
    meta = geo.GridMeta(3, 2, 16, 1.5, 6)
    shapes = {"pos_encoding.table": (2, 64, 128), "density_net.weights.0":
              (4, 8), "density_net.weights.1": (8, 16)}
    a = weights.draw(shapes, 2 ** 33 + 5, "cpu")
    b = weights.draw(shapes, 2 ** 33 + 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["pos_encoding.table"].abs().max()) <= 1e-4
    c = weights.draw(shapes, 2 ** 33 + 6, "cpu", table=(0.0, 1.0),
                     density=(0.0, 0.5))
    assert float(c["density_net.weights.0"].min()) >= 0.0
    assert float(c["pos_encoding.table"].min()) >= 0.0
    assert meta.rows == 64


def test_sphere_cells_hold_the_surface():
    occ = scenes.sphere_occupancy(SCENE, "cpu")
    sph = scenes.spheres(SCENE, "cpu")
    g = torch.Generator().manual_seed(0)
    d = torch.randn((64, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    for c, r in zip(sph["centres"], sph["radii"]):
        p = c + r * d
        i = (p * scenes.GRID).long().clamp(0, scenes.GRID - 1)
        assert occ[(i[:, 2] * scenes.GRID + i[:, 1]) * scenes.GRID
                   + i[:, 0]].all()


def test_bitfield_packing_matches_the_program():
    from ngp_tpu_torch.grid import occupancy as occ
    g = torch.Generator().manual_seed(3)
    cells = torch.rand(occ.GRID_VOLUME, generator=g) < 0.3
    grid = occ.init_grid(0, "cpu")
    # density above the threshold where a cell is occupied
    grid = occ.rebuild_bitfield(grid._replace(
        density=torch.where(cells, 1.0, 0.0)))
    assert torch.equal(scenes.pack_bitfield(cells), grid.bitfield)


def test_bitfield_unpacks_to_its_cells():
    g = torch.Generator().manual_seed(4)
    cells = torch.rand(scenes.GRID ** 3, generator=g) < 0.5
    assert torch.equal(scenes.unpack_bitfield(scenes.pack_bitfield(cells)),
                       cells)
