"""pyngp compatibility shim (port of ``ngp_tpu/api/pyngp_shim.py``).

The reference's python module surface (ref: src/python_api.cu:306-888)
as a pure-Python module, so a script written against pyngp, such as the
Blender plugin's, runs against the port:

    import ngp_tpu_torch.api.pyngp_shim as ngp
    tb = ngp.Testbed(ngp.TestbedMode.Nerf)          # on the card
    img = tb.request_nerf_render_sync(ngp.RenderRequest(...))

The enums carry the reference's member spellings; the render-request
data model is ``render/multi_nerf.py``'s. A shim ``Testbed`` renders
requests on one ``MultiNerfRenderer`` of its device; one lock serialises
the sync and the async renders on it and ``free_temporary_memory``.
"""
from __future__ import annotations

import enum
import threading
import weakref

import numpy as np
import torch

from ngp_tpu_torch.api.testbed import Testbed as _Testbed
from ngp_tpu_torch.common import BoundingBox  # noqa: F401  (pyngp surface)
from ngp_tpu_torch.common import TestbedMode as _Mode
from ngp_tpu_torch.render.multi_nerf import (  # noqa: F401  (pyngp surface)
    DownsampleInfo, Mask3D, MultiNerfRenderer, NerfDescriptor,
    RenderCameraProperties, RenderOutputProperties, RenderRequest)


class TestbedMode(enum.Enum):
    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"


class RenderMode(enum.IntEnum):
    AO = 0
    Shade = 1
    Normals = 2
    Positions = 3
    Depth = 4
    Distortion = 5
    Cost = 6
    Slice = 7


class RandomMode(enum.IntEnum):
    Random = 0
    Halton = 1
    Sobol = 2
    Stratified = 3


class LossType(enum.IntEnum):
    L2 = 0
    L1 = 1
    Mape = 2
    Smape = 3
    Huber = 4
    LogL1 = 5
    RelativeL2 = 6


class ColorSpace(enum.IntEnum):
    Linear = 0
    SRGB = 1


class TonemapCurve(enum.IntEnum):
    Identity = 0
    ACES = 1
    Hable = 2
    Reinhard = 3


class LensMode(enum.IntEnum):
    Perspective = 0
    OpenCV = 1
    FTheta = 2
    LatLong = 3


class CameraModel(enum.IntEnum):
    # ref order: camera_models.cuh:27-31
    Perspective = 0
    QuadrilateralHexahedron = 1
    SphericalQuadrilateral = 2


class MaskMode(enum.IntEnum):
    Add = 0
    Subtract = 1


class MaskShape(enum.IntEnum):
    Box = 0
    Cylinder = 1
    Sphere = 2
    All = 3


class GroundTruthRenderMode(enum.IntEnum):
    Shade = 0
    Depth = 1


class SDFGroundTruthMode(enum.IntEnum):
    RaytracedMesh = 0
    SpheretracedMesh = 1
    SDFBricks = 2


class NerfActivation(enum.IntEnum):
    # ref order: common.h:114-118
    NoneActivation = 0
    ReLU = 1
    Logistic = 2
    Exponential = 3


class MeshSdfMode(enum.IntEnum):
    Watertight = 0
    Raystab = 1
    PathEscape = 2


# the shim's testbeds, for free_temporary_memory
_testbeds: "weakref.WeakSet[Testbed]" = weakref.WeakSet()


class Testbed(_Testbed):
    """pyngp.Testbed-shaped wrapper: the mode enum's spelling and the
    Blender render entry points, on the card unless ``device`` names
    another device."""

    def __init__(self, mode=TestbedMode.Nerf, *_args, device="cuda"):
        if isinstance(mode, TestbedMode):
            mode = _Mode(mode.value)
        super().__init__(mode, device=device)
        self._render_thread = None
        self._render_lock = threading.Lock()
        self._multi_nerf = None
        self.m_currently_rendering = False
        _testbeds.add(self)

    # Blender API (ref: python_api.cu:191-261)
    def request_nerf_render_sync(self, request: RenderRequest) -> np.ndarray:
        """Render one request → (H, W, 4) f32 numpy (``MultiNerfRenderer``
        with its defaults, on this testbed's device)."""
        with self._render_lock:
            self.m_currently_rendering = True
            try:
                if self._multi_nerf is None:
                    self._multi_nerf = MultiNerfRenderer(device=self.device)
                return self._multi_nerf.render(request)
            finally:
                self.m_currently_rendering = False

    def request_nerf_render_async(self, request: RenderRequest, callback):
        """Render on a thread of its own and pass the frame to
        ``callback``; renders run one at a time."""
        def work():
            callback(self.request_nerf_render_sync(request))
        self._render_thread = threading.Thread(target=work, daemon=True)
        self._render_thread.start()

    def render_with_rolling_shutter(self, camera_transform_start,
                                    camera_transform_end, rolling_shutter,
                                    width, height, spp=1, linear=True):
        """The trained scene with each ray's camera at time A + B·u + C·v
        + D·t between the two transforms, for ``rolling_shutter`` [A, B,
        C, D]; transforms in NeRF (dataset) convention (ref:
        render_with_rolling_shutter_to_cpu, python_api.cu:263; the
        argument order of the binding, :584)."""
        from ngp_tpu_torch.common import linear_to_srgb_np
        from ngp_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp
        ds = self.nerf.training.dataset
        scale = ds.scale if ds is not None else 1.0
        offset = ds.offset if ds is not None else np.zeros(3, np.float32)
        xf_s, xf_e = (nerf_matrix_to_ngp(np.asarray(m, np.float32), scale,
                                         offset)
                      for m in (camera_transform_start, camera_transform_end))
        focal = getattr(self, "_view_focal", np.array([height, height]))
        img = self._nerf_renderer(width, height).render(
            self.trainer.inference_params(), self.trainer.grid.bitfield,
            xf_s, width, height, focal=(float(focal[0]), float(focal[1])),
            spp=spp, camera_matrix_end=xf_e,
            rolling_shutter=tuple(float(x) for x in rolling_shutter))
        img = img.cpu().numpy()
        if not linear:
            rgb = linear_to_srgb_np(np.clip(img[..., :3], 0, 1))
            img = np.concatenate([rgb, img[..., 3:]], -1).astype(np.float32)
        return img


def free_temporary_memory():
    """Drop every shim testbed's loaded fields (each waits for its render
    in flight) and release the card's cached blocks
    (``torch.cuda.empty_cache``)."""
    for tb in list(_testbeds):
        with tb._render_lock:
            if tb._multi_nerf is not None:
                tb._multi_nerf.fields.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
