"""Faults planted in the program underneath a run, to show that the
comparison with the plain reference catches them. Each is a context
manager that patches the program while it is held.

- ``frozen_state``: every optimizer step returns its state unchanged.
- ``frozen_ema``: every optimizer step updates the parameters and the
  moments but leaves the moving average of the parameters (Ema), which
  inference uses, as it was.
- ``half_batch``: a training step takes the first half of its rays or
  positions and the mean over them; a frame leaves half its pixels out.
- ``altered_answer``: a frame comes back with a block of pixels changed
  where the renderer produces it.
"""
from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def _patched(path: str, attr: str, make):
    owner = importlib.import_module(path)
    *outer, name = attr.split(".")
    for part in outer:
        owner = getattr(owner, part)
    fn = getattr(owner, name)
    setattr(owner, name, make(fn))
    try:
        yield
    finally:
        setattr(owner, name, fn)


@contextlib.contextmanager
def frozen_state():
    def make(fn):
        def apply_update(params, grads, state, *a, **kw):
            return state
        return apply_update
    with _patched("ngp_tpu_torch.train.nerf", "apply_update", make), \
            _patched("ngp_tpu_torch.train.image", "apply_update", make):
        yield


@contextlib.contextmanager
def frozen_ema():
    def make(fn):
        def apply_update(params, grads, state, *a, **kw):
            kept = state.ema_params
            spare = {k: e.clone() for k, e in kept.items()}
            out = fn(params, grads, state._replace(ema_params=spare), *a,
                     **kw)
            return out._replace(ema_params=kept)
        return apply_update
    with _patched("ngp_tpu_torch.train.nerf", "apply_update", make):
        yield


def _half_frame(fn):
    def render(*a, **kw):
        img = fn(*a, **kw)
        img[img.shape[0] // 2:] = 0
        return img
    return render


def _altered_frame(fn):
    def render(*a, **kw):
        img = fn(*a, **kw)
        h, w = img.shape[:2]
        img[h // 4:h // 4 + 8, w // 4:w // 4 + 8] += 0.05
        return img
    return render


@contextlib.contextmanager
def half_batch():
    def nerf_step(fn):
        def _step_grads(self, draws, *a, **kw):
            return fn(self, draws.head(draws.u_img.shape[0] // 2), *a, **kw)
        return _step_grads

    def image_step(fn):
        def step(self, pos=None):
            pos = self.sample_batch() if pos is None else pos
            return fn(self, pos[:pos.shape[0] // 2])
        return step
    with _patched("ngp_tpu_torch.train.nerf", "NerfTrainer._step_grads",
                  nerf_step), \
            _patched("ngp_tpu_torch.train.image", "ImageTrainer.step",
                     image_step), \
            _patched("ngp_tpu_torch.render.nerf_render",
                     "NerfRenderer.render", _half_frame), \
            _patched("ngp_tpu_torch.train.image", "ImageTrainer.render",
                     _half_frame):
        yield


@contextlib.contextmanager
def altered_answer():
    with _patched("ngp_tpu_torch.render.nerf_render", "NerfRenderer.render",
                  _altered_frame), \
            _patched("ngp_tpu_torch.train.image", "ImageTrainer.render",
                     _altered_frame):
        yield


FAULTS = {"frozen_state": frozen_state, "frozen_ema": frozen_ema,
          "half_batch": half_batch, "altered_answer": altered_answer}
