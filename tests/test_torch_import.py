"""The port imports torch and numpy only: every module of ngp_tpu_torch
imports in a process where ``import jax`` fails, and loads no ngp_tpu
module."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import ngp_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    names = sorted(m.name for m in pkgutil.walk_packages(
        ngp_tpu_torch.__path__, "ngp_tpu_torch."))
    for name in ("render.nerf_render", "render.buffer", "io.camera_path",
                 "api.testbed", "__main__", "run", "render.multi_nerf",
                 "api.pyngp_shim", "kernels.hashgrid", "rays.sampling",
                 "train.image", "train.sdf", "data.mesh",
                 "render.sdf_render", "data.nanovdb", "data.nanovdb_write",
                 "train.volume", "render.volume_render",
                 "render.mesh_export", "render.playback", "nn.takikawa",
                 "utils.flip", "utils.profiling", "utils.debug",
                 "dist.mesh", "dist.nerf_dp", "dist.tp_nerf", "dist.tp_image",
                 "dist.multi_scene"):
        assert f"ngp_tpu_torch.{name}" in names
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",     # any `import jax` now raises
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "bad = [m for m in sys.modules",
        "       if m == 'ngp_tpu' or m.startswith(('ngp_tpu.', 'jax.'))]",
        "assert not bad, bad",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
