#!/usr/bin/env python3
"""Times the kernels of ``ngp_tpu_torch/csrc/blocked_grid_encode.cu`` (K1
encode forward, K2 table backward, K3 position backward, K4 int8-table
forward, K5 int8 table backward) at each level group G of a sweep, beside
an earlier version of that source, on one NVIDIA GPU.

    python3 scripts/encode_group_sweep.py [--baseline OLD.cu]
        [--sources OTHER.cu ...] [--groups 4 8 16] [--kernels K3]
        [--plans SMEM_KIB:CHUNK[:GROUP] fwd:SAMPLES:WALK ...]

For each G the source, and each of ``--sources`` (other versions of it with
the same entry points), is copied with every level group (``kGroupFwd``,
``kGroupBwd``, ``kGroupPos``, ``kGroupI8``, ``kGroupI8Bwd``) set to G (G
0: each source's own groups) and built into
``build/ngp_tpu_torch/sweep/``, all builds at once.
``--baseline`` builds an earlier version of the source whose K1, K2, K4
and K5 take a launch plan and whose K3 does not (one thread per sample
over the levels, a grid of N/256 blocks): the parent of the K3 redesign,
commit 1f1d465. A version in ``--sources`` without the 2D table
backward's entry point (``ngp_blocked_grid_table_bwd_2d``: the sources
before its redesign) runs its 2D K2 and K5 as they were launched then:
one thread per (sample, level) in its level groups, K5 in two passes
over a zeroed tile_max; one without the 2D encode forward
(``blocked_grid_encode_fwd_2d_kernel``) runs its 2D K1 and K4 so too, and
one without the 2D position backward
(``blocked_grid_encode_bwd_pos_2d_kernel``) its 2D K3: pairs in its K3
level group, with partial sums and a second pass where the group does not
cover every level.
``--plans`` times the tree's 2D table backward under other plans too
(``blocked_grid_cuda.TABLE_BWD_SMEM`` in KiB, ``TABLE_BWD_CHUNK``,
``TABLE_BWD_GROUP`` and ``_I8``: levels a block), and, for specs
``fwd:SAMPLES:WALK``, its 2D encode forward and 2D position backward
under other plans (``FWD_2D_SAMPLES`` and ``FWD_2D_LEVELS_PER_WARP``, the
plan of K1, K3 and K4 on 2D grids: the tile and the most levels each warp
walks; 32: one thread a sample), on the first G's library.

Inputs, at the full NeRF width: K1 at 2^20 uniform and ray-ordered
positions, K2 and K3 at 2^18 of each (``chip_smoke.ray_ordered_inputs``,
K3 with K2's cotangent) and K3 also on the inputs of one camera-optimising
step of a trainer with pose, exposure and focal optimisation and
``encode_int8="full"``, trained ``TRAIN_STEPS`` steps on the sphere views
with seeded pose errors (the pose phase of chip_smoke.py); K4 at 2^20 and
2^18 uniform positions and on the grid sweep's own positions (the first
2^18-position call of a full and of a partial sweep,
``chip_smoke.sweep_ordered_inputs``); K5 at 2^18 uniform positions and on
the positions and cotangent of one training step of a trainer with
``encode_int8="full"`` trained ``TRAIN_STEPS`` steps on the sphere views.
``K2-2d`` and ``K5-2d``: the 2D K2 on one step of an ImageTrainer
(configs/image/base.json, chip_smoke.py's seeded 2048² image, trained
``IMAGE_STEPS`` steps) in f32 and at 2^18 and 2^20 uniform positions, the
2D K5 on one step of such a trainer under ``encode_int8="full"`` (its
tile, ``eff_tile``) and at 2^18 uniform positions in tiles of 2048 (the
steps' inputs as ``chip_smoke.capture_image_step`` takes them).
``K1-2d`` and ``K4-2d``: the 2D K1 on one step of the f32 ImageTrainer
(its stratified batch and trained table), the 2D K4 on one step of the
``full`` one (its table quantised as the step quantises it), each also
on the first 2^18 pixel centres of a 2048² frame
(``chip_smoke.pixel_chunk``: an eval chunk, row-major) and at 2^20
uniform positions. ``K3-2d``: the 2D K3 on one step of the ``full``
ImageTrainer (its table, stratified batch and cotangent), on its field's
gradient by uv at the 512² pixel centres (``chip_smoke.uv_gradient_inputs``:
the table, positions and cotangent the encoding got) and at 2^18 uniform
positions with a seeded cotangent. Every case also prints each variant's
max |Δ| to the output of the first ``--sources`` version (or of the
tree's, without one).
Every library is first checked against the plain versions with
chip_smoke.py's tolerances (K3 also against a second launch of itself:
bit-equal). Then each case is timed in turns (baseline, each variant, each
variant in reverse, baseline) by CUDA-graph replays
(``chip_smoke._graph_time_ms``: device time, without the wrappers' host
overhead, which is as long as the smaller cases' kernels), and its plain
version twice by CUDA events, beside the case's bound
(``chip_smoke.kernel_bytes`` at the card's memory rate). With K4, the K5
trainer's full and partial grid sweeps are traced last with the table
quantised once and once per network call (as before the sweep took a
quantised pair), in turns: device and wall ms per sweep. Prints a line per measurement, each library's registers and spills, and,
where ``cuobjdump`` is found, a summary of its SASS: the reductions and
atomics of K2, K3 and K5, and the 2D encode forward's instruction count
with its loads, stores, conversions and permutes.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc  # noqa: E402
from ngp_tpu_torch.kernels.blocked_grid import (  # noqa: E402
    DEFAULT_TILE, eff_tile, encode_backward_reference,
    encode_backward_reference_i8,
    encode_position_backward_reference, encode_reference,
    encode_reference_i8, quantize_table_i8)

SWEEP_DIR = bgc.BUILD_DIR / "sweep"
ITERS = 20
GROUP_CONSTANTS = ("kGroupFwd", "kGroupBwd", "kGroupPos", "kGroupI8",
                   "kGroupI8Bwd")
FWD_2D_KERNEL = "blocked_grid_encode_fwd_2d_kernel"
POS_2D_KERNEL = "blocked_grid_encode_bwd_pos_2d_kernel"
TRAIN_VIEWS, TRAIN_RES, TRAIN_STEPS = 24, 128, 512
IMAGE_STEPS = 256


def _with_groups(src: str, group: int) -> str:
    """``src`` with every level group set to ``group`` (0: as it is)."""
    if group == 0:
        return src
    for k in GROUP_CONSTANTS:
        src, n = re.subn(rf"constexpr int {k} = \d+;",
                         f"constexpr int {k} = {group};", src)
        if n != 1:
            raise RuntimeError(f"{k} not found once in the source")
    return src


def _build_all(sources: dict) -> dict:
    """nvcc every {name: source text} at once; returns {name: library}."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)

    def one(item):
        name, src = item
        path = SWEEP_DIR / f"{name}.cu"
        path.write_text(src)
        out = SWEEP_DIR / f"lib{name}.so"
        return name, out, bgc.compile_library([path], out)
    with ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(one, sources.items()))
    for name, _, log in built:
        print(f"sweep: built {name}: {cs.kernel_registers(log)}")
    return {name: out for name, out, _ in built}


# the 2D encode forward's instructions _sass counts by opcode
FWD_2D_OPS = ("LDG", "LDC", "STS", "LDS", "STG", "I2F", "PRMT", "FFMA",
              "FMUL", "FADD")


def _sass(lib_path: Path) -> str:
    """The reduction and atomic instructions of K2's, K3's and K5's SASS
    (the 2D table backward's shared-memory ones among them), and the
    instruction counts, with those of FWD_2D_OPS, of the 2D encode
    forward and of the 2D K3 (the 2D position backward, or the pair
    kernel of older sources at D = 2)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    ops, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((k for k, name in (
                ("K1 2D", f"{FWD_2D_KERNEL}ILb0"),
                ("K4 2D", f"{FWD_2D_KERNEL}ILb1"),
                ("K2 2D", "blocked_grid_encode_bwd_2d_kernelILb0"),
                ("K5 2D", "blocked_grid_encode_bwd_2d_kernelILb1"),
                ("K2", "blocked_grid_encode_bwd_kernel"),
                ("K3 2D", POS_2D_KERNEL),
                ("K3 pair 2D", "blocked_grid_encode_bwd_pos_kernelILi2E"),
                ("K3", "blocked_grid_encode_bwd_pos"),
                ("K5 pass 1", "blocked_grid_encode_bwd_i8_max_kernel"),
                ("K5 pass 2", "blocked_grid_encode_bwd_i8_kernel"))
                if name in ln), None)
        elif fn:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9]*)(\S*)", ln)
            if not m:
                continue
            op = m.group(1)
            if fn.endswith("2D") and fn[:2] in ("K1", "K3", "K4"):
                keys = [f"{fn} all"] + [f"{fn} {op}"] * (op in FWD_2D_OPS)
            else:
                keys = [f"{fn} {op}{m.group(2)}"] * op.startswith(("RED",
                                                                   "ATOM"))
            for key in keys:
                ops[key] = ops.get(key, 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "none"


class Baseline:
    """An earlier source: K1, K2, K4 and K5 through the current wrappers
    (the same planned entry points), K3 through its own plan-less one."""

    def __init__(self, path: Path):
        self.lib = bgc.load_library(path)
        # a second handle, so this entry point keeps its own signature
        raw = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.k3 = raw.ngp_blocked_grid_encode_bwd_pos
        self.k3.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        self.k3.restype = ci

    def bwd_pos(self, table, pos, grad, meta):
        dpos = torch.empty((pos.shape[0], 3), dtype=torch.float32,
                           device=pos.device)
        args, _keep = bgc._level_args(meta, pos)
        if self.k3(pos.data_ptr(), table.data_ptr(), grad.data_ptr(),
                   dpos.data_ptr(), *args):
            raise RuntimeError("baseline K3 launch failed")
        return dpos


class Parent2D:
    """A library of sources from before the 2D table backward's redesign
    (``old_bwd``), the 2D encode forward's (``old_fwd``) or the 2D
    position backward's (``old_pos``): its 2D K2 and K5, K1 and K4, or K3
    launched as its wrappers launched them (pairs in the library's level
    groups; K5's two passes over a zeroed tile_max; K3's group partials
    and second pass, through the entry point's own signature at ``path``),
    the rest through the current wrappers."""

    def __init__(self, lib, old_bwd: bool, old_fwd: bool, old_pos: bool,
                 path: Path):
        self.lib, self.old_bwd, self.old_fwd = lib, old_bwd, old_fwd
        self.old_pos = old_pos
        self.bwd, self.bwd_i8 = bgc.launch_bwd, bgc.launch_bwd_i8
        self.fwd, self.fwd_i8 = bgc.launch_fwd, bgc.launch_fwd_i8
        self.bwd_pos = bgc.launch_bwd_pos
        if old_pos:
            # a second handle, so this entry point keeps its own signature
            vp, ci = ctypes.c_void_p, ctypes.c_int
            self.k3 = ctypes.CDLL(str(path)).ngp_blocked_grid_encode_bwd_pos_2d
            self.k3.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            self.k3.restype = ci

    def _run(self, kernel: str, pos, meta, *ptrs, tile=None):
        n, lib = pos.shape[0], self.lib
        plan = bgc.launch_plan(n, meta.n_levels, lib.ngp_blocked_grid_group(
            bgc.GROUP_KERNELS.index(kernel)))
        args, _keep = bgc._planned_args(meta, pos, plan)
        if tile is not None:
            args = args[:-1] + [tile.bit_length() - 1, args[-1]]
        fn = getattr(lib, f"ngp_{kernel}_2d")
        if fn(pos.data_ptr(), *ptrs, *args):
            raise RuntimeError(f"parent {kernel}_2d launch failed")
        bgc.launches[f"{kernel}_2d"] += 1

    def launch_bwd(self, pos, grad, meta):
        if meta.n_dims != 2:
            return self.bwd(pos, grad, meta)
        dtable = torch.zeros((meta.n_levels, meta.rows, 128),
                             device=pos.device)
        self._run("blocked_grid_encode_bwd", pos, meta, grad.data_ptr(),
                  dtable.data_ptr())
        return dtable

    def launch_bwd_i8(self, pos, grad, meta, tile):
        if meta.n_dims != 2:
            return self.bwd_i8(pos, grad, meta, tile)
        dtable = torch.zeros((meta.n_levels, meta.rows, 128),
                             device=pos.device)
        tile_max = torch.zeros((meta.n_levels, -(-pos.shape[0] // tile)),
                               dtype=torch.int32, device=pos.device)
        self._run("blocked_grid_encode_bwd_i8", pos, meta, grad.data_ptr(),
                  tile_max.data_ptr(), dtable.data_ptr(), tile=tile)
        return dtable

    def launch_fwd(self, table, pos, meta):
        if meta.n_dims != 2:
            return self.fwd(table, pos, meta)
        out = torch.empty((pos.shape[0], 2 * meta.n_levels),
                          device=pos.device)
        self._run("blocked_grid_encode_fwd", pos, meta, table.data_ptr(),
                  out.data_ptr())
        return out

    def launch_fwd_i8(self, tq, qs, pos, meta):
        if meta.n_dims != 2:
            return self.fwd_i8(tq, qs, pos, meta)
        out = torch.empty((pos.shape[0], 2 * meta.n_levels),
                          device=pos.device)
        self._run("blocked_grid_encode_fwd_i8", pos, meta, tq.data_ptr(),
                  qs.data_ptr(), out.data_ptr())
        return out

    def launch_bwd_pos(self, table, pos, grad, meta):
        if meta.n_dims != 2:
            return self.bwd_pos(table, pos, grad, meta)
        n = pos.shape[0]
        group = self.lib.ngp_blocked_grid_group(
            bgc.GROUP_KERNELS.index("blocked_grid_encode_bwd_pos"))
        plan = bgc.launch_plan(n, meta.n_levels, group)
        dpos = torch.empty((n, 2), device=pos.device)
        partial = (torch.empty((plan.groups, n, 2), device=pos.device)
                   if plan.groups > 1 else None)
        args, _keep = bgc._planned_args(meta, pos, plan)
        if self.k3(pos.data_ptr(), table.data_ptr(), grad.data_ptr(),
                   dpos.data_ptr(),
                   None if partial is None else partial.data_ptr(), *args):
            raise RuntimeError("parent blocked_grid_encode_bwd_pos_2d launch "
                               "failed")
        bgc.launches["blocked_grid_encode_bwd_pos_2d"] += 1
        return dpos

    def patches(self) -> dict:
        """The wrappers this library replaces."""
        names = (["launch_bwd", "launch_bwd_i8"] if self.old_bwd else []) \
            + (["launch_fwd", "launch_fwd_i8"] if self.old_fwd else []) \
            + (["launch_bwd_pos"] if self.old_pos else [])
        return {k: getattr(self, k) for k in names}


@contextmanager
def active(variant):
    """The wrappers launch ``variant``'s kernels: a Baseline's, a
    Parent2D's, or those of a library of the current source, with a 2D
    table-backward plan ((library, {setting: value}))."""
    if isinstance(variant, Baseline):
        with mock.patch.object(bgc, "_lib", variant.lib), \
                mock.patch.object(bgc, "launch_bwd_pos", variant.bwd_pos):
            yield
    elif isinstance(variant, Parent2D):
        with mock.patch.object(bgc, "_lib", variant.lib), \
                mock.patch.multiple(bgc, **variant.patches()):
            yield
    else:
        lib, settings = variant
        with mock.patch.object(bgc, "_lib", lib), mock.patch.multiple(
                bgc, **settings) if settings else nullcontext():
            yield


def _plan_settings(spec: str) -> dict:
    """``SMEM_KIB:CHUNK[:GROUP]`` or ``fwd:SAMPLES:WALK`` as
    blocked_grid_cuda's settings."""
    if spec.startswith("fwd:"):
        samples, walk = (int(v) for v in spec.split(":")[1:])
        return {"FWD_2D_SAMPLES": samples, "FWD_2D_LEVELS_PER_WARP": walk}
    smem, chunk, *group = (int(v) for v in spec.split(":"))
    return {"TABLE_BWD_SMEM": smem << 10, "TABLE_BWD_CHUNK": chunk,
            "TABLE_BWD_GROUP": group[0] if group else bgc.TABLE_BWD_GROUP,
            "TABLE_BWD_GROUP_I8": group[0] if group
            else bgc.TABLE_BWD_GROUP_I8}


_image_steps = {}


def image_step_inputs(dev, mode: str):
    """An ImageTrainer (configs/image/base.json, encode_int8 ``mode``) on
    chip_smoke.py's seeded image, trained IMAGE_STEPS steps: its grid, the
    positions and cotangent its encoding gets in one more step, its
    trained table, and the trainer; one trainer per mode."""
    if mode in _image_steps:
        return _image_steps[mode]
    from ngp_tpu_torch.common import srgb_to_linear_np
    from ngp_tpu_torch.config import load_network_config
    from ngp_tpu_torch.train.image import ImageTrainer
    img = srgb_to_linear_np(cs.synth_image().astype(np.float32) / 255.0)
    tr = ImageTrainer(img, load_network_config(
        ROOT / "configs/image/base.json"), device=dev, encode_int8=mode)
    tr.train(IMAGE_STEPS)
    pos, cot = cs.capture_image_step(tr)
    print(f"sweep: image trainer ({mode or 'f32'}) after "
          f"{tr.training_step} steps, loss {tr.last_loss:.4e}; one step's "
          f"encode inputs: {pos.shape[0]} samples")
    _image_steps[mode] = (tr.model.encoding.meta, pos, cot,
                          tr.params["encoding.table"].detach(), tr)
    return _image_steps[mode]


def step_inputs(dev, launch: str, **options):
    """A trainer (``chip_smoke.make_trainer`` with ``options``) trained
    TRAIN_STEPS steps on the sphere views, their poses perturbed as the
    pose phase perturbs them where it optimises them, and the arguments of
    the wrapper ``launch`` in one step of it."""
    ds = cs.build_sphere_dataset(dev, TRAIN_VIEWS, TRAIN_RES)
    if options.get("optimize_extrinsics"):
        ds = dataclasses.replace(
            ds, xforms=cs.perturb_poses(ds.xforms, cs.SEED + 6),
            xforms_end=None)
    tr = cs.make_trainer(ds, dev, **options)
    tr.train(TRAIN_STEPS)
    args = cs.capture_step(tr, cs.SEED + 5, launch)[1][launch]
    pos = args[1] if launch == "launch_bwd_pos" else args[0]
    print(f"sweep: trainer ({', '.join(options)}) after {tr.training_step} "
          f"steps; one step's {launch} inputs: {pos.shape[0]} samples")
    return tr, args


def _check_k5(pos, cot, meta, tile, what: str):
    got = bgc.launch_bwd_i8(pos, cot, meta, tile)
    torch.cuda.synchronize()
    rel = cs.check_i8_grad(pos, cot, meta, tile, got)[0]
    print(f"K5: {what}: max relative to sum_t scale_t*sum|q| {rel:.3e} "
          f"(tolerance {cs.KERNEL_I8_TOL}); exact zeros where every q is 0")
    if not rel <= cs.KERNEL_I8_TOL:
        raise RuntimeError(f"K5 disagrees with its plain version ({what})")


def _traced(fn):
    """(device ms, wall ms) of one call of ``fn`` under torch.profiler: the
    device time is the sum of every kernel, copy and fill it ran."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return cs._attribute_kernels(prof, set(), "")[2], wall


def time_grid_sweep(tr):
    """A full and a partial grid sweep of ``tr`` with the table quantised
    once and once per network call (as the sweep did before it took a
    quantised pair), traced in turns (once, per call, per call, once):
    device ms and wall ms per sweep. And the quantisation alone (CUDA
    events)."""
    table = tr.model.pos_encoding.table
    density = tr.model.density

    def per_call(pos01, quantized=None, **kw):
        return density(pos01, int8="fwd" if quantized is not None else "",
                       **kw)
    grid = tr.grid
    with torch.no_grad():
        for full in (True, False):
            def once():
                tr._grid_update(full)

            def chunked():
                with mock.patch.object(tr.model, "density", per_call):
                    tr._grid_update(full)
            modes = {"once": once, "per call": chunked}
            once()
            times = {k: [] for k in modes}
            for name in list(modes) + list(modes)[::-1]:
                times[name].append(_traced(modes[name]))
            print(f"sweep: {'full' if full else 'partial'} grid sweep, "
                  "table quantised " + "; ".join(
                      f"{k}: device {t[0][0]:.4f}/{t[1][0]:.4f} ms, wall "
                      f"{t[0][1]:.4f}/{t[1][1]:.4f} ms"
                      for k, t in times.items()))
        quant = [cs._cuda_time_ms(lambda: quantize_table_i8(table), 10)
                 for _ in range(2)]
    tr.grid = grid
    print(f"sweep: quantize_table_i8 alone {quant[0]:.4f}/{quant[1]:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier blocked_grid_encode.cu (K3 without a "
                         "launch plan)")
    ap.add_argument("--sources", type=Path, nargs="*", default=[],
                    help="other versions of the source: the same entry "
                         "points, or those from before the 2D table "
                         "backward's redesign")
    ap.add_argument("--groups", type=int, nargs="+",
                    default=list(bgc.SWEPT_GROUPS))
    ap.add_argument("--kernels", nargs="+", default=["K3"],
                    choices=["K1", "K2", "K3", "K4", "K5", "K1-2d", "K2-2d",
                             "K3-2d", "K4-2d", "K5-2d"])
    ap.add_argument("--plans", nargs="*", default=[],
                    help="2D table-backward plans, SMEM_KIB:CHUNK[:GROUP], "
                         "and those of the 2D encode forward and position "
                         "backward, fwd:SAMPLES:WALK")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda", 0)

    sources = {"": bgc.CSRC / "blocked_grid_encode.cu"}
    sources.update({f"{p.stem}-": p for p in args.sources})
    texts = {}
    if args.baseline:
        texts["baseline"] = args.baseline.read_text()
    for label, path in sources.items():
        src = path.read_text()
        for g in args.groups:
            texts[f"{label}G{g}"] = _with_groups(src, g)
    first = f"G{args.groups[0]}"
    with ThreadPoolExecutor(1) as ex:
        own = ex.submit(bgc.build)     # the tree's library, for the sweep
        libs = _build_all(texts)
        own.result()
    variants = {}
    for name, path in libs.items():
        if name == "baseline":
            variants[name] = Baseline(path)
            continue
        lib = bgc.load_library(path)
        old_bwd = not hasattr(lib, "ngp_blocked_grid_table_bwd_2d")
        old_fwd = FWD_2D_KERNEL not in texts[name]
        old_pos = POS_2D_KERNEL not in texts[name]
        variants[name] = (Parent2D(lib, old_bwd, old_fwd, old_pos, path)
                          if old_bwd or old_fwd or old_pos else (lib, {}))
    for spec in args.plans:
        variants[f"{first} plan {spec}"] = (variants[first][0],
                                            _plan_settings(spec))
    for name, path in libs.items():
        print(f"sweep: {name}: SASS: {_sass(path)}")

    meta, table, pos_u, _ = cs._full_width_inputs(dev, 1 << 20)
    _, _, pos_u2, _ = cs._full_width_inputs(dev, 1 << 18)
    cot_u = cs._cotangent(dev, meta, pos_u2.shape[0], cs.SEED + 1)
    with torch.no_grad():
        tq, qs = quantize_table_i8(table)
    # case -> (check, kernel, plain version, kernel name, positions, meta)
    cases = {}
    if {"K1", "K2", "K3"} & set(args.kernels):
        ray = cs.ray_ordered_inputs(dev)
    if "K1" in args.kernels:
        for what, p in (("uniform", pos_u[: 1 << 20]),
                        ("ray", ray["k1_pos"])):
            cases[f"K1 {what}"] = (
                lambda p=p, what=what: cs.check_k1(table, p, meta, what),
                lambda p=p: bgc.launch_fwd(table, p, meta),
                lambda p=p: encode_reference(table, p, meta),
                "blocked_grid_encode_fwd", p, meta)
    if "K2" in args.kernels:
        for what, p, c in (("uniform", pos_u2[: 1 << 18], cot_u[: 1 << 18]),
                           ("ray", ray["k2_pos"], ray["k2_cot"])):
            cases[f"K2 {what}"] = (
                lambda p=p, c=c, what=what: cs.check_k2(p, c, meta, what),
                lambda p=p, c=c: bgc.launch_bwd(p, c, meta),
                lambda p=p, c=c: encode_backward_reference(p, c, meta),
                "blocked_grid_encode_bwd", p, meta)
    if "K3" in args.kernels:
        _, (ptab, pp, pc, pmeta) = step_inputs(
            dev, "launch_bwd_pos", optimize_extrinsics=True,
            optimize_exposure=True, optimize_focal_length=True,
            encode_int8="full")
        cot_3 = cs._cotangent(dev, meta, pos_u2.shape[0], cs.SEED + 3)
        for what, t, p, c, m in (
                ("uniform 2^18", table, pos_u2[: 1 << 18], cot_3[: 1 << 18],
                 meta),
                ("ray 2^18", table, ray["k2_pos"], ray["k2_cot"], meta),
                (f"pose step ({pp.shape[0]})", ptab, pp, pc, pmeta)):
            cases[f"K3 {what}"] = (
                lambda t=t, p=p, c=c, m=m, what=what: cs.check_k3(
                    t, p, c, m, what),
                lambda t=t, p=p, c=c, m=m: bgc.launch_bwd_pos(t, p, c, m),
                lambda t=t, p=p, c=c, m=m: encode_position_backward_reference(
                    t, p, c, m),
                "blocked_grid_encode_bwd_pos", p, m)
    if {"K4", "K5"} & set(args.kernels):
        tr, (sp, sc, smeta, stile) = step_inputs(dev, "launch_bwd_i8",
                                                 encode_int8="full")
        sweep = cs.sweep_ordered_inputs(tr)
    if "K4" in args.kernels:
        for what, p in (("uniform 2^20", pos_u[: 1 << 20]),
                        ("uniform 2^18", pos_u2[: 1 << 18]),
                        ("full-sweep 2^18", sweep["full"]),
                        ("partial-sweep 2^18", sweep["partial"])):
            cases[f"K4 {what}"] = (
                lambda p=p, what=what: cs.check_k4(tq, qs, p, meta, what),
                lambda p=p: bgc.launch_fwd_i8(tq, qs, p, meta),
                lambda p=p: encode_reference_i8(tq, qs, p, meta),
                "blocked_grid_encode_fwd_i8", p, meta)
    if "K5" in args.kernels:
        for what, p, c, m, t in (
                ("uniform 2^18", pos_u2[: 1 << 18], cot_u[: 1 << 18], meta,
                 DEFAULT_TILE),
                (f"one step ({sp.shape[0]})", sp, sc, smeta, stile)):
            cases[f"K5 {what}"] = (
                lambda p=p, c=c, m=m, t=t, what=what: _check_k5(
                    p, c, m, t, what),
                lambda p=p, c=c, m=m, t=t: bgc.launch_bwd_i8(p, c, m, t),
                lambda p=p, c=c, m=m, t=t: encode_backward_reference_i8(
                    p, c, m, t),
                "blocked_grid_encode_bwd_i8", p, m)
    if {"K1-2d", "K4-2d"} & set(args.kernels):
        pix = cs.pixel_chunk(dev)
        uni_f = torch.rand((1 << 20, 2), generator=torch.Generator(
            device=dev).manual_seed(cs.SEED + 11), device=dev)
    if "K1-2d" in args.kernels:
        meta1, p1, _, t1, _ = image_step_inputs(dev, "")
        for what, p in (("image step", p1), ("pixel chunk", pix),
                        ("uniform 2^20", uni_f)):
            cases[f"K1-2d {what}"] = (
                lambda p=p, what=what: cs.check_k1(t1, p, meta1, what),
                lambda p=p: bgc.launch_fwd(t1, p, meta1),
                lambda p=p: encode_reference(t1, p, meta1),
                "blocked_grid_encode_fwd_2d", p, meta1)
    if "K4-2d" in args.kernels:
        meta4, p4, _, t4, _ = image_step_inputs(dev, "full")
        with torch.no_grad():
            tq4, qs4 = quantize_table_i8(t4)
        for what, p in (("full image step", p4), ("pixel chunk", pix),
                        ("uniform 2^20", uni_f)):
            cases[f"K4-2d {what}"] = (
                lambda p=p, what=what: cs.check_k4(tq4, qs4, p, meta4, what),
                lambda p=p: bgc.launch_fwd_i8(tq4, qs4, p, meta4),
                lambda p=p: encode_reference_i8(tq4, qs4, p, meta4),
                "blocked_grid_encode_fwd_i8_2d", p, meta4)
    if "K3-2d" in args.kernels:
        meta3, p3, c3, t3, tr3 = image_step_inputs(dev, "full")
        _, (uv_t, uv_p, uv_c) = cs.uv_gradient_inputs(tr3)
        u3 = torch.rand((1 << 18, 2), generator=torch.Generator(
            device=dev).manual_seed(cs.SEED + 13), device=dev)
        cu3 = cs._cotangent(dev, meta3, 1 << 18, cs.SEED + 14)
        for what, t, p, c in (("full image step", t3, p3, c3),
                              (f"uv gradient ({uv_p.shape[0]})", uv_t, uv_p,
                               uv_c),
                              ("uniform 2^18", t3, u3, cu3)):
            cases[f"K3-2d {what}"] = (
                lambda t=t, p=p, c=c, what=what: cs.check_k3(t, p, c, meta3,
                                                             what),
                lambda t=t, p=p, c=c: bgc.launch_bwd_pos(t, p, c, meta3),
                lambda t=t, p=p, c=c: encode_position_backward_reference(
                    t, p, c, meta3),
                "blocked_grid_encode_bwd_pos_2d", p, meta3)
    if "K2-2d" in args.kernels:
        meta2, p2, c2, _, _ = image_step_inputs(dev, "")
        uni = torch.rand((1 << 20, 2), generator=torch.Generator(
            device=dev).manual_seed(cs.SEED + 6), device=dev)
        cu = cs._cotangent(dev, meta2, 1 << 20, cs.SEED + 7)
        for what, p, c in (("image step", p2, c2),
                           ("uniform 2^18", uni[: 1 << 18], cu[: 1 << 18]),
                           ("uniform 2^20", uni, cu)):
            cases[f"K2-2d {what}"] = (
                lambda p=p, c=c, what=what: cs.check_k2(p, c, meta2, what),
                lambda p=p, c=c: bgc.launch_bwd(p, c, meta2),
                lambda p=p, c=c: encode_backward_reference(p, c, meta2),
                "blocked_grid_encode_bwd_2d", p, meta2)
    if "K5-2d" in args.kernels:
        meta5, p5, c5, _, _ = image_step_inputs(dev, "full")
        u5 = torch.rand((1 << 18, 2), generator=torch.Generator(
            device=dev).manual_seed(cs.SEED + 8), device=dev)
        cu5 = cs._cotangent(dev, meta5, 1 << 18, cs.SEED + 9)
        for what, p, c, t in (("image step", p5, c5, eff_tile(p5.shape[0])),
                              ("uniform 2^18", u5, cu5, DEFAULT_TILE)):
            cases[f"K5-2d {what}"] = (
                lambda p=p, c=c, t=t, what=what: _check_k5(p, c, meta5, t,
                                                           what),
                lambda p=p, c=c, t=t: bgc.launch_bwd_i8(p, c, meta5, t),
                lambda p=p, c=c, t=t: encode_backward_reference_i8(
                    p, c, meta5, t),
                "blocked_grid_encode_bwd_i8_2d", p, meta5)
    for name, v in variants.items():
        with active(v), torch.no_grad():
            print(f"sweep: checking {name}")
            for check, *_ in cases.values():
                check()
    # each variant's output against the first --sources version's
    ref_name = next((n for n in variants if n.endswith(f"-{first}")), first)
    with torch.no_grad():
        for case, (_, fn, *_) in cases.items():
            with active(variants[ref_name]):
                ref = fn().clone()
            diffs = []
            for name, v in variants.items():
                with active(v):
                    err = float((fn() - ref).abs().max())
                diffs.append(f"{name} {err:.3e}")
            print(f"sweep: {case}: max |output - {ref_name}'s|: "
                  + "; ".join(diffs))
            del ref

    order = list(variants.items())
    times = {case: {n: [] for n in variants} for case in cases}
    with torch.no_grad():
        for case, (_, fn, plain, kernel, p, m) in cases.items():
            for name, v in order + order[::-1]:
                with active(v):
                    times[case][name].append(cs._graph_time_ms(fn, ITERS))
            plain()
            plain_ms = [cs._cuda_time_ms(plain, 2) for _ in range(2)]
            n_bytes = cs.kernel_bytes(kernel, m, p)
            bound_ms, bound_by = cs.kernel_bound(kernel, p.shape[0], m,
                                                 n_bytes)
            print(f"sweep: {case}: " + "; ".join(
                f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                for n, t in times[case].items())
                + f"; plain {plain_ms[0]:.4f}/{plain_ms[1]:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB, {bound_by})")
    if "K4" in args.kernels:
        time_grid_sweep(tr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
