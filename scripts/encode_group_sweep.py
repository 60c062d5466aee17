#!/usr/bin/env python3
"""Times K1 (encode forward) and K2 (table backward) of
``ngp_tpu_torch/csrc/blocked_grid_encode.cu`` at each level group G of a
sweep, beside an earlier version of that source, on one NVIDIA GPU.

    python3 scripts/encode_group_sweep.py [--baseline OLD.cu]
        [--sources OTHER.cu ...] [--groups 4 8 16]

For each G the source, and each of ``--sources`` (other versions of it
with the same entry points), is copied with ``kGroupFwd = kGroupBwd = G``
and built into ``build/ngp_tpu_torch/sweep/``. ``--baseline`` builds an
earlier version of the source whose K1 and K2 entry points take no launch
plan (one thread per (sample, level), a grid of (N/256, L)). Every library
is checked against the plain versions, with chip_smoke.py's tolerances, on
chip_smoke.py's inputs: 2^20 uniform positions for K1 and 2^18 for K2, with
the edge positions, and the render path's ray-ordered positions
(``chip_smoke.ray_ordered_inputs``). Then each case is timed by CUDA events
in turns (baseline, each G, each G in reverse, baseline), and K2 also with
the cotangents of the dense levels alone and of the hashed levels alone (a
zero cotangent adds nothing), and the zero fill of K2's output alone. Prints a line per measurement, each library's registers and
spills, and the atomics the compiler emitted for K2 where ``cuobjdump`` is
found.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ngp_tpu_torch.kernels import blocked_grid_cuda as bgc  # noqa: E402
from ngp_tpu_torch.kernels.blocked_grid import LANES  # noqa: E402

SWEEP_DIR = bgc.BUILD_DIR / "sweep"
ITERS = 20


def _with_groups(src: str, group: int) -> str:
    for k in ("kGroupFwd", "kGroupBwd"):
        src, n = re.subn(rf"constexpr int {k} = \d+;",
                         f"constexpr int {k} = {group};", src)
        if n != 1:
            raise RuntimeError(f"{k} not found once in the source")
    return src


def _build(name: str, src: str):
    path = SWEEP_DIR / f"{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    out = SWEEP_DIR / f"lib{name}.so"
    log = bgc.compile_library([path], out)
    print(f"sweep: built {name}: {cs.kernel_registers(log)}")
    return out


def _k2_atomics(lib_path: Path) -> str:
    """The reduction and atomic instructions of K2's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    ops, inside = {}, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "blocked_grid_encode_bwd_kernel" in ln
        elif inside:
            m = re.search(r"\b((?:RED|ATOM)\S*)", ln)
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())) or "none"


class Baseline:
    """K1 and K2 of an earlier source: entry points without a plan."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (self.lib.ngp_blocked_grid_encode_fwd,
                   self.lib.ngp_blocked_grid_encode_bwd):
            fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci

    def fwd(self, table, pos, meta):
        out = torch.empty((pos.shape[0], meta.n_levels * 2),
                          dtype=torch.float32, device=pos.device)
        args, _keep = bgc._level_args(meta, pos)
        if self.lib.ngp_blocked_grid_encode_fwd(
                pos.data_ptr(), table.data_ptr(), out.data_ptr(), *args):
            raise RuntimeError("baseline K1 launch failed")
        return out

    def bwd(self, pos, grad, meta):
        dtable = torch.zeros((meta.n_levels, meta.rows, LANES),
                             dtype=torch.float32, device=pos.device)
        args, _keep = bgc._level_args(meta, pos)
        if self.lib.ngp_blocked_grid_encode_bwd(
                pos.data_ptr(), grad.data_ptr(), dtable.data_ptr(), *args):
            raise RuntimeError("baseline K2 launch failed")
        return dtable


@contextmanager
def active(variant):
    """bgc.launch_fwd / launch_bwd run ``variant``: a Baseline, or a
    library of the current source (through the wrappers themselves)."""
    if isinstance(variant, Baseline):
        with mock.patch.object(bgc, "launch_fwd", variant.fwd), \
                mock.patch.object(bgc, "launch_bwd", variant.bwd):
            yield
    else:
        with mock.patch.object(bgc, "_lib", variant):
            yield


def _level_cotangent(cot, meta, keep):
    """``cot`` with the cotangent of every level not in ``keep`` zeroed."""
    out = cot.clone().view(cot.shape[0], meta.n_levels, 2)
    drop = [l for l in range(meta.n_levels) if l not in keep]
    out[:, drop] = 0.0
    return out.view(cot.shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier blocked_grid_encode.cu (no launch plan)")
    ap.add_argument("--sources", type=Path, nargs="*", default=[],
                    help="other versions of the source, same entry points")
    ap.add_argument("--groups", type=int, nargs="+", default=[4, 8, 16])
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda", 0)

    sources = {"": bgc.CSRC / "blocked_grid_encode.cu"}
    sources.update({f"{p.stem}-": p for p in args.sources})
    variants, names, atomics = [], [], {}
    if args.baseline:
        path = _build("baseline", args.baseline.read_text())
        variants.append(Baseline(path))
        names.append("baseline")
        atomics["baseline"] = _k2_atomics(path)
    for label, src in sources.items():
        for g in args.groups:
            name = f"{label}G{g}"
            path = _build(name, _with_groups(src.read_text(), g))
            variants.append(bgc.load_library(path))
            names.append(name)
            atomics[name] = _k2_atomics(path)
    for n, a in atomics.items():
        print(f"sweep: {n}: K2's atomics in SASS: {a}")

    meta, table, pos_u, _ = cs._full_width_inputs(dev, 1 << 20)
    _, _, pos_u2, _ = cs._full_width_inputs(dev, 1 << 18)
    cot_u = cs._cotangent(dev, meta, pos_u2.shape[0], cs.SEED + 1)
    ray = cs.ray_ordered_inputs(dev)
    for name, v in zip(names, variants):
        with active(v):
            cs.check_k1(table, pos_u, meta, f"{name} uniform+edge")
            cs.check_k1(table, ray["k1_pos"], meta, f"{name} ray-ordered")
            cs.check_k2(pos_u2, cot_u, meta, f"{name} uniform+edge")
            cs.check_k2(ray["k2_pos"], ray["k2_cot"], meta,
                        f"{name} ray-ordered")

    dense = [l for l in range(meta.n_levels) if meta.level_is_dense[l]]
    hashed = [l for l in range(meta.n_levels) if l not in dense]
    p1, c1 = pos_u2[: 1 << 18], cot_u[: 1 << 18]
    p2, c2 = ray["k2_pos"], ray["k2_cot"]
    k1 = lambda p: lambda: bgc.launch_fwd(table, p, meta)  # noqa: E731
    k2 = lambda p, c: lambda: bgc.launch_bwd(p, c, meta)  # noqa: E731
    cases = {
        "K1 uniform": k1(pos_u[: 1 << 20]),
        "K1 ray": k1(ray["k1_pos"]),
        "K2 uniform": k2(p1, c1),
        "K2 ray": k2(p2, c2),
        f"K2 uniform, dense levels {dense[0]}-{dense[-1]} alone":
            k2(p1, _level_cotangent(c1, meta, dense)),
        f"K2 uniform, hashed levels {hashed[0]}-{hashed[-1]} alone":
            k2(p1, _level_cotangent(c1, meta, hashed)),
        f"K2 ray, dense levels {dense[0]}-{dense[-1]} alone":
            k2(p2, _level_cotangent(c2, meta, dense)),
        f"K2 ray, hashed levels {hashed[0]}-{hashed[-1]} alone":
            k2(p2, _level_cotangent(c2, meta, hashed)),
    }
    times = {case: {n: [] for n in names} for case in cases}
    order = list(zip(names, variants))
    with torch.no_grad():
        fill = [cs._cuda_time_ms(lambda: torch.zeros(
            (meta.n_levels, meta.rows, LANES), device=dev), ITERS)
            for _ in range(2)]
        print(f"sweep: K2's zero fill of {meta.n_params * 4 / 2**20:.0f} MiB "
              f"alone: {fill[0]:.4f}/{fill[1]:.4f} ms")
        for case, fn in cases.items():
            for name, v in order + order[::-1]:
                with active(v):
                    fn()
                    times[case][name].append(cs._cuda_time_ms(fn, ITERS))
            print(f"sweep: {case}: " + "; ".join(
                f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                for n, t in times[case].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
