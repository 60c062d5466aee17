"""Headless CLI — the `testbed` equivalent (port of ``ngp_tpu/__main__.py``;
ref: src/main.cu:29-238).

    python -m ngp_tpu_torch --scene data/nerf/fox --n_steps 2000 \\
        --network configs/nerf/base.json --snapshot out.msgpack

The mode is inferred from the scene path like the reference (dir/json →
nerf, obj/stl → sdf, nvdb → volume, image otherwise) or given by
``--mode``; every mode is ported (a screenshot in volume mode raises the
testbed's ValueError, as in the JAX package). The loop prints
``iteration=<n> loss=<l>`` lines like the headless reference. It runs on
the card unless ``--device cpu`` asks for the CPU. ``--n_steps`` is
exact: the JAX package's NeRF trainer runs on to a 16-step boundary, this
one does not. ``NGP_TPU_ENCODE_INT8=fwd|full`` trains and infers through
the int8-quantised grid table in every mode.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="ngp_tpu_torch", description=__doc__)
    p.add_argument("--scene", "-s", default="", help="scene to load")
    p.add_argument("--mode", "-m", default="", help="nerf|sdf|image|volume")
    p.add_argument("--network", "-n", default="", help="network config json")
    p.add_argument("--load_snapshot", default="", help="snapshot to resume")
    p.add_argument("--save_snapshot", "--snapshot", default="")
    p.add_argument("--n_steps", type=int, default=10000)
    p.add_argument("--no_train", action="store_true")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--screenshot", default="", help="render a frame to PNG")
    p.add_argument("--batch_size", type=int, default=1 << 18)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    from ngp_tpu_torch.api.testbed import Testbed, mode_from_scene
    from ngp_tpu_torch.common import TestbedMode

    mode = TestbedMode(args.mode) if args.mode else \
        (mode_from_scene(args.scene) or TestbedMode.NERF)
    tb = Testbed(mode, device=args.device)
    tb.training_batch_size = args.batch_size
    if args.network:
        tb.reload_network_from_file(args.network)
    if args.scene:
        tb.load_training_data(args.scene)
    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
    tb.shall_train = not args.no_train

    report = max(args.n_steps // 50, 1)
    while tb.shall_train and tb.training_step < args.n_steps:
        k = min(report, args.n_steps - tb.training_step)
        loss = tb.train(k)
        print(f"iteration={tb.training_step} loss={loss:.6f}")

    if args.save_snapshot:
        tb.save_snapshot(args.save_snapshot)
        print("saved snapshot:", args.save_snapshot)
    if args.screenshot:
        tb.screenshot(args.screenshot, args.width, args.height)
        print("saved screenshot:", args.screenshot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
