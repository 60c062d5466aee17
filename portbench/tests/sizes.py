"""Each cell's overrides for a run at a tiny size: on the CPU, where the
program takes its plain PyTorch paths, or a short check on the card."""

TINY_NERF = {"encoding": {"n_levels": 4, "log2_hashmap_size": 12},
             "dataset": {"resolution": 32, "n_views": 4, "n_held_out": 1,
                         "n_spheres": 8}}
TINY_IMAGE = {"encoding": {"n_levels": 4, "log2_hashmap_size": 12},
              "dataset": {"resolution": 64, "n_discs": 4}}
TINY = {
    # the card's limits allow the kernels' round-off, which the CPU's plain
    # paths do not have, and at this size a bf16 sweep flips no cell: the
    # tiny NeRF run is held to round-off limits, which its control fails
    "nerf-train-synth": {"config": TINY_NERF, "workload": {
        "traffic": {"trainer": {"target_batch_size": 1 << 13, "n_rays": 64}},
        "limits": {"grid_off": 3e-5, "loss": 1e-6, "grad": 1e-5,
                   "change_median": 1e-5, "ema_change_median": 1e-5}}},
    "image-train-8k": {"config": TINY_IMAGE, "workload": {"traffic": {
        "batch_size": 4096}}},
    "nerf-render-720p": {"config": TINY_NERF, "workload": {"traffic": {
        "frame": [32, 18]}}},
    "image-view-1080p": {"config": TINY_IMAGE, "workload": {"traffic": {
        "frame": [48, 27], "trace_calls": 2}}},
}
