"""A snapshot msgpack as a network config: the port's
``load_network_config`` returns the config the snapshot embeds, as the JAX
package's does (ref: src/testbed.cu:120-146), and so do the Testbed's
``reload_network_from_file``, the runner's ``--network`` and the CLI's
``--network``. The snapshot is written by the JAX package; the dicts must
be equal."""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import ngp_tpu_torch.__main__ as cli
from ngp_tpu.config import autofill_hashgrid_config
from ngp_tpu.config import load_network_config as j_load_network_config
from ngp_tpu.io.snapshot import save_snapshot as j_save_snapshot
from ngp_tpu.nn.models import NerfNetwork as JNerfNetwork
from ngp_tpu_torch import run
from ngp_tpu_torch.api.testbed import Testbed
from ngp_tpu_torch.config import load_network_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX-written NeRF snapshot of a 4-level, 16-wide network, and the
    config it embeds."""
    cfg = j_load_network_config("configs/nerf/base.json")
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12)
    cfg["network"]["n_neurons"] = 16
    cfg["rgb_network"]["n_neurons"] = 16
    jcfg = dict(cfg, encoding=autofill_hashgrid_config(cfg["encoding"], 3,
                                                       2048.0))
    tree = jax.tree.map(np.array, JNerfNetwork(jcfg).init_params(
        jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("msgpack_config") / "scene.msgpack"
    j_save_snapshot(str(path), cfg, tree, tree, training_step=3)
    return path, cfg


def test_load_network_config_reads_a_snapshot(snapshot):
    path, cfg = snapshot
    got = load_network_config(path)
    assert got == j_load_network_config(path)
    assert "snapshot" not in got
    assert got["encoding"]["n_levels"] == 4 and got["network"] == \
        cfg["network"]


def test_testbed_reloads_network_from_a_snapshot(snapshot):
    path, _ = snapshot
    tb = Testbed(device="cpu")
    tb.reload_network_from_file(path)
    assert tb.network_config == j_load_network_config(path)
    assert tb.network_config_path == path


@pytest.mark.parametrize("entry", ["runner", "cli"])
def test_entry_points_take_a_snapshot_as_network(snapshot, entry):
    path, _ = snapshot
    seen = []

    def capture(self, config):
        seen.append(config)
    argv = ["--network", str(path), "--device", "cpu"]
    with mock.patch.object(Testbed, "reload_network_from_json", capture):
        if entry == "runner":
            assert run.main(argv + ["--n_steps", "0"]) == 0
        else:
            assert cli.main(argv + ["--no_train"]) == 0
    assert seen == [j_load_network_config(path)]
