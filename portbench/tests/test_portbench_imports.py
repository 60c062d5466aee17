"""Nothing of JAX or of the JAX package is loaded where the port is
measured, and the plain references import nothing of the port."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import harness
from portbench.lib import imports
from portbench.tests.sizes import TINY

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("modules,found", [
    ({"jax", "os"}, ["jax"]), ({"jax.numpy"}, ["jax"]),
    ({"jaxlib.xla_client"}, ["jaxlib"]), ({"flax.linen"}, ["flax"]),
    ({"ngp_tpu", "ngp_tpu.train.nerf"}, ["ngp_tpu"]),
    ({"ngp_tpu_torch", "ngp_tpu_torch.train.nerf", "torch"}, []),
    ({"jaxtyping", "ngp_tpu_tools"}, [])])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert imports.forbidden_loaded(modules) == found


def test_a_run_with_jax_loaded_is_refused(monkeypatch, quiet):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.Refused):
        harness.run("image-view-1080p", 1, 0.1, False, "cpu",
                    overrides=TINY["image-view-1080p"], log=quiet)


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(
    (HERE / "reference").glob("*.py")) + sorted((HERE / "lib").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_and_yardstick_import_nothing_of_the_port(path):
    tops = {n.split(".")[0] for n in _imported(path)}
    assert not tops & {"ngp_tpu_torch", "jax", "jaxlib", "flax", "ngp_tpu"}


def test_references_load_without_the_port():
    code = ("import sys; import portbench.reference.nerf, "
            "portbench.reference.image; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('ngp_tpu_torch', 'ngp_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
