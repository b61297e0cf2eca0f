"""No module of JAX or of the JAX package is loaded by what runs on the
card, and the reference loads nothing of the program: top-level module
names compared whole (``fots_torch`` begins with ``fots``)."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench.common import FORBIDDEN_MODULES, ROOT, forbidden_loaded


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("optax", True), ("fots", True), ("fots.models.detector", True),
    ("fots_torch", False), ("fots_torch.pipeline", False), ("jaxtyping", False),
    ("fotsy", False), ("numpy", False),
])
def test_names_are_compared_whole(name, bad):
    assert (forbidden_loaded({name: None}) == [name]) is bad


def _loaded(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_the_harness_and_the_program_load_no_jax_module():
    code = ("import sys\n"
            "import gpubench.run, gpubench.report, gpubench.drivers.serve, "
            "gpubench.drivers.train, gpubench.control\n"
            "import fots_torch.pipeline, fots_torch.train, fots_torch.checkpoint\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    top = _loaded(code)
    assert "fots_torch" in top
    assert not set(top) & set(FORBIDDEN_MODULES)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import gpubench.reference.detector, gpubench.reference.ops, "
            "gpubench.check_serve, gpubench.check_train, gpubench.targets, gpubench.inputs\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    top = _loaded(code)
    assert not set(top) & (set(FORBIDDEN_MODULES) | {"fots_torch"})


def test_reference_sources_import_no_program_module():
    folder = os.path.join(ROOT, "gpubench", "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in set(FORBIDDEN_MODULES) | {"fots_torch"}, (name, m)
