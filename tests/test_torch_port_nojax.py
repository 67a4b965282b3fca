"""The port imports nothing of JAX or of the JAX package ``dvae_tpu``.

Two checks: every module of ``dvae_tpu_torch`` imports in a fresh
interpreter where ``import jax`` and ``import dvae_tpu`` fail, and no
``import`` statement anywhere in the port or in ``chip_smoke.py`` (lazy
imports inside functions included) names either.
"""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "dvae_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["dvae_tpu"] = None
import dvae_tpu_torch
names = ["dvae_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    dvae_tpu_torch.__path__, "dvae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "dvae_tpu.")) for k in sys.modules
               if sys.modules[k] is not None)
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[-1])
    assert n_modules == len(list(PORT.rglob("*.py")))


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_import_statement_names_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = {str(f.relative_to(REPO)): root for f in files for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "flax", "optax", "dvae_tpu")}
    assert not bad
