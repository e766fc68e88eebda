"""The port stands alone: no JAX, no ams_tpu, no cv2, no orbax.

The card machine has none of these installed, so every module of
ams_tpu_torch must import in a process where they cannot be found, and
chip_smoke.py must not import them either.
"""

import ast
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "ams_tpu", "cv2", "orbax")

_CHILD = r"""
import importlib, pkgutil, sys

BLOCKED = %r

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())

import ams_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ams_tpu_torch.__path__,
                                               "ams_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def _port_modules():
    import ams_tpu_torch
    return [m.name for m in pkgutil.walk_packages(ams_tpu_torch.__path__,
                                                  "ams_tpu_torch.")]


def test_every_port_module_imports_without_jax_ams_tpu_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD % (BLOCKED,)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == len(_port_modules()) >= 15


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_none_of_them():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ams_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, (path, bad)
