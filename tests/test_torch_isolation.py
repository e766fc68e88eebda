"""The port stands alone: no JAX, no ams_tpu, no cv2, no orbax, no
tensorflow, no tensorstore, no zstandard.

The card machine has none of these installed, so every module of
ams_tpu_torch must import in a process where they cannot be found, and
chip_smoke.py and tools/torch_validate_reference.py must not import them
either.
"""

import ast
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "ams_tpu", "cv2", "orbax", "tensorflow",
           "tensorstore", "zstandard")

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
    assert {"ams_tpu_torch.compat", "ams_tpu_torch.native.build",
            "ams_tpu_torch.native.codec", "ams_tpu_torch.utils.tf_bundle",
            "ams_tpu_torch.cli.convert", "ams_tpu_torch.utils.zstd",
            "ams_tpu_torch.utils.ocdbt", "ams_tpu_torch.utils.zarr2",
            "ams_tpu_torch.utils.orbax"} <= set(_port_modules())


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
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "torch_validate_reference.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ams_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, (path, bad)


_CHILD_MBCONV = r"""
import sys

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

import torch
from ams_tpu_torch.ops import fused_mbconv, fused_mbconv_banded

x = torch.zeros(1, 8, 5, 6, dtype=torch.bfloat16)
ws = (torch.zeros(8, 16), torch.zeros(16), torch.zeros(9, 16),
      torch.zeros(16), torch.zeros(16, 8), torch.zeros(8))
assert fused_mbconv.mbconv_block(x, *ws, residual=True).shape == (1, 8, 5, 6)
assert fused_mbconv_banded.mbconv_banded(x, *ws, stride=2).shape == \
    (1, 8, 3, 3)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok")
"""


def test_mbconv_modules_import_and_run_without_jax_ams_tpu_cv2():
    """The fused MBConv modules (K3, K4) import, and run their CPU path,
    with jax, ams_tpu, cv2 and orbax blocked."""
    assert {"ams_tpu_torch.ops.fused_mbconv",
            "ams_tpu_torch.ops.fused_mbconv_banded"} <= set(_port_modules())
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD_MBCONV % (BLOCKED,)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == "ok"
