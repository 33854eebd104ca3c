"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, and its entry points default to the CUDA device.

* In a subprocess (this test process already imported JAX through
  tests/conftest.py), a meta-path hook blocks ``jax``, ``jaxlib`` and the
  top-level ``kubernetes_tpu`` package (not ``kubernetes_tpu_torch``); every
  module of the port (the perf harness and the kernel modules among them)
  and chip_smoke.py must still import.
* A source scan finds no ``jax`` / ``jaxlib`` / ``kubernetes_tpu`` import in
  the port or in chip_smoke.py.
* On a machine without CUDA, the default ``device="cuda"`` raises instead
  of falling back to the CPU.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kubernetes_tpu_torch"

_BLOCKER = r'''
import importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "kubernetes_tpu"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import kubernetes_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kubernetes_tpu_torch.__path__,
                                               "kubernetes_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
'''

# modules the import check must reach (the walk finds every module; these
# name the newest ones so a package missing its __init__ cannot slip by)
REQUIRED = ("kubernetes_tpu_torch.perf.harness", "kubernetes_tpu_torch.perf.workloads",
            "kubernetes_tpu_torch.kernels.prev_delta", "kubernetes_tpu_torch.kernels.scatter",
            "kubernetes_tpu_torch.kernels.spread",
            "kubernetes_tpu_torch.kernels.interpodaffinity",
            "kubernetes_tpu_torch.kernels.scan",
            "kubernetes_tpu_torch.dra.api", "kubernetes_tpu_torch.dra.index",
            "kubernetes_tpu_torch.dra.controller", "kubernetes_tpu_torch.dra.plugin",
            "kubernetes_tpu_torch.kernels.dra",
            "kubernetes_tpu_torch.scheduler")


def test_port_imports_with_jax_and_reference_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKER, str(ROOT)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    names = out.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 30
    assert set(REQUIRED) <= set(names), sorted(set(REQUIRED) - set(names))


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|jaxlib|kubernetes_tpu)(?![\w])", re.MULTILINE)


def test_source_scan_finds_no_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        for m in _IMPORT.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from kubernetes_tpu_torch.convert import dyn_from_numpy
    from kubernetes_tpu_torch.device import resolve_device
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.state.encoding import ClusterEncoder

    import numpy as np

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchScheduler(ObjectStore())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterEncoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dyn_from_numpy({"requested": np.zeros((4, 8), np.int32),
                        "non_zero": np.zeros((4, 2), np.int32)})
    # an explicit CPU request works
    assert resolve_device("cpu").type == "cpu"
    assert ClusterEncoder(device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing (the launch counts stay 0)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels.topk import topk_rows
    from kubernetes_tpu_torch.kernels.auction import auction_resolve_commit

    kernels.reset_launches()
    eff = torch.tensor([[1.0, 3.0, 3.0, float("-inf")]])
    v, i = topk_rows(eff, 3)
    assert v.tolist() == [[3.0, 3.0, 1.0]] and i.tolist() == [[1, 2, 0]]
    req = torch.zeros((4, 2), dtype=torch.int32)
    nz = torch.zeros((4, 2), dtype=torch.int32)
    commit, choice = auction_resolve_commit(
        v, i, torch.zeros(2, dtype=torch.long), torch.arange(2),
        torch.ones(2, dtype=torch.bool), torch.zeros(2, dtype=torch.long),
        torch.zeros(2, dtype=torch.bool), torch.ones((2, 2), dtype=torch.int32),
        torch.ones((2, 2), dtype=torch.int32), req, nz)
    assert commit.tolist() == [True, True] and choice.tolist() == [1, 2]
    assert req[1].tolist() == [1, 1] and req[2].tolist() == [1, 1]
    assert all(n == 0 for n in kernels.LAUNCHES.values())
