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
            "kubernetes_tpu_torch.oracle", "kubernetes_tpu_torch.whatif",
            "kubernetes_tpu_torch.whatif.dryrun", "kubernetes_tpu_torch.preemption",
            "kubernetes_tpu_torch.descheduler", "kubernetes_tpu_torch.descheduler.evictions",
            "kubernetes_tpu_torch.kernels.preempt",
            "kubernetes_tpu_torch.kernels.fork", "kubernetes_tpu_torch.whatif.fork",
            "kubernetes_tpu_torch.whatif.engine", "kubernetes_tpu_torch.descheduler.planner",
            "kubernetes_tpu_torch.descheduler.policies",
            "kubernetes_tpu_torch.descheduler.controller", "kubernetes_tpu_torch.autoscaler",
            "kubernetes_tpu_torch.autoscaler.api", "kubernetes_tpu_torch.autoscaler.controller",
            "kubernetes_tpu_torch.convert",
            "kubernetes_tpu_torch.config", "kubernetes_tpu_torch.config.componentconfig",
            "kubernetes_tpu_torch.plugins.selectorspread",
            "kubernetes_tpu_torch.kernels.selectorspread", "kubernetes_tpu_torch.ops.fma",
            "kubernetes_tpu_torch.extender", "kubernetes_tpu_torch.ops.prng",
            "kubernetes_tpu_torch.kernels.tie_noise",
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
    # K27–K29: one pod at priority 0 on node 1, a batch pod at priority 5
    from kubernetes_tpu_torch.kernels.preempt import (
        candidate_dense,
        candidate_fit,
        priority_prefix,
    )

    one = torch.ones(1, dtype=torch.bool)
    node = torch.tensor([1], dtype=torch.int32)
    prio = torch.zeros(1, dtype=torch.int32)
    preq = torch.full((1, 2), 2, dtype=torch.int32)
    levels = torch.tensor([0, 2**31 - 1], dtype=torch.int32)
    prefix, cnt = priority_prefix(one, node, prio, preq, levels, 3)
    assert prefix[1, 1].tolist() == [2.0, 2.0] and cnt[1].tolist() == [0.0, 1.0, 0.0]
    alloc = torch.full((3, 2), 4, dtype=torch.int32)
    args = (torch.tensor([5], dtype=torch.int32), torch.full((1, 2), 3, dtype=torch.int32),
            alloc, torch.full((3, 2), 3, dtype=torch.int32),
            torch.ones((1, 3), dtype=torch.int32), 1)
    fit = candidate_fit(prefix, cnt, levels, *args)
    assert fit.tolist() == [[False, True, False]]
    assert candidate_dense(one, node, prio, preq, *args).tolist() == fit.tolist()
    # K30 / K31: two forks of a 3-node, 2-pod snapshot — fork 0 evicts pod 1
    # (on node 2) and removes node 0, fork 1 adds a template row at node 1
    from kubernetes_tpu_torch.kernels.fork import fork_add_rows, fork_masks

    i32 = torch.int32
    nv = torch.ones(3, dtype=torch.bool)
    req = torch.full((3, 2), 5, dtype=i32)
    nz = torch.full((3, 2), 5, dtype=i32)
    pod_req = torch.ones((2, 2), dtype=i32)
    aff = torch.ones((2, 2))
    got = fork_masks(nv, req, nz, None, torch.ones(2, dtype=torch.bool), pod_req, pod_req,
                     aff, torch.tensor([[1], [-1]], dtype=i32),
                     torch.tensor([[2], [0]], dtype=i32), torch.tensor([[1], [-1]], dtype=i32),
                     torch.tensor([[0], [0]], dtype=i32), torch.tensor([[0], [-1]], dtype=i32))
    assert got[0].tolist() == [[False, True, True], [True, True, True]]
    assert got[1].tolist() == [[True, False], [True, True]]
    assert got[2][0, 2].tolist() == [4, 4] and got[2][1].tolist() == req.tolist()
    assert got[4][0].tolist() == [[1.0, 1.0], [0.0, 1.0]] and got[5] is None
    (added,) = fork_add_rows([req], torch.tensor([[0, 0], [1, 0]], dtype=i32),
                             torch.tensor([[False, False], [True, False]]),
                             [torch.full((2, 2, 2), 9, dtype=i32)])
    assert added[0].tolist() == req.tolist()
    assert added[1].tolist() == [[5, 5], [9, 9], [5, 5]]
    # K32: row 0 masked on nodes 0 and 1 (counts 2 and 0, max 2; node 1
    # alone in its zone with count 0, the zone max 2): node 0 scores
    # floor(0.33333334·0 + 0.6666667·0) = 0, node 1 floor(33.333334 +
    # 66.66667) = 100; the unmasked node 2 keeps −inf
    from kubernetes_tpu_torch.kernels.selectorspread import selector_spread_score

    total = torch.tensor([[1.0, 1.0, float("-inf")]])
    got = selector_spread_score(torch.tensor([[3, 3, 1]], dtype=i32), 3, total,
                                torch.tensor([[2.0, 0.0, 5.0]]), torch.tensor([[2.0, 0.0, 9.0]]),
                                torch.tensor([True, True, False]), 2.0)
    assert got is total and total.tolist() == [[1.0, 201.0, float("-inf")]]
    # K33: PRNGKey(7)'s split and uniform words (jax.random at jax 0.9,
    # threefry partitionable), the ×0.5 plane on the masked nodes only, a
    # step row from a split key
    from kubernetes_tpu_torch.kernels.tie_noise import tie_plane, tie_row, tie_split

    keys = tie_split((0, 7), 3, "cpu")
    assert (keys.to(torch.int64) & 0xFFFFFFFF).tolist() == [
        [3625411723, 1954958720], [195045567, 4062205631], [966301609, 1948237315]]
    words = [1059885352, 1064927358, 1050349136, 1055084168]
    u = torch.tensor(words, dtype=torch.int32).view(torch.float32)
    total = torch.tensor([[3.0, 3.0, float("-inf"), 1.0]])
    got = tie_plane((0, 7), torch.tensor([[7, 7, 0, 3]], dtype=i32), 7, total)
    want = (torch.full((2,), 3.0) + 0.5 * u[:2]).tolist()  # float32 adds
    assert got is total and total.tolist() == [want + [float("-inf"), 1.0]]
    row = tie_row(keys, 1, 5)
    assert row.shape == (5,) and bool(((row >= 0) & (row < 1)).all())
    # K17 keyed: an all −inf row is all ties (the largest noise wins); K2's
    # packed mode returns the plane alone
    from kubernetes_tpu_torch.kernels.normalize import CombinePlan, normalize_combine
    from kubernetes_tpu_torch.kernels.scan import scan_select_assume

    node_row = torch.full((1,), -1, dtype=i32)
    cnt = torch.zeros(1, dtype=i32)
    noise = torch.tensor([0.1, 0.9, 0.3])
    scan_select_assume(torch.zeros((1, 3), dtype=i32), 1,
                       torch.full((1, 3), float("-inf")), 0, torch.tensor([-1], dtype=i32),
                       torch.tensor([True]), torch.ones((1, 2), dtype=i32),
                       torch.ones((1, 2), dtype=i32), torch.zeros((3, 2), dtype=i32),
                       torch.zeros((3, 2), dtype=i32), node_row, cnt, noise)
    assert node_row.tolist() == [-1] and cnt.tolist() == [0]
    scan_select_assume(torch.ones((1, 3), dtype=i32), 1, torch.tensor([[2.0, 5.0, 5.0]]), 0,
                       torch.tensor([-1], dtype=i32), torch.tensor([True]),
                       torch.ones((1, 2), dtype=i32), torch.ones((1, 2), dtype=i32),
                       torch.zeros((3, 2), dtype=i32), torch.zeros((3, 2), dtype=i32),
                       node_row, cnt, torch.tensor([0.9, 0.2, 0.4]))
    assert node_row.tolist() == [2] and cnt.tolist() == [3]
    plan = CombinePlan(kinds=(0,), weights=(2.0,), const_add=1.0)
    packed = normalize_combine(torch.tensor([[1, 0]], dtype=i32), 1,
                               torch.tensor([[[3.0, 4.0]]]), plan, packed=True)
    assert packed.tolist() == [[7.0, float("-inf")]]
    assert all(n == 0 for n in kernels.LAUNCHES.values())
