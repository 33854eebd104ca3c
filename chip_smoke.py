#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, all of which must pass (any failure exits non-zero):

1. Build the four CUDA kernels from kubernetes_tpu_torch/csrc/ (one nvcc
   per source, started together).
2. Kernel-vs-plain: each kernel against its plain torch version on the same
   CUDA tensors — random and adversarial inputs (all-tie rows, −inf rows,
   floor-boundary values) at N = 8192 and N = 131072 — exactly equal.
3. The main path at full size: NorthStar/5000Nodes/10000Pods (5000
   node_default nodes, 2000 pre-bound and 10000 pending pod_default pods)
   through TorchScheduler(batch_size=512) on cuda.  Launch counts are zeroed
   just before and read just after; every kernel must have launched.  Every
   pod must be bound and no node oversubscribed.
4. A heterogeneous 5000-node cluster with ~2048 pending pods of 8 classes,
   scheduled once on cuda (kernels) and once on cpu (plain versions): the
   bindings must be identical.
5. Per-kernel timing at the main path's shapes: device time per call
   (torch.profiler), beside the plain version's wall and, for the top-K,
   torch.topk / torch.sort; the least time the card could take (the
   larger of the bytes over 3.35 TB/s and the scalar operations over the
   67 TFLOP/s float32 peak) is computed from the inputs.
6. One more NorthStar-shaped cycle under torch.profiler: the cycle's wall,
   device time by kernel, and the device's idle share.

Output: progress lines, a ``{"kernels": [...]}`` line, the card's name and
power limit as nvidia-smi prints them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A detailed record goes to chiprun_out/chip_smoke.json, the profiled
cycle's table to chiprun_out/profile_cycle.txt.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (same sheet)
SEED = 20261016


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- timing helpers ----------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str = None, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call from torch.profiler: the summed device time of
    the CUDA activities whose name contains ``kernel`` (all of the call's
    device activities when None), over ``reps`` calls.  Unlike CUDA-event
    timing of back-to-back calls, this excludes the host's launch overhead,
    which for a microsecond kernel is most of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if kernel is None or kernel in e.key:
            v = getattr(e, "self_device_time_total", None)
            total_us += v if v is not None else getattr(e, "self_cuda_time_total", 0)
    if total_us <= 0:
        fail(f"the profiler recorded no device time for {kernel or 'the call'}")
    return total_us / reps / 1e3


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def bound_ms(n_bytes: int, n_ops: int):
    """(the least time in ms, what bounds it): the larger of the bytes over
    the memory rate and the scalar operations over the float32 peak."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    both_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    d = torch.where(both_inf, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def require_equal(name: str, pairs) -> float:
    import torch

    err = 0.0
    for what, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            bad = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else "shape"
            fail(f"{name}: kernel and plain version differ in {what} at {bad}")
        err = max(err, max_abs_err(a, b))
    return err


# --- synthetic inputs ----------------------------------------------------------------


def synthetic_snapshot(n: int, gen, device):
    """A DeviceSnapshot of random node rows (adversarial mixes: exact
    floor-boundary capacities, taints of all effects, host ports with and
    without wildcard IPs, images, unschedulable and NotReady nodes)."""
    import torch

    from kubernetes_tpu_torch.state.encoding import DeviceSnapshot, SNAPSHOT_FIELDS

    R, L, T, P, I = 8, 16, 8, 8, 8

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    def pick(vals, *shape):
        v = torch.tensor(vals, dtype=torch.int32)
        return v[torch.randint(0, len(vals), shape, generator=gen)]

    alloc = torch.zeros((n, R), dtype=torch.int32)
    alloc[:, 0] = pick([1000, 2000, 3500, 4000, 16000], n)
    alloc[:, 1] = pick([1024000, 4194304, 33554432, 16777217], n)
    alloc[:, 3] = 110
    requested = torch.zeros((n, R), dtype=torch.int32)
    requested[:, 0] = (alloc[:, 0].float() * torch.rand(n, generator=gen) * 1.1).int()
    requested[:, 1] = (alloc[:, 1].float() * torch.rand(n, generator=gen) * 1.1).int()
    requested[:, 3] = ri(0, 111, n)
    # exact-boundary block: empty 1000m / 4Gi nodes
    requested[: n // 16] = 0
    alloc[: n // 16, 0] = 1000
    alloc[: n // 16, 1] = 4194304
    non_zero = requested[:, :2].clone()
    fields = {
        "node_valid": torch.rand(n, generator=gen) < 0.97,
        "node_name_ids": torch.arange(n, dtype=torch.int32) + 100,
        "allocatable": alloc,
        "requested": requested,
        "non_zero_requested": non_zero,
        "node_label_keys": torch.full((n, L), -1, dtype=torch.int32),
        "node_label_vals": torch.full((n, L), -1, dtype=torch.int32),
        "node_label_num": torch.full((n, L), float("nan")),
        "node_topo": torch.full((n, 8), -1, dtype=torch.int32),
        "taint_keys": pick([-1, 10, 11, 12], n, T),
        "taint_vals": pick([20, 21], n, T),
        "taint_effects": torch.cat([pick([-1, -1, -1, -1, 0, 1, 2], n, 2),
                                    torch.full((n, T - 2), -1, dtype=torch.int32)], 1),
        "ports": torch.cat([pick([-1, -1, -1, 8080, 9090, 65536 + 53], n, 2),
                            torch.full((n, P - 2), -1, dtype=torch.int32)], 1),
        "ports_ip": pick([6, 30, 31], n, P),
        "image_ids": pick([-1, 40, 41, 42, 43], n, I),
        "image_sizes": torch.rand((n, I), generator=gen) * 1e9,
        "unschedulable": torch.rand(n, generator=gen) < 0.05,
        "node_ready": torch.rand(n, generator=gen) < 0.97,
        "claim_capacity": torch.zeros(n, dtype=torch.int32),
        "claim_allocated": torch.zeros(n, dtype=torch.int32),
        "pod_valid": torch.zeros(8, dtype=torch.bool),
        "pod_node": torch.full((8,), -1, dtype=torch.int32),
        "pod_ns": torch.full((8,), -1, dtype=torch.int32),
        "pod_label_keys": torch.full((8, 8), -1, dtype=torch.int32),
        "pod_label_vals": torch.full((8, 8), -1, dtype=torch.int32),
        "pod_priority": torch.zeros(8, dtype=torch.int32),
        "pod_request": torch.zeros((8, R), dtype=torch.int32),
        "pod_non_zero": torch.zeros((8, 2), dtype=torch.int32),
        "aff_valid": torch.zeros(8, dtype=torch.bool),
        "aff_kind": torch.zeros(8, dtype=torch.int32),
        "aff_weight": torch.zeros(8),
        "aff_slot": torch.full((8,), -1, dtype=torch.int32),
        "aff_counts": torch.zeros((8, 8)),
        "numeric": torch.full((1024,), float("nan")),
    }
    snap = DeviceSnapshot(**{k: fields[k].to(device) for k in SNAPSHOT_FIELDS})
    return snap


def synthetic_classes(c: int, n: int, gen, device):
    import torch

    R, TT, PP, CI = 8, 2, 2, 2

    def pick(vals, *shape):
        v = torch.tensor(vals, dtype=torch.int32)
        return v[torch.randint(0, len(vals), shape, generator=gen)]

    req = torch.zeros((c, R), dtype=torch.int32)
    req[:, 0] = pick([100, 250, 500, 2000], c)
    req[:, 1] = pick([262144, 1048576, 512000, 341000], c)
    req[:, 3] = 1
    req[0, 0], req[0, 1] = 250, 1048576  # the exact-75 floor pod
    node_name_id = torch.full((c,), -1, dtype=torch.int32)
    node_name_id[-1] = 100 + n // 3
    rep = SimpleNamespace(
        valid=torch.ones(c, dtype=torch.bool),
        request=req, non_zero=req[:, :2].clone(), node_name_id=node_name_id,
        tol_valid=torch.rand((c, TT), generator=gen) < 0.6,
        tol_key=pick([-1, 3, 10, 11], c, TT), tol_val=pick([20, 21], c, TT),
        tol_op=pick([0, 1], c, TT), tol_effect=pick([-1, 0, 1, 2], c, TT),
        ports=pick([-1, 8080, 9090], c, PP), ports_ip=pick([6, 30], c, PP),
        image_ids=pick([-1, 40, 41, 42, 43, 44], c, CI),
    )
    rep.valid[-2] = False  # a padding class row
    for k, v in vars(rep).items():
        setattr(rep, k, v.to(device))
    na_mask = (torch.rand((c, n), generator=gen) < 0.9).to(device)
    na_pref = torch.randint(0, 4, (c, n), generator=gen).float().mul(5.0).to(device)
    return rep, na_mask, na_pref


def framework_plans():
    from kubernetes_tpu_torch.framework.runtime import BatchedFramework
    from kubernetes_tpu_torch.scheduler import default_plugins

    fw = BatchedFramework(default_plugins(8))
    return fw, fw.kernel_plans()


# --- phase 2: kernel vs plain ----------------------------------------------------------


def check_kernels(dev) -> dict:
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.kernels.auction import (
        auction_resolve_commit,
        auction_resolve_commit_plain,
    )
    from kubernetes_tpu_torch.kernels.filter_score import (
        filter_score_planes,
        filter_score_planes_plain,
    )
    from kubernetes_tpu_torch.kernels.normalize import (
        normalize_combine,
        normalize_combine_plain,
    )
    from kubernetes_tpu_torch.kernels.topk import topk_rows, topk_rows_plain
    from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id

    gen = torch.Generator().manual_seed(SEED)
    fw, (fs_plan, comb_plan) = framework_plans()
    full = (1 << len(fw.filter_names)) - 1
    err = {"filter_score_planes": 0.0, "normalize_combine": 0.0,
           "topk_rows": 0.0, "auction_resolve_commit": 0.0}
    cases = {k: 0 for k in err}
    for n in (8192, 131072):
        c = 8
        snap = synthetic_snapshot(n, gen, dev)
        dyn = DynamicState(requested=snap.requested, non_zero=snap.non_zero_requested)
        rep, na_mask, na_pref = synthetic_classes(c, n, gen, dev)
        img = image_scaled_by_id(snap)
        kb, kr = filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
        pb, pr = filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
        torch.cuda.synchronize()
        err["filter_score_planes"] = max(err["filter_score_planes"], require_equal(
            f"filter_score_planes N={n}", [("bits", kb, pb), ("raw", kr, pr)]))
        cases["filter_score_planes"] += 1
        if not (kb == full).any() or (kb == full).all():
            fail("filter_score_planes: synthetic inputs left no mix of feasible nodes")

        # K2 on K1's planes, and on adversarial planes (ties, boundary
        # values, a row with no feasible node)
        adv_bits = kb.clone()
        adv_bits[1] = 0
        adv_raw = kr.clone()
        adv_raw[0] = torch.randint(0, 3, adv_raw[0].shape, generator=gen).float().to(dev)
        adv_raw[1] = torch.randint(0, 2, adv_raw[1].shape, generator=gen).float().mul(50).to(dev)
        for bits, raw in ((kb, kr), (adv_bits, adv_raw)):
            kt, kf = normalize_combine(bits, full, raw, comb_plan)
            pt, pf = normalize_combine_plain(bits, full, raw, comb_plan)
            torch.cuda.synchronize()
            err["normalize_combine"] = max(err["normalize_combine"], require_equal(
                f"normalize_combine N={n}", [("total", kt, pt), ("feasible", kf, pf)]))
            cases["normalize_combine"] += 1

        # K3: all-tie, all −inf, heavy ties with −inf holes, ±0.0, random
        rows = torch.stack([
            torch.full((n,), 300.0),
            torch.full((n,), float("-inf")),
            torch.where(torch.rand(n, generator=gen) < 0.5, float("-inf"),
                        torch.randint(0, 4, (n,), generator=gen).float()),
            torch.where(torch.rand(n, generator=gen) < 0.5, -0.0, 0.0),
            torch.randn(n, generator=gen),
            torch.where(torch.rand(n, generator=gen) < 0.999, float("-inf"), 7.0),
        ]).to(dev)
        rows = torch.cat([rows, kt], dim=0)
        for k in (512, 1024):
            kv, ki = topk_rows(rows, k)
            pv, pi = topk_rows_plain(rows, k)
            torch.cuda.synchronize()
            err["topk_rows"] = max(err["topk_rows"], require_equal(
                f"topk_rows N={n} K={k}", [("values", kv, pv), ("columns", ki, pi)]))
            cases["topk_rows"] += 1

        # K4: identical-pod contention on one class list, mixed classes,
        # nominated rows, pods left unresolved
        cand_val, cand_idx = topk_rows_plain(kt, 512)
        b = 512
        for mode in ("identical", "mixed"):
            if mode == "identical":
                class_of = torch.zeros(b, dtype=torch.long)
                unres = torch.ones(b, dtype=torch.bool)
                nom_ok = torch.zeros(b, dtype=torch.bool)
                pos_of = torch.arange(b)
            else:
                class_of = torch.randint(0, c, (b,), generator=gen)
                unres = torch.rand(b, generator=gen) < 0.9
                nom_ok = torch.rand(b, generator=gen) < 0.1
                pos_of = torch.randperm(b, generator=gen)
            nom = torch.randint(0, n, (b,), generator=gen)
            request = torch.randint(1, 500, (b, 8), generator=gen, dtype=torch.int32)
            pod_nz = request[:, :2].clone()
            args = [t.to(dev) for t in (cand_val, cand_idx, class_of, pos_of, unres,
                                       nom, nom_ok, request, pod_nz)]
            kreq, knz = snap.requested.clone(), snap.non_zero_requested.clone()
            preq, pnz = kreq.clone(), knz.clone()
            kc, kch = auction_resolve_commit(*args, kreq, knz)
            pc, pch = auction_resolve_commit_plain(*args, preq, pnz)
            torch.cuda.synchronize()
            err["auction_resolve_commit"] = max(err["auction_resolve_commit"], require_equal(
                f"auction_resolve_commit N={n} {mode}",
                [("commit", kc, pc), ("choice", kch, pch), ("requested", kreq, preq),
                 ("non_zero", knz, pnz)]))
            cases["auction_resolve_commit"] += 1
            if mode == "identical" and int(kc.sum()) < 256:
                fail("auction_resolve_commit: identical pods committed too few")
    log(f"kernel-vs-plain: all equal ({json.dumps(cases)})")
    return err


# --- phase 3: NorthStar ---------------------------------------------------------------


def northstar(dev_name: str) -> dict:
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.api.resource import compute_pod_resource_request
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    n_nodes, n_pre, n_pods = 5000, 2000, 10000
    t0 = time.perf_counter()
    store = ObjectStore()
    for i in range(n_nodes):
        store.create("Node", make_node().name(f"node-{i:06d}")
                     .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
    for i in range(n_pre):
        store.create("Pod", make_pod().name(f"pre-{i:06d}").uid(f"pre-{i:06d}")
                     .namespace("default").req({"cpu": "100m", "memory": "500Mi"})
                     .node(f"node-{i % n_nodes:06d}").obj())
    sched = TorchScheduler(store, batch_size=512, device=dev_name)
    sched.presize(n_nodes, n_pre + n_pods)
    for i in range(n_pods):
        store.create("Pod", make_pod().name(f"pod-{i:06d}").uid(f"pod-{i:06d}")
                     .namespace("default").req({"cpu": "100m", "memory": "500Mi"}).obj())
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    stats = sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)

    pods, _ = store.list("Pod")
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    if unbound:
        fail(f"NorthStar: {len(unbound)} pods unbound, e.g. {unbound[:3]}")
    if stats.scheduled != n_pods:
        fail(f"NorthStar: scheduled {stats.scheduled} of {n_pods}")
    used = {}
    for p in pods:
        r = compute_pod_resource_request(p)
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for name, (cpu, mem, count) in used.items():
        if cpu > 4000 or mem > 32 * 1024 ** 3 or count > 110:
            fail(f"NorthStar: node {name} oversubscribed ({cpu}m, {mem} B, {count} pods)")
    for k, v in launches.items():
        if v <= 0:
            fail(f"NorthStar: kernel {k} never launched on the main path")
    import numpy as np

    att = np.asarray(sched.attempt_seconds[-n_pods:])
    out = {
        "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
        "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
        "nodes": n_nodes, "pre_bound": n_pre, "pods": n_pods, "batch_size": 512,
        "setup_s": setup_s, "wall_s": wall, "pods_per_s": n_pods / wall,
        "cycles": sched.cycles, "rounds": sched.rounds_total,
        "rounds_per_cycle": sched.rounds_total / max(sched.cycles, 1),
        "phase_wall_s": dict(sched.phase_wall),
        "node_tier": sched.encoder._n, "launches": launches,
    }
    pw = sched.phase_wall
    log(f"NorthStar/5000Nodes/10000Pods: {n_pods} pods bound in {wall:.3f} s = "
        f"{out['pods_per_s']:.1f} pods/s; {sched.cycles} cycles, "
        f"{out['rounds_per_cycle']:.2f} rounds/cycle; per cycle host "
        f"{(pw['snapshot'] + pw['compile'] + pw['bind']) / max(sched.cycles, 1) * 1e3:.2f} ms "
        f"(snapshot {pw['snapshot'] / max(sched.cycles, 1) * 1e3:.2f}, compile "
        f"{pw['compile'] / max(sched.cycles, 1) * 1e3:.2f}, bind "
        f"{pw['bind'] / max(sched.cycles, 1) * 1e3:.2f}) vs device "
        f"{pw['device'] / max(sched.cycles, 1) * 1e3:.2f} ms; attempt p50 "
        f"{out['attempt_p50_ms']:.1f} ms, p99 {out['attempt_p99_ms']:.1f} ms; "
        f"launches {launches}")
    return {"record": out, "sched": sched}


# --- phase 4: heterogeneous cluster, cuda vs cpu ------------------------------------------


def hetero_bindings(device: str):
    import numpy as np

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    rng = np.random.default_rng(SEED)
    store = ObjectStore()
    shapes = [("4", "32Gi"), ("8", "16Gi"), ("1000m", "4Gi"), ("3500m", "1000Mi"),
              ("16", "64Gi")]
    for i in range(5000):
        cpu, mem = shapes[int(rng.integers(len(shapes)))]
        w = (make_node().name(f"node-{i:06d}")
             .capacity({"cpu": cpu, "memory": mem, "pods": "110"})
             .label("zone", f"z{i % 3}").label("disk", str(rng.choice(["ssd", "hdd"]))))
        u = rng.random()
        if u < 0.1:
            w = w.taint("dedicated", "gpu", v1.TAINT_NO_SCHEDULE)
        elif u < 0.15:
            w = w.taint("evict", "", v1.TAINT_NO_EXECUTE)
        if rng.random() < 0.2:
            w = w.taint("flaky", "", v1.TAINT_PREFER_NO_SCHEDULE)
        for img, size in (("img-a", 300 << 20), ("img-b", 23 << 20), ("img-c", 900 << 20)):
            if rng.random() < 0.3:
                w = w.image(img, size)
        if rng.random() < 0.03:
            w = w.unschedulable()
        node = w.obj()
        node.metadata.creation_timestamp = 0.0
        if rng.random() < 0.02:
            node.status.conditions = [{"type": "Ready", "status": "False"}]
        store.create("Node", node)

    def tmpl(k, i):
        w = (make_pod().name(f"p{i:05d}").uid(f"p{i:05d}").namespace("default")
             .creation_timestamp(float(i)))
        if k == 0:
            return w.req({"cpu": "100m", "memory": "500Mi"}).obj()
        if k == 1:
            return w.req({"cpu": "250m", "memory": "1Gi"}).node_selector({"disk": "ssd"}).obj()
        if k == 2:
            return w.req({"cpu": "500m", "memory": "333Mi"}).toleration(
                "dedicated", "gpu", v1.TAINT_NO_SCHEDULE).obj()
        if k == 3:
            return (w.req({"cpu": "1", "memory": "1Gi"}).node_affinity_in("zone", ["z0", "z1"])
                    .preferred_node_affinity(10, "disk", ["ssd"]).obj())
        if k == 4:
            p = w.req({"cpu": "200m", "memory": "256Mi"}).host_port(8080).obj()
            p.spec.containers[0].image = "img-a"
            p.spec.containers.append(v1.Container(name="c1", image="img-c"))
            return p
        if k == 5:
            p = w.req({"cpu": "300m", "memory": "700Mi"}).toleration(
                "", "", "", operator=v1.TOLERATION_OP_EXISTS).obj()
            p.spec.containers[0].image = "img-b"
            return p
        if k == 6:
            return w.req({"cpu": "150m", "memory": "400Mi"}).toleration(
                "flaky", "", v1.TAINT_PREFER_NO_SCHEDULE,
                operator=v1.TOLERATION_OP_EXISTS).host_port(9090, host_ip="10.0.0.1").obj()
        return w.req({"cpu": "64", "memory": "1Gi"}).obj()  # fits nowhere

    for i in range(2048):
        store.create("Pod", tmpl(int(rng.integers(8)), i))
    clock_t = [0.0]

    def clock():
        clock_t[0] += 1e-6
        return clock_t[0]

    sched = TorchScheduler(store, batch_size=512, device=device, clock=clock,
                           batch_wait=0)
    kernels.reset_launches()
    t = time.perf_counter()
    cycles = 0
    while sched.schedule_cycle().attempted:
        cycles += 1
    wall = time.perf_counter() - t
    pods, _ = store.list("Pod")
    return ({p.metadata.name: p.spec.node_name for p in pods}, dict(kernels.LAUNCHES),
            cycles, wall)


# --- phase 5: timing at the main path's shapes ------------------------------------------


def time_kernels(sched, err: dict) -> list:
    """Each kernel, its plain version and (K3) the library call, on the
    inputs of a NorthStar cycle's first round: the live 8192-row snapshot,
    a 512-pod pod_default batch (one class, padded to 4), K = 512."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.framework.podbatch import batch_to_device, identity_classes
    from kubernetes_tpu_torch.kernels.auction import (
        auction_resolve_commit,
        auction_resolve_commit_plain,
    )
    from kubernetes_tpu_torch.kernels.filter_score import (
        filter_score_planes,
        filter_score_planes_plain,
    )
    from kubernetes_tpu_torch.kernels.normalize import (
        normalize_combine,
        normalize_combine_plain,
    )
    from kubernetes_tpu_torch.kernels.topk import topk_rows, topk_rows_plain
    from kubernetes_tpu_torch.plugins.nodeaffinity import NodeAffinityPlugin
    from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id
    from kubernetes_tpu_torch.testutil import make_pod

    dev = sched.device
    snap = sched.encoder.to_device(force_full=True)
    pods = [make_pod().name(f"t{i}").uid(f"t{i}").namespace("default")
            .req({"cpu": "100m", "memory": "500Mi"}).obj() for i in range(512)]
    batch = sched.compiler.compile(pods, pad_to=512)
    class_of, reps = identity_classes(batch)
    rep_rows = np.full(4, reps[0], dtype=np.int64)
    rep_rows[: len(reps)] = reps
    dbatch = batch_to_device(batch, dev)
    rep = dbatch.take(torch.from_numpy(rep_rows).to(dev))
    dyn = DynamicState(requested=snap.requested.clone(),
                       non_zero=snap.non_zero_requested.clone())
    na = NodeAffinityPlugin()
    na_mask, na_pref = na.filter(rep, snap, dyn), na.score(rep, snap, dyn)
    img = image_scaled_by_id(snap)
    fs_plan, comb_plan = sched.fw.kernel_plans()
    full = (1 << sched.n_filters) - 1
    c, n = rep.valid.shape[0], snap.num_nodes
    b, k = 512, min(512, n)

    bits, raw = filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
    pb, pr = filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
    err["filter_score_planes"] = max(err["filter_score_planes"], require_equal(
        "filter_score_planes (NorthStar)", [("bits", bits, pb), ("raw", raw, pr)]))
    total, feas = normalize_combine(bits, full, raw, comb_plan)
    pt, pf = normalize_combine_plain(bits, full, raw, comb_plan)
    err["normalize_combine"] = max(err["normalize_combine"], require_equal(
        "normalize_combine (NorthStar)", [("total", total, pt), ("feasible", feas, pf)]))
    cv, ci = topk_rows(total, k)
    pv, pi = topk_rows_plain(total, k)
    err["topk_rows"] = max(err["topk_rows"], require_equal(
        "topk_rows (NorthStar)", [("values", cv, pv), ("columns", ci, pi)]))
    class_t = torch.from_numpy(class_of.astype(np.int64)).to(dev)
    pos_of = torch.arange(b, device=dev)
    unres = dbatch.valid.clone()
    nom = torch.zeros(b, dtype=torch.long, device=dev)
    nom_ok = torch.zeros(b, dtype=torch.bool, device=dev)
    a_args = (cv, ci, class_t, pos_of, unres, nom, nom_ok, dbatch.request, dbatch.non_zero)
    kreq, knz = dyn.requested.clone(), dyn.non_zero.clone()
    preq, pnz = dyn.requested.clone(), dyn.non_zero.clone()
    kc, kch = auction_resolve_commit(*a_args, kreq, knz)
    pc, pch = auction_resolve_commit_plain(*a_args, preq, pnz)
    err["auction_resolve_commit"] = max(err["auction_resolve_commit"], require_equal(
        "auction_resolve_commit (NorthStar)",
        [("commit", kc, pc), ("choice", kch, pch), ("requested", kreq, preq),
         ("non_zero", knz, pnz)]))
    commits = int(kc.sum())

    work_req, work_nz = dyn.requested.clone(), dyn.non_zero.clone()
    rows = []

    def row(name, src, replaces, symbol, fn, plain_fn, n_bytes, n_ops, library_fn=None,
            plain_reps=5):
        """ms: the kernel's device time per call (profiler); call_ms: the
        wrapper's wall per call, back to back (CUDA events, host launch
        included); plain_ms: the plain version's wall per call (CUDA
        events: its host launches and syncs are part of its cost);
        library_ms: the library call's device time per call."""
        least, bound_by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err[name],
            "ms": device_ms(fn, symbol), "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=plain_reps, warmup=1),
            "bound_ms": least, "bound_by": bound_by,
            "library_ms": device_ms(library_fn) if library_fn else None,
            "bytes": n_bytes, "ops": n_ops, "shape": {"C": c, "N": n, "B": b, "K": k},
        })

    k1_in = [rep.valid, rep.request, rep.non_zero, rep.node_name_id, rep.tol_valid,
             rep.tol_key, rep.tol_val, rep.tol_op, rep.tol_effect, rep.ports,
             rep.ports_ip, rep.image_ids, snap.node_valid, snap.node_ready,
             snap.node_name_ids, snap.unschedulable, snap.allocatable, dyn.requested,
             dyn.non_zero, snap.taint_keys, snap.taint_vals, snap.taint_effects,
             snap.ports, snap.ports_ip, snap.image_ids, na_mask, na_pref]
    # of ImageLocality's per-id table K1 needs only the entries at the class
    # rows' image ids, one f32 each
    img_gathered = int((rep.image_ids >= 0).sum()) * img.element_size()
    # per (class, node): taint × toleration matches, port × port and image ×
    # image compares, ~12 arithmetic steps per resource dimension
    pod_t, pod_p, pod_i = (rep.tol_key.shape[1], rep.ports.shape[1],
                           rep.image_ids.shape[1])
    node_t, node_p, node_i = (snap.taint_keys.shape[1], snap.ports.shape[1],
                              snap.image_ids.shape[1])
    r = dyn.requested.shape[1]
    k1_ops = c * n * (node_t * pod_t + pod_p * node_p + pod_i * node_i + 12 * r)
    row("filter_score_planes", "kubernetes_tpu_torch/csrc/filter_score.cu",
        "kubernetes_tpu/framework/runtime.py:852", "filter_score_kernel",
        lambda: filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, fs_plan),
        lambda: filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, fs_plan),
        nbytes(*k1_in, bits, raw) + img_gathered, k1_ops)
    # per (class, node, plane): the row max, the scaling, the floor, the add
    row("normalize_combine", "kubernetes_tpu_torch/csrc/normalize_combine.cu",
        "kubernetes_tpu/framework/runtime.py:857", "normalize_combine_kernel",
        lambda: normalize_combine(bits, full, raw, comb_plan),
        lambda: normalize_combine_plain(bits, full, raw, comb_plan),
        nbytes(bits, raw, total, feas), c * n * raw.shape[0] * 4)
    # a selection compares every entry at least once
    row("topk_rows", "kubernetes_tpu_torch/csrc/topk_rows.cu",
        "kubernetes_tpu/framework/runtime.py:875", "topk_pass_kernel",
        lambda: topk_rows(total, k), lambda: topk_rows_plain(total, k),
        nbytes(total) + c * k * 8, c * n, library_fn=lambda: torch.topk(total, k, dim=1))
    rows[-1]["library_sort_ms"] = device_ms(
        lambda: torch.sort(total, dim=1, descending=True, stable=True))
    # K4 writes only the committed rows of requested / non_zero; each commit
    # takes at least one bid, one resolve and its R + 2 adds
    k4_bytes = (nbytes(cv, ci, class_t, pos_of, unres, nom, nom_ok, dbatch.request,
                       dbatch.non_zero) + b * 8 + commits * (r + 2) * 4 * 2)
    row("auction_resolve_commit", "kubernetes_tpu_torch/csrc/auction.cu",
        "kubernetes_tpu/framework/runtime.py:898", "auction_kernel",
        lambda: auction_resolve_commit(*a_args, work_req, work_nz),
        lambda: auction_resolve_commit_plain(*a_args, work_req, work_nz),
        k4_bytes, commits * (r + 4), plain_reps=3)
    return rows


# --- phase 6: where one cycle's device time goes ----------------------------------------


def profile_cycle(sched, out_dir: Path) -> dict:
    """One more NorthStar-shaped cycle (512 pod_default pods on the same
    5000-node cluster) under torch.profiler: the cycle's wall, the device
    time by kernel name, and the device's idle share of the cycle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.testutil import make_pod

    for i in range(512):
        sched.store.create("Pod", make_pod().name(f"prof-{i:06d}").uid(f"prof-{i:06d}")
                           .namespace("default").req({"cpu": "100m", "memory": "500Mi"})
                           .obj())
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's one-off start-up cost
        (torch.ones(8, device="cuda") + 1).sum().item()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        stats = sched.schedule_cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    if stats.scheduled != 512:
        fail(f"profiled cycle scheduled {stats.scheduled} of 512")

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in events), reverse=True)
    lines = [f"one NorthStar-shaped cycle under torch.profiler: wall {wall_ms:.3f} ms, "
             f"device busy {busy_ms:.3f} ms",
             f"{'device ms':>10} {'count':>6}  name"]
    lines += [f"{ms:10.4f} {cnt:6d}  {name}" for ms, cnt, name in top]
    (out_dir / "profile_cycle.txt").write_text("\n".join(lines) + "\n")
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "top": [[ms, cnt, name] for ms, cnt, name in top[:12]]}
    if busy_ms:
        log(f"profiled cycle: wall {wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
            f"(idle share {rec['device_idle_share']:.4f}); top: "
            + "; ".join(f"{name[:40]} {ms:.3f} ms" for ms, _, name in top[:5]))
    else:
        log("profiled cycle: the profiler recorded no device time (not measured)")
    return rec


def main() -> None:
    here = Path(__file__).resolve().parent
    if not (here / "kubernetes_tpu_torch" / "csrc").is_dir():
        fail("kubernetes_tpu_torch/ is not beside chip_smoke.py: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(here))
    os.chdir(here)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({card}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    record = {"card": card, "kind": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    from kubernetes_tpu_torch.kernels import build

    t = time.perf_counter()
    build.build_all()
    record["build_s"] = time.perf_counter() - t
    log(f"built {len(build.SOURCES)} kernels for sm_90a in {record['build_s']:.1f} s")
    for name in build.SOURCES:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t = time.perf_counter()
    err = check_kernels(dev)
    record["kernel_check_s"] = time.perf_counter() - t

    ns = northstar("cuda")
    record["northstar"] = ns["record"]

    t = time.perf_counter()
    gpu_bind, gpu_launch, gpu_cycles, gpu_wall = hetero_bindings("cuda")
    cpu_bind, _cpu_launch, cpu_cycles, cpu_wall = hetero_bindings("cpu")
    if gpu_bind != cpu_bind:
        diff = [k for k in gpu_bind if gpu_bind[k] != cpu_bind.get(k)]
        fail(f"heterogeneous cluster: cuda and cpu bindings differ for {len(diff)} "
             f"pods, e.g. {diff[:3]}")
    for k_, v in gpu_launch.items():
        if v <= 0:
            fail(f"heterogeneous cluster: kernel {k_} never launched")
    bound = sum(1 for v in gpu_bind.values() if v)
    if not 0 < bound < len(gpu_bind):
        fail(f"heterogeneous cluster: expected a mix of bound and unschedulable "
             f"pods, got {bound} of {len(gpu_bind)}")
    record["hetero"] = {"pods": len(gpu_bind), "bound": bound, "cuda_cycles": gpu_cycles,
                        "cpu_cycles": cpu_cycles, "cuda_wall_s": gpu_wall,
                        "cpu_wall_s": cpu_wall, "launches": gpu_launch,
                        "s": time.perf_counter() - t}
    log(f"heterogeneous 5000 nodes / 2048 pods: cuda == cpu bindings "
        f"({bound} bound, {len(gpu_bind) - bound} unschedulable); "
        f"cuda {gpu_wall:.2f} s, cpu {cpu_wall:.2f} s; launches {gpu_launch}")

    rows = time_kernels(ns["sched"], err)
    for r in rows:
        r["launches"] = ns["record"]["launches"][r["name"]]
    record["kernels"] = rows
    out_dir = here / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    record["profile"] = profile_cycle(ns["sched"], out_dir)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k_: r[k_] for k_ in keys} for r in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
