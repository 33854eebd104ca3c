"""A cell's pods/s, repeated on one tree, with its spread, for the copy of
``kubernetes_tpu_torch`` (and its ``chip_smoke.py``) under ``--root``, so
that a parent and a change unpacked side by side are measured by the same
code on one card:

    python3 kubernetes_tpu_torch/perf/scan_rate.py --root build/parent --out chiprun_out/rate_1.json
    python3 kubernetes_tpu_torch/perf/scan_rate.py --root . --out chiprun_out/rate_2.json

``--cell`` (each run built afresh in one process, ``--repeats`` times):

* "TopologySpreading scan" (the default): ``chip_smoke.py``'s cell of that
  name — 5000 zoned nodes, 5000 pod_default pods scheduled first, then
  2000 spread pods under ``assign_mode="scan"`` (K1, K2, K6, K7, K17 and
  K18 every step); the wall from the first measured cycle to the last bind
  (``run_until_idle``, then a synchronize).  Each run must bind all 2000
  pods with one K17 launch a pod.
* "profiles scan wave": the profiles path's scan wave — ``chip_smoke``'s
  ``profiles_cluster`` at 5000 nodes with 1000 replicas pre-bound, then 512
  default-scheduler replicas under ``assign_mode="scan"`` (K1, K2 and K32
  at C = 1 and K17 every step); the wave's wall.  Each run must bind all
  512 pods with one K32 launch a pod.
* "Defrag": Defrag/5000Nodes through ``perf.harness.run_workload``
  (``chip_smoke._controller_harness``: the descheduler once a measured
  cycle, its what-if forks through K30); the harness's SchedulingThroughput.
  Each run must launch K30 in the window.
* "NorthStar": NorthStar/5000Nodes/10000Pods through
  ``perf.harness.run_workload`` (pipelined, depth 3, the 200 ms target: K13
  and K16 every cycle); the harness's SchedulingThroughput.  Each run must
  launch K16 in the window.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CELLS = ("TopologySpreading scan", "profiles scan wave", "Defrag", "NorthStar")


def topology_scan(cs, torch, kernels) -> dict:
    build_cluster, kw, make_pod, (n_nodes, n_first, n_pods) = \
        cs.ENGINE_PATHS["TopologySpreading scan"][:4]
    sched = build_cluster("cuda", n_nodes, n_first, **kw)
    for i in range(n_pods):
        sched.store.create("Pod", make_pod(i))
    torch.cuda.synchronize()
    kernels.reset_launches()
    d0 = sched.phase_wall["device"]
    t = time.perf_counter()
    stats = sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    steps = kernels.LAUNCHES["scan_select_assume"]
    if stats.scheduled != n_pods or steps != n_pods:
        sys.exit(f"scan_rate: bound {stats.scheduled} of {n_pods} pods in {steps} K17 steps")
    return {"pods": n_pods, "wall_s": wall, "pods_per_s": n_pods / wall,
            "device_s": sched.phase_wall["device"] - d0}


def profiles_scan_wave(cs, torch, kernels) -> dict:
    store, sched = cs.profiles_cluster("cuda", 5000, 1000)
    torch.cuda.synchronize()
    waves = cs.run_profile_waves(store, sched, (0, 0, 0), scan=512)
    w = waves[cs.SCAN_WAVE]
    sched.close()
    if w["bound"] != 512 or w["launches"]["selector_spread_score"] != 512 \
            or set(w["routes"]) != {"scan"}:
        sys.exit(f"scan_rate: the scan wave bound {w['bound']} of 512 pods with "
                 f"{w['launches']['selector_spread_score']} K32 launches, routes {w['routes']}")
    return {"pods": 512, "wall_s": w["wall_s"], "pods_per_s": w["pods_per_s"]}


def defrag(cs, torch, kernels, out_dir: Path) -> dict:
    _by, rec = cs._controller_harness("Defrag", out_dir, "cuda", lambda *_: {})
    forks = rec["window_launches"]["fork_masks"]
    if forks <= 0:
        sys.exit("scan_rate: Defrag launched no K30 in its window")
    return {"pods_per_s": rec["pods_per_s"], "wall_s": rec["wall_s"],
            "gangs": rec["gangs"], "window_fork_masks": forks}


def northstar(cs, torch, kernels) -> dict:
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    torch.cuda.synchronize()
    t = time.perf_counter()
    items = run_workload(build_workload("NorthStar", "5000Nodes/10000Pods"), device="cuda")
    wall = time.perf_counter() - t
    summ = cs.harness_summary(items)
    k16 = summ["window_launches"]["scatter_rows"]
    if k16 <= 0:
        sys.exit("scan_rate: NorthStar launched no K16 in its window")
    return {"pods_per_s": summ["pods_per_s"], "wall_s": wall, "window_scatter_rows": k16}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the tree whose kubernetes_tpu_torch to run")
    ap.add_argument("--out", required=True, help="where to write the runs (JSON)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cell", choices=CELLS, default=CELLS[0])
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[0] = str(root)  # the tree under --root, not this file's
    import torch

    if not torch.cuda.is_available():
        sys.exit("scan_rate: no CUDA card")
    import chip_smoke as cs
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import build

    for mod in (cs, kernels):
        if not str(Path(mod.__file__).resolve()).startswith(str(root)):
            sys.exit(f"scan_rate: imported {mod.__file__}, not the tree under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    build.build_all()
    runs = []
    for k in range(args.repeats):
        cs.fresh_heap()
        if args.cell == "TopologySpreading scan":
            run = topology_scan(cs, torch, kernels)
        elif args.cell == "profiles scan wave":
            run = profiles_scan_wave(cs, torch, kernels)
        elif args.cell == "NorthStar":
            run = northstar(cs, torch, kernels)
        else:
            run = defrag(cs, torch, kernels, Path(args.out).parent)
        runs.append(run)
        print(f"{root.name}: {args.cell} run {k}: {run['pods_per_s']:.1f} pods/s "
              f"({run['wall_s']:.4f} s)", flush=True)
    rates = [r["pods_per_s"] for r in runs]
    summary = {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
               "spread": (max(rates) - min(rates)) / statistics.median(rates)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"root": str(root), "card": card.strip(),
                                          "cell": args.cell, "runs": runs,
                                          "pods_per_s": summary}, indent=1))
    print(f"{root.name} {args.cell}: median {summary['median']:.1f} pods/s, min "
          f"{summary['min']:.1f}, max {summary['max']:.1f} "
          f"({100 * summary['spread']:.1f}% spread)", flush=True)


if __name__ == "__main__":
    main()
