"""The TopologySpreading scan's pods/s, repeated on one tree, with its
spread: ``chip_smoke.py``'s "TopologySpreading scan" cell (5000 zoned
nodes, 5000 pod_default pods scheduled first, then 2000 spread pods under
``assign_mode="scan"``: K1, K2, K6, K7, K17 and K18 every step), built
afresh and run ``--repeats`` times in one process, each run's wall from
the first measured cycle to the last bind (``run_until_idle``, then a
synchronize).  The tree under ``--root`` is the one timed, so that a
parent and a change unpacked side by side are measured by the same code
on one card:

    python3 kubernetes_tpu_torch/perf/scan_rate.py --root build/parent --out chiprun_out/rate_1.json
    python3 kubernetes_tpu_torch/perf/scan_rate.py --root . --out chiprun_out/rate_2.json

Each run must bind all 2000 pods with one K17 launch a pod.  Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CELL = "TopologySpreading scan"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the tree whose kubernetes_tpu_torch to run")
    ap.add_argument("--out", required=True, help="where to write the runs (JSON)")
    ap.add_argument("--repeats", type=int, default=5)
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
    build_cluster, kw, make_pod, (n_nodes, n_first, n_pods) = cs.ENGINE_PATHS[CELL][:4]
    runs = []
    for k in range(args.repeats):
        cs.fresh_heap()
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
            sys.exit(f"scan_rate: run {k} bound {stats.scheduled} of {n_pods} pods in "
                     f"{steps} K17 steps")
        runs.append({"wall_s": wall, "pods_per_s": n_pods / wall,
                     "device_s": sched.phase_wall["device"] - d0})
        print(f"{root.name}: run {k}: {n_pods / wall:.1f} pods/s ({wall:.4f} s)", flush=True)
        del sched
    rates = [r["pods_per_s"] for r in runs]
    summary = {"median": statistics.median(rates), "min": min(rates), "max": max(rates),
               "spread": (max(rates) - min(rates)) / statistics.median(rates)}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"root": str(root), "card": card.strip(), "cell": CELL,
                                          "runs": runs, "pods_per_s": summary}, indent=1))
    print(f"{root.name} {CELL}: median {summary['median']:.1f} pods/s, min {summary['min']:.1f}, "
          f"max {summary['max']:.1f} ({100 * summary['spread']:.1f}% spread)", flush=True)


if __name__ == "__main__":
    main()
