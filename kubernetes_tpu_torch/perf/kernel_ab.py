"""K2 (normalize_combine) and K29 (candidate_dense) timed on synthetic
inputs at the shapes their paths give them, for the copy of
``kubernetes_tpu_torch`` under ``--root``, so that two trees (a parent and
a change, unpacked side by side) are timed by the same methods on one card:

    python3 kubernetes_tpu_torch/perf/kernel_ab.py --root build/parent --out chiprun_out/ab_1.json
    python3 kubernetes_tpu_torch/perf/kernel_ab.py --root . --out chiprun_out/ab_2.json

Each row is checked against the plain version on the same inputs, then
timed two ways with the timers of ``chip_smoke.py`` (of the same tree):
``ms`` from torch.profiler (every device activity of the call; ``ms_source``
names the queued-events fallback where the profiler kept no whole record)
and ``queued_ms`` from CUDA events around calls queued behind a spin
kernel.  Shapes: K2 at C = 1 (the exact scan's step), 4 (a NorthStar round)
and 512 (the full auction) on N = 8192 with the framework's five planes,
and in its packed mode at C = 512 over 5000 live nodes; K29 at the dense
preemption path's shape (B = 128, 200 live nodes of a 256-row tier, 800
pods at 800 priorities in a 1024-row tier, R = 8) and at the check case's
(``chip_smoke.preempt_case``: N = 8192, P = 32768, R = 4, 300 priorities)
with B = 64 and B = 512.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def k2_inputs(c: int, n: int, seed: int, dev, feasible: float = 0.7):
    """A bit plane (7 filter bits, ``feasible`` of the nodes feasible) and
    the framework's five raw planes of integers 0–100 (identity ×3,
    default, reversed)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    full = 0b1111111
    drop = rng.integers(0, 7, (c, n))
    bits = np.where(rng.random((c, n)) < feasible, full, full & ~(1 << drop)).astype(np.int32)
    raw = rng.integers(0, 101, (5, c, n)).astype(np.float32)
    return full, torch.from_numpy(bits).to(dev), torch.from_numpy(raw).to(dev)


def k29_path_inputs(dev):
    """The dense preemption path's shape: 200 nodes of 4 cpu / 32Gi in a
    256-row tier, four 900m / 500Mi pods a node at priorities (i · 37) mod
    800, a 1024-row pod tier, 128 preemptors of 3000m / 500Mi at 1000."""
    import numpy as np
    import torch

    n, live, p, b, r = 256, 200, 1024, 128, 8
    alloc = np.zeros((n, r), np.int32)
    alloc[:live, 0], alloc[:live, 1], alloc[:live, 2] = 4000, 32 << 20, 110
    valid = np.zeros(p, bool)
    node = np.full(p, -1, np.int32)
    prio = np.zeros(p, np.int32)
    req = np.zeros((p, r), np.int32)
    i = np.arange(800)
    valid[:800], node[:800], prio[:800] = True, i % live, (i * 37) % 800
    req[:800, 0], req[:800, 1], req[:800, 2] = 900, 512000, 1
    requested = np.zeros((n, r), np.int32)
    np.add.at(requested, node[:800], req[:800])
    bprio = np.full(b, 1000, np.int32)
    breq = np.zeros((b, r), np.int32)
    breq[:, 0], breq[:, 1], breq[:, 2] = 3000, 512000, 1
    bits = np.zeros((b, n), np.int32)
    bits[:100, :live] = 0b1111
    arrays = (valid, node, prio, req, bprio, breq, alloc, requested, bits)
    return [torch.from_numpy(a).to(dev) for a in arrays] + [0b1111]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the tree whose kubernetes_tpu_torch to time")
    ap.add_argument("--out", required=True, help="where to write the rows (JSON)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[0] = str(root)  # the tree under --root, not this file's
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA card")
    import chip_smoke as cs
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.kernels.normalize import (
        CombinePlan,
        normalize_combine,
        normalize_combine_plain,
    )
    from kubernetes_tpu_torch.kernels.preempt import candidate_dense, candidate_dense_plain

    for mod in (cs, kernels):
        if not str(Path(mod.__file__).resolve()).startswith(str(root)):
            sys.exit(f"kernel_ab: imported {mod.__file__}, not the tree under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    dev = torch.device("cuda", 0)
    build.load("normalize_combine")
    build.load("preempt")
    plan = CombinePlan(kinds=(0, 0, 0, 1, 2), weights=(1.0, 1.0, 1.0, 1.0, 1.0), const_add=0.0)
    rows = []

    def add(name, fn, equal, **shape):
        ms = cs.device_ms(fn)
        row = {"name": name, "ms": ms, "ms_source": cs.MS_SOURCE[0],
               "queued_ms": cs.queued_device_ms(fn), "equal": equal, **shape}
        rows.append(row)
        print(f"{root.name}: {name} {ms:.5f} ms ({row['ms_source']}), {row['queued_ms']:.5f} "
              f"ms queued ({'equal' if equal else 'DIFFERS'}) {shape}", flush=True)

    for c, packed, live in ((1, False, 8192), (4, False, 8192), (512, False, 8192),
                            (512, True, 5000)):
        full, bits, raw = k2_inputs(c, 8192, 13 + c, dev)
        bits[:, live:] = 0  # a node tier's dead rows
        got = normalize_combine(bits, full, raw, plan, packed=packed)
        pt, pf = normalize_combine_plain(bits, full, raw, plan)
        kt = got if packed else got[0]
        equal = torch.equal(kt.view(torch.int32), pt.view(torch.int32)) \
            and (packed or torch.equal(got[1], pf))
        add("normalize_combine" + (" (packed)" if packed else ""),
            lambda b_=bits, r_=raw, f_=full, p_=packed: normalize_combine(b_, f_, r_, plan,
                                                                          packed=p_),
            bool(equal), C=c, N=8192, P=5, live=live)

    cases = [("path", k29_path_inputs(dev))]
    for b in (64, 512):
        gen = torch.Generator().manual_seed(cs.SEED + 29)
        d = cs.preempt_case(gen, b=b, n_prio=300)
        cases.append((f"check case, B = {b}", [
            d[k].to(dev) for k in ("pod_valid", "pod_node", "pod_priority", "pod_request",
                                   "priority", "request", "allocatable", "requested",
                                   "static_bits")] + [0b1111]))
    for label, a in cases:
        got = candidate_dense(*a)
        want = candidate_dense_plain(*a)  # the plain version on the card
        add(f"candidate_dense ({label})", lambda a_=a: candidate_dense(*a_),
            bool(torch.equal(got, want)), B=a[4].shape[0], N=a[6].shape[0],
            P=a[0].shape[0], R=a[3].shape[1])

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"root": str(root), "card": card.strip(),
                                          "rows": rows}, indent=1))
    print(f"{root.name} rows: " + "; ".join(f"{r['name']} {r['ms']:.5f} / {r['queued_ms']:.5f}"
                                           for r in rows), flush=True)
    if not all(r["equal"] for r in rows):
        sys.exit("kernel_ab: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
