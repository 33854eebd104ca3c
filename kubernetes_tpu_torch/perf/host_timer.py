"""The host's issue time of one call: ``chip_smoke.py`` logs it for K17 and
``kernel_ab.py`` reports it beside K17's device time, parent and change by
the same method.  Needs a CUDA card; imports nothing of JAX."""

from __future__ import annotations


def host_issue_us(fn, calls: int = 1000, repeats: int = 5) -> float:
    """The host's time to issue one call, in microseconds: ``calls`` calls
    queued back to back (the card keeps up: nothing waits on it), timed on
    the host's clock from the first call to the last one's return, before
    the synchronize; the median of ``repeats`` such runs."""
    import statistics
    import time

    import torch

    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)
