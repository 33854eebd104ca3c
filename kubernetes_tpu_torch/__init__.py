"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

A second package beside the JAX one, for an NVIDIA H100: the host control
plane (API objects, store, cache, queue, encoder mirrors) is carried over
as copies, and the device side is torch tensors plus hand-written CUDA
kernels (``csrc/``, built with nvcc for sm_90a and loaded with ctypes).
The JAX package is the reference: the port's tests run both on the same
inputs and compare bit for bit.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain torch
version.  The package imports nothing of JAX and nothing of the JAX
package.

Layout (mirrors the JAX package):
  api/        object model (copies)
  sim/        trimmed in-process object store with watch fan-out
  state/      dictionary, node infos, cache, encoder, selectors, the
              existing-pod affinity index
  framework/  plugin interface, events, PodBatch compiler, runtime
  plugins/    the default plugin set (main-path plugins, live
              PodTopologySpread and InterPodAffinity, pass-through halves)
              and SelectorSpread
  config/     KubeSchedulerConfiguration: profiles → plugin sets
  gang/       the gang directory, Coscheduling, the all-or-nothing mask
  dra/        device claims: the claim index, DynamicResources
  queueing/   the 3-queue PriorityQueue
  whatif/     counterfactuals: snapshot forks, the what-if engine, and
              preemption's dry run (the candidate mask, the reprieve sweep)
  descheduler/ the eviction gate, the what-if planner, the policies and the
              controller loop
  autoscaler/ NodeGroups and the cluster autoscaler
  kernels/    CUDA kernel wrappers, plain versions, build/loader
  csrc/       the .cu sources and the host C++ reprieve sweep
  ops/        shared tensor primitives (segment sums, a float32 FMA, JAX's
              threefry random bits for the rng_key tie noise)
  oracle.py   the reference filters, one (pod, node) at a time
  preemption.py the Evaluator (DefaultPreemption's PostFilter), with the
              preemption-capable extenders' callout
  extender.py the HTTP extender client and the extender score server
              (standard library only)
  convert.py  JAX-package arrays (as numpy) → the port's tensors
  scheduler.py TorchScheduler (one framework per scheduler profile; the
              round-based extender walk; the rng_key tie noise)
"""

__version__ = "0.1.0"
