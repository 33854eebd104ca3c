#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, all of which must pass (any failure exits non-zero):

1. Build the thirty-three CUDA kernels from kubernetes_tpu_torch/csrc/ (one
   nvcc per source) and the host C++ reprieve sweep
   (csrc/preempt_sweep.cpp, g++), all started together.
2. Kernel-vs-plain: each kernel against its plain torch version on the same
   CUDA tensors, exactly equal.  K1–K4: random and adversarial inputs
   (all-tie rows, −inf rows, floor-boundary values) at N = 8192 and
   N = 131072.  K3 besides over the grid C ∈ {1, 4, 512} × N ∈ {20, 500,
   5000, 8192, 131072} × K ∈ {1, 20, 64, 384, 512, 1024} (K ≤ N), with a
   row whose K-th value is tied across hundreds of columns around the
   middle, bit for bit and one launch a call.  K4 besides on one class
   with 5% nominated pods (in and out of the list), one class with fewer
   finite entries than bidders, one class with 30% of the pods resolved
   and the positions permuted (the closed form must end each), two classes
   with one list, 400 overlapping classes and N = 131072.  K5–K8: every
   domain empty, nodes without the key,
   minDomains above the present domains, all raw scores 0, ignored (NaN)
   nodes, five domains with counts 379 and 4927, 3 and 64 domains, one and
   two constraints.  K9–K12: tables and planes, keyless nodes, an
   all-trash group, aff_total 0 with and without a self-match, an
   all-masked row, normalization over max − min of 97 and 100 (the top
   node must score 100), negative raw scores, and index groups of every
   kind; K11 and K12 also at kernel_work.py's shapes, K12 on a tables
   bucket of 65536 domains and at B = 6000 (two compaction passes); one
   launch a call of K11 and K12 proven by a CUDA graph (as of K1, K7, K8,
   K10, K13, K16, K17 keyless and keyed, K19, K27 and K29 later).  K10 at
   kernel_work.K10_CASES (required affinity on zone tables, required
   anti-affinity on hostname planes, no required term; C = 1, 4 and 512;
   N = 8190).  K8 with class_of
   int64 and int32, and at C = 512 on a hostname table.  K13–K16: rows of
   −1, two bundles on one node, a no-op bundle;
   word and odd row widths with duplicate pad rows, 12-byte, bool and
   3-byte rows at N = 8190 aligned and one element into their storage,
   k = 0, K16's plan against kernel_work.k16_plan; unplaced and invalid
   prev pods; both IPA count forms, a carry with and without prev terms,
   an all-invalid prev term group.  K17–K19 (the exact scan's step): ties
   across the whole row, an all-infeasible row, a nominated row that is
   infeasible, feasible, past the bucket or the last node, a padding pod,
   the maximum at the last node; K17 keyless and keyed (under real step
   keys) also at N = 1, 31, 5000, 8191 and 8192 with ties either side of
   every cluster slice and vector tail, equal draws across slices, a +0.0
   / −0.0 tie and unaligned views (``k17_split_cases``); K18 / K19 at
   full-batch rows B = 512 with the pod on a live node, a keyless node,
   the last node and none, K19 in both count forms.  K1–K4, K6–K8 and
   K10–K12 again at C = 512 rows (identity classes, as the full auction
   runs them) and K1, K2, K6, K7, K10 and K11 on one row (as the scan runs
   them).  K20–K23 at GangBasic's
   shapes: K20 with gangs of 8 at B = 512 and 1024, no gangs, one
   incomplete gang; K21 on 512 anchored rows over 8192 nodes in slices of
   8 with a row whose anchor slice holds no feasible node, anchor −2, and
   on one row; K22 at C = B = 512, on class-gathered rows and at 31
   filters; K23 with every operator, NaN and absent keys, empty terms,
   match_all / match_none, both numeric forms and the numeric path off,
   and ``kernel_work.K23_CASES`` (U = 512 distinct rows, O = 8190, 20
   label columns) and label views off 16-byte alignment.
   K24–K26 (DynamicResources) at C = 1, 64 and 512 rows over N = 8192
   (pinned, blocked and zero-demand rows, nodes without inventory, negative
   free; K25 at weights 1 and 2), K25 over the floor grid (capacity 1–256 ×
   used 0–capacity, equal to the integer floor, the pins (61, 61) and
   (53, 100)), K26 as an auction round, at class rows and as a scan step;
   K25 also at kernel_work.K25_CASES (the DeviceClaimGang path's C = 64,
   C = 512, C = 1, N = 8190, no feasible entry, random claims, the floor
   grid) and on a bit plane off 16-byte boundaries, its plan against
   kernel_work.k25_plan, one kernel node a call.
   K27 + K28 (the preemption candidate mask over priority levels) at N =
   8192, P = 32768, B = 512, R = 4 with 128 live levels, odd-KiB memory
   requests on 2^25-KiB nodes (float32 sums round), unbound and invalid
   pods, dead nodes, padding rows and failing static bits, and with batch
   rows at a (node, threshold)'s exact float32 fit value and one ulp above;
   K28 also at kernel_work.K28_CASES (the path's two live levels, 128
   levels with more thresholds a row group than slots, ulp-boundary rows,
   R = 4 and 16, N = 8190, mostly failing static bits), at B = 37, N =
   1000, R = 5 and on static bits off 16-byte boundaries, one kernel node
   a call, its plan against kernel_work.k28_plan;
   K27 also at kernel_work.K27_CASES (the path's two live levels, a node
   holding 6000 pods, more than a round; R = 16 over 128 levels, in
   windows), at N = 1000 and 999, R = 5, with no live level (every level
   a pad), and on a tier whose node column is off a 16-byte boundary; one
   kernel node a call and no torch op beside it; its plan against
   kernel_work.k27_plan; K29 (the dense form) at B = 64 over 300
   priorities; K13 with the
   nominated bundle (no nz rows) beside two in-flight bundles, rows past N
   among them, at the path's sizes and in several staging chunks.  K1
   also past every width it stages (R = 12, 16 taints, ports and images a
   node, 12 a class, a 40-point RTCR shape) and at C and N that cut its
   tiles and class chunks unevenly.  K30 (the what-if fork
   masks) at Defrag's shapes (K = 4, N = 8192, P = 16384) with a duplicate
   victim, −1 pads in every group, a repeated affinity cell, with and
   without claim-holding victims; K31 (the node-add rows) at
   AutoscaleGang's shapes (K = 4, 4096 rows a fork) with pads at row 0 and
   a real add at row 0 with pads behind it (the add must win); K30 on K31's
   per-fork node arrays; both with K = 4 stacked equal to four K = 1
   launches; K30 also at its tile edges (N = 8190, P = 16383, G × D = 35,
   entries either side of a tile boundary, rows past the end and below 0)
   and past a warp's staging slots.  Their plain versions run on CPU
   copies of the inputs.  One launch a call of K30 proven by a CUDA graph
   on Defrag's shapes and on per-fork node arrays.
   K32 (SelectorSpread's score) at C = 512, 17, 16, 4 and 1 over N = 8192,
   at N = 8190 (a scalar tail; C = 4: the scalar form), 1000 and 100000,
   and on rows whose maxima run 1–399 over every count, at weights 1 and 2,
   with an all-masked row, rows without zone counts, rows with every or no
   entry masked and counts all 0; its split plan against
   kernel_work.k32_plan; one launch a call at C = 1 and 512 proven by a
   CUDA graph; K1 under MostAllocated
   and RequestedToCapacityRatio (the default shape, a descending one and
   one with a flat segment) at C = 512 and C = 1 over N = 8192.
   K33 (the threefry tie noise) on the keys (0, 0), (0, 7) and (2³² − 1,
   2³² − 1): the split of 512 keys, a (512, 8192) noised plane and 512 step
   rows, bit for bit; the plain version against jax.random's words for
   PRNGKey(7) (literals in this script) and K33's row under that key too;
   K17's keyed mode (its draws made in the kernel under the step key) on
   all-tie rows, an all −inf row, a feasible and an infeasible nominated
   row and a tie at the last node; K2's packed mode
   at C = 512 and C = 1 over N = 8192 (−inf exactly off the mask).
3. NorthStar/5000Nodes/10000Pods (5000 node_default nodes, 2000 pre-bound
   and 10000 pending pod_default pods) through TorchScheduler(batch_size=512)
   on cuda, synchronous, launch counts zeroed just before and read just
   after: every pod bound, no node oversubscribed, K1–K4 launched.  Then
   the same suite through the port's perf harness,
   ``run_workload(build_workload("NorthStar", "5000Nodes/10000Pods"))``:
   pipelined, depth 3, the 200 ms micro-bucket target with every tier
   warmed; every measured pod bound, no node oversubscribed, K1–K4, K13
   and K16 launched in the run and inside the measured window (the
   harness's KernelLaunchesInWindow item), the window's dispatches chained
   on placed pods (PipelineInWindow), no kernel built in the window; one
   profiled steady pipelined cycle with the device's idle share; then the
   same cell with the overlapped sync switched the other way and back
   (pods/s, attempt quantiles, and how many background payloads were
   used as built or rebuilt at dispatch).
4. TopologySpreading/5000Nodes at full width (5000 zoned nodes, 5000
   pod_default pods scheduled first through the path, then 2000
   pod_topology_spread pods, the measured run, counts zeroed just before):
   every pod bound, no node oversubscribed, the spread pods' zone counts
   within maxSkew 5, K1–K8 launched; pods/s, rounds per cycle, wall and
   host read per round, phase wall.  Then PreferredTopologySpreading at
   5000 nodes for one cycle of 512 ScheduleAnyway pods: all bound, K5–K8
   launched.  Then TopologySpreading again through
   TorchScheduler(pipeline=True): the same checks, and K14 launched on real
   carries.  Then the three pod-affinity suites at 5000Nodes, full width
   (SchedulingPodAntiAffinity (5000, 1000, 1000), SchedulingPodAffinity and
   SchedulingPreferredPodAffinity (5000, 5000, 1000)): the first pods
   scheduled through the path, the measured pods with the counts zeroed
   just before; every pod bound, no node oversubscribed, no two green pods
   on one host, every blue pod in zone1, K1–K4 and K9–K12 launched; the
   same numbers, with phase_wall["host_prepare"]; then
   SchedulingPreferredPodAffinity through TorchScheduler(pipeline=True),
   K15 launched on real carries.  Each pipelined run's pods/s, attempt
   quantiles and phase walls (sync_overlap among them) stand beside its
   synchronous run's in the record.  Each path builds its cluster on a
   fresh heap (the objects of earlier phases frozen out of the collector),
   and its record counts the full collections inside the measured run.
4c. GangBasic/5000Nodes (5000 nodes labelled into 8-host slices, 600
   PodGroups of min_member 8 with a 60 s timeout, 4800 gang pods of 3 cpu,
   one per host; B = 512) through TorchScheduler synchronously, launch
   counts zeroed just before and read just after: all 4800 bound, no gang
   partly bound, no node oversubscribed, K1–K4 and K20–K23 launched; the
   gangs spread over more than one slice counted; one profiled cycle of 64
   fresh gangs.  Then through ``perf.harness.run_workload`` (pipelined):
   the same checks, K1–K4 and K20–K23 inside the measured window, pods/s,
   gangs/s and time-to-full-slice p50 / p99.
4d. DeviceClaimGang/5000Nodes (GangBasic's cluster plus the warm host,
   one 4-chip ResourceSlice per host, 4800 named 4-chip claims, one per
   gang pod) through TorchScheduler(batch_size=64) synchronously, launch
   counts zeroed just before and read just after: all 4800 bound, every
   claim Reserved for its pod with the 4 named chips of its node, no chip
   held twice, no gang split over slices or partly bound, K1–K4, K20–K23
   and K24–K26 launched, the claim series' 4800 allocations; pods/s,
   gangs/s, claims/s; one profiled cycle of 8 more gangs.  Then through
   ``perf.harness.run_workload`` (pipelined, the suite's B = 512): the same
   checks, K1–K4, K20–K26 inside the measured window, pods/s, gangs/s,
   time to full slice p50 / p99 and ClaimsAllocated.  NorthStar and
   GangBasic fail if a DynamicResources kernel launched (claim-free
   batches carry no claim aux).
4e. PreemptionBasic/5000Nodes (5000 nodes of 4 cpu / 32Gi, 20000 low pods
   of 900m / 500Mi at priority 0 scheduled first, then 5000 high pods of
   3000m / 500Mi at priority 10; B = 512) through TorchScheduler
   synchronously, launch counts zeroed just before the high pods and read
   just after: every high pod bound, exactly 15000 victims and all of them
   low pods, every node holding one high and one low pod, no node over
   allocatable, K1 and K27 + K28 launched, the C++ reprieve sweep run;
   pods/s, attempt p50 / p99, preemption attempts, victims, fast binds,
   phase walls; one profiled failing cycle of 512 priority-20 pods that
   each preempt (idle share, top device ops).  Then through
   ``perf.harness.run_workload`` (pipelined, B = 512): the same checks,
   K27 + K28 launched by the failure warm before the window and inside it,
   no kernel built in the window.
4f. Counterfactuals through ``perf.harness.run_workload`` (pipelined, B =
   512, the suite's controller driven once per measured cycle, launch
   counts zeroed just before): Defrag/5000Nodes (5000 hosts in 8-host
   slices, each fragmented by a pre-bound 2-cpu straggler, 312 gangs of 8;
   the descheduler's slice defragmentation): every gang bound whole inside
   one slice, no gang member evicted, 8 evictions per freed slice, K1–K4,
   K20 and K30 inside the window; pods/s, time to full slice p50 / p99,
   DeschedulerEvictions and WhatIfForks (count and per second), and one
   profiled evaluate of 4 straggler forks (its device idle share).
   AutoscaleGang/5000Nodes (1200 initial hosts, 600 gangs of 8; the
   cluster autoscaler adding whole slices from a NodeGroup): every gang
   bound whole, the group's nodes those the applied scale-ups created
   (less any scale-down once the demand was met), K30 and K31 inside the
   window; pods/s, AutoscalerScaleUps, WhatIfForks per second, time to
   full slice.
4g. Scheduler profiles at full width (5000 node_zoned(ZONES3) nodes, 64
   Services and 64 ReplicaSets selecting app=web-i, 1000 replicas pre-bound
   unevenly, 8 pods naming an unknown scheduler; one TorchScheduler with
   three profiles as ``profiles=`` factories, B = 512): default-scheduler
   (the default set plus SelectorSpread at weight 1 with the store) takes
   2048 replicas, bin-packing (Fit under MostAllocated, from a
   KubeSchedulerConfiguration) 2048 pods of 128 request sizes, rtcr (Fit
   under RequestedToCapacityRatio at the default shape) 1024, one profile's
   wave after another, the launch counts zeroed just before and read just
   after: every pod bound by its own profile, the unknown scheduler's pods
   pending, no node past capacity, SelectorSpread's batches on the full
   auction (the dedup gate refuses its pod-indexed counts), bin-packing's
   on the dedup engine, K1 in every wave and K32 in the default profile's
   wave only; pods/s, routes and phase_wall["host_prepare"] per profile;
   one more default-scheduler cycle of 512 replicas under torch.profiler
   (its device idle share); synchronous, then pipelined.  Then SchedulingWithMixedChurn/5000Nodes
   through ``perf.harness.run_workload`` (the churn hook before every
   measured cycle): every measured pod bound, a churn pod bound, K1–K4 in
   the window.
4h. Extenders and the keyed tie noise.  The extender path at full width:
   5000 node_zoned(ZONES3) nodes, 2000 pre-bound pods, 4096 pod_default
   pods and 32 DoNotSchedule spread pods (a batch of them takes a round
   each) through TorchScheduler(batch_size=512, extenders=[one
   HTTPExtender]) against a TPUScoreExtenderServer in a spawn subprocess
   whose filter rejects every node whose index is 3 mod 7 and whose
   prioritize scores (index · 37) mod 11 (k_cap 500), synchronous, then
   with the async walk: every pod bound, only on approved nodes, no node
   past capacity, the spread held, K1, K2 packed and K13 launched; rounds
   per batch, extender_wait, pods/s, attempt p50 / p99.  Then
   SchedulingExtender/500Nodes through ``perf.harness.run_workload``: every
   measured pod bound, K2 packed in the window, no kernel built in it.
   Then rng_key=(0, 7) (the reference's PRNGKey(7)) on NorthStar's 5000
   nodes with 4096 pods (the full auction: the dedup gate falls back under
   "rng_key"), the same with assign_mode="scan" for 512 pods, and
   TopologySpreading/5000Nodes with 1024 spread pods (the router scans the
   coupled batches) and 256 under assign_mode="batch" (the full auction, a
   commit a round): every pod bound, the spread held, K33 launched, K17's
   keyed mode where the scan runs — there K33's split once a batch and
   its step row never, by its per-entry counts; each beside the same cell
   without a key (pods/s, attempt p99, nodes used).
4b. The full auction and the exact scan at full width (5000 nodes, B =
   512, measured pods with the launch counts zeroed just before them, every
   measured batch through the expected engine, one profiled cycle each):
   TopologySpreading (5000, 5000, 2000) with assign_mode="scan",
   synchronous and pipelined (K17, K18; one K17 launch per measured pod);
   the same suite under "auto" with the spread pods at priority 10 (the
   router scans them) and with assign_mode="batch" for 512 of them (the
   full auction: K6–K8 at C = 512); SchedulingPodAntiAffinity (5000, 1000,
   1000) under "auto" at priority 10, synchronous and pipelined (the full
   auction; K10–K12 at C = 512); SchedulingPreferredPodAffinity and
   SchedulingPodAffinity (5000, 5000, 1000) with assign_mode="scan" (K19 in
   the planes and the tables form); a heterogeneous backlog of 2048 pods of
   cpu 100m + (i mod 400)m on 5000 nodes (the full auction, uncoupled).
   Each prints pods/s, steps or rounds per cycle, device wall per step or
   round, the profiled cycle's device busy time and idle share, and the
   constraint it checked.
5. cuda == cpu bindings: a heterogeneous 5000-node cluster with ~2048
   pending pods of 8 classes; three 1000-node spread clusters (1000
   pod_default pods first, then 512 DoNotSchedule, 512 ScheduleAnyway, or
   256 spread + 256 pod_default pods in one batch); the three affinity
   suites cut to 1000 nodes, 200 first and 512 measured pods; and a mixed
   queue of zone-affinity, spread, pod_default and preferred
   hostname-affinity pods.  cuda pipelined == cuda sync bindings at the
   same segmentation: NorthStar-, spread-, preferred-affinity- and
   anti-affinity-shaped clusters at 1000 nodes.  Each path of 4b cut to
   1000 nodes (200 first pods, 512 measured; 128 for the spread full
   auction, whose CPU half runs a round per pod), and a mixed queue whose four batches take the scan, the full
   auction (twice) and the dedup engine: cuda == cpu bindings and routes.
   GangBasic/500Nodes: cuda == cpu bindings.  Starved gangs (1020 sliced
   nodes, 130 gangs of 8, B = 20, a fake clock): split gangs hold at
   Permit, the gang that cannot complete times out after 60 s and requeues
   atomically, none is partly bound; cuda == cpu on bindings, PodGroup
   phases, held binds and queue counts per cycle, and the gang counters.
   DeviceClaimGang/500Nodes cut to 125 nodes (15 gangs, B = 64): cuda ==
   cpu on bindings, every claim's fields and the claim series.
   Preemption three ways (a clock the script moves): PreemptionBasic/
   500Nodes (fast binds; K27 + K28), the same with
   ``nominated_fast_bind=False`` (nominations live across cycles: K13's
   nominated bundle with live rows), and 200 nodes whose running pods
   carry 800 priorities (the dense form, K29): cuda == cpu on bindings,
   victims, the nominations after every step and the outcomes.
   Defrag/500Nodes and AutoscaleGang/500Nodes driven synchronously with
   their controllers on a clock the script moves: cuda == cpu on bindings,
   evicted pods, the controllers' decisions and fork counts, and on the
   card a 4-fork evaluate stacked (one K30 / K31 launch) equal to one by
   one.  The profiles path cut to 1000 nodes (200 pre-bound, 512 + 512 +
   256 pods): cuda == cpu on bindings and routes, K32 launched.
   SchedulingWithMixedChurn/1000Nodes through ``run_workload``: cuda ==
   cpu bindings.  The extender path at 1000 nodes (200 pre-bound, 512 pods
   and 16 spread pods), synchronous and async, and the keyed auction and
   the keyed scan at 1000 nodes (512 pods): cuda == cpu bindings (and
   rounds).
6. Per-kernel timing at the paths' shapes (K1–K4: a NorthStar cycle's first
   round; K5–K8: a TopologySpreading cycle's first round; K9–K12: a
   SchedulingPreferredPodAffinity cycle's first round; K13–K16: the latest
   call on the pipelined paths): device time per call (torch.profiler;
   after three sessions that record nothing, CUDA events around calls
   queued behind a spin kernel, named in the row's ``ms_source``; one
   elementwise op is timed both ways as a check),
   beside the plain version's wall and, where one PyTorch call computes the
   same function (K3: torch.topk and torch.sort(stable=True); K13:
   Tensor.index_add_, the dead rows masked inside the timed call, K13 and
   it also by queued events side by side; K16:
   Tensor.index_copy per array), that call's time; the least time the card
   could take (the larger of the bytes over 3.35 TB/s and the scalar
   operations over the 67 TFLOP/s float32 peak) from the inputs.  K3 and K4
   here and at C = 512 (6b) are timed by one method, their libraries too
   (the queued-events fallback for all of them if any one needs it); K4
   beside its fixpoint's iterations.  compute_static / compute_row (the
   extender rounds' programs) at B = 512, N = 8192, held against the same
   methods with K1, K2 and K23 swapped for their plain versions.
7. One more NorthStar-shaped, TopologySpreading and
   SchedulingPreferredPodAffinity cycle under torch.profiler: the cycle's
   wall, device time by kernel, and the device's idle share (K3's and K4's
   share of the busy time in every profiled cycle).

6b. K17–K19 on the arguments of their latest call on the scan paths (K19
   in both count forms), K1, K2 and K7 on the TopologySpreading scan's
   one-row step and K11 on the SchedulingPreferredPodAffinity scan's, and
   K1–K4, K8, K11 and K12 at C = 512 on the full auctions' latest rounds,
   timed as in 6.
6c. K20–K23 on the arguments of their latest call on the GangBasic/5000Nodes
   synchronous run (K23: the node-affinity filter's node-selector call),
   timed as in 6; K20 beside the one PyTorch pair that computes the same
   mask (``index_add_`` + gather); K23 one kernel node a call.
6d. K24–K26 on the arguments of their latest call on the
   DeviceClaimGang/5000Nodes synchronous run, timed as in 6; K26 beside
   ``index_add_`` of the committed pods' demands (the masking inside the
   timed call, both sides by one method).
6e. K27 and K28 on the arguments of their latest call on the
   PreemptionBasic/5000Nodes synchronous run, K29 on the dense check's
   inputs (B = 64, N = 8192, P = 32768, 300 priorities), timed as in 6;
   K27 beside ``index_put_(accumulate=True)`` + ``cumsum``, K29 beside the
   dense einsum; K13 with the nominated bundle alone (B2, 512 live rows of
   a 1024-row cap, no nz rows) beside ``index_add_`` (the masking inside
   the timed call, both sides by one method, and both by queued events).
6f. K30 on the arguments of its latest call at the largest fork count on
   the Defrag harness run, K31 on those of its latest at the largest fork
   count on the AutoscaleGang harness run, timed as in 6 (no one PyTorch
   call computes either); the profiled 4-fork evaluate's bound, the sum of
   its launches' bounds.
6g. K32 on the arguments of its latest [C, N] call on the profiles path's
   synchronous run, and K1 on those of its latest call under MostAllocated
   and under RequestedToCapacityRatio there, timed as in 6 (no one PyTorch
   call computes either).
6h. K33 (its noise plane at the last keyed full auction's latest [512,
   8192] round, its step keys on the last keyed scan, and select_host's
   step row at that scan's N — the scan no longer launches it), K17's
   keyed mode on that scan's latest step (one kernel node a call) and K2's
   packed mode on the extender path's latest round, timed as in 6 (no one
   PyTorch call computes any of them).

Output: progress lines, a ``{"kernels": [...]}`` line (``launches`` counted
on the path that carries each kernel: K1–K8 on the TopologySpreading run,
K9–K12 on the SchedulingPreferredPodAffinity run, K13 and K16 on the
NorthStar harness run, K14 and K15 on the pipelined TopologySpreading and
SchedulingPreferredPodAffinity runs, K17 and K18 on the TopologySpreading
scan, K19 on the two pod-affinity scans, the C = 512 rows on the full
auction that gave their arguments, K20–K23 on the GangBasic synchronous
run, K24–K26 on the DeviceClaimGang synchronous run, K27 and K28 on the
PreemptionBasic synchronous run, K29 on the dense preemption run, K30 on the
Defrag harness run, K31 on the AutoscaleGang harness run, K32 and K1's
MostAllocated / RequestedToCapacityRatio rows on the profiles path's
synchronous run, in the wave of their profile, K33's plane on the keyed
TopologySpreading full auction, its step keys, its step row (0) and K17's
keyed mode on the keyed TopologySpreading scan — each K33 entry by its own
count —, K2's packed mode on the synchronous extender path),
the card's name and power limit as
nvidia-smi prints them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A detailed record goes to chiprun_out/chip_smoke.json, the profiled
cycles' tables to chiprun_out/profile_cycle.txt,
chiprun_out/profile_spread_cycle.txt, chiprun_out/profile_affinity_cycle.txt,
chiprun_out/profile_pipelined_cycle.txt, chiprun_out/profile_gang_cycle.txt,
chiprun_out/profile_claim_gang_cycle.txt, chiprun_out/profile_preempt_cycle.txt and
chiprun_out/profile_evaluate.txt (the Defrag cluster's 4-fork evaluate) and
chiprun_out/profile_profiles_cycle.txt (one default-scheduler cycle of the
profiles path, SelectorSpread's K32 in it).
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# the bound formulas, K11 / K12's synthetic inputs and K17's plan, shared
# with kernel_ab.py
from kubernetes_tpu_torch.perf import kernel_work as KW
from kubernetes_tpu_torch.perf.host_timer import host_issue_us
from kubernetes_tpu_torch.perf.kernel_work import bound_ms, k1_work, k7_work, nbytes

SEED = 20261016
IPA_KERNELS = ("ipa_prepare", "ipa_filter_bits", "ipa_score_combine", "ipa_update_classes")
# K1–K12 in order: K1–K4 carry every path, K5–K8 the spread path, K9–K12
# the affinity path
PATH_KERNELS = ("filter_score_planes", "normalize_combine", "topk_rows",
                "auction_resolve_commit", "spread_prepare_counts", "spread_filter_bits",
                "spread_score_combine", "spread_update_classes") + IPA_KERNELS


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


# how the latest device_ms call measured: "profiler" or "queued_events"; each
# kernel row carries it as ``ms_source``
MS_SOURCE = ["profiler"]


def queued_device_ms(fn, reps: int = 20) -> float:
    """Device time per call without the profiler: a spin kernel holds the
    stream while the host enqueues ``reps`` calls behind it, so the CUDA
    events around the calls bracket back-to-back device work and no host
    launch.  Fails if the host took longer to enqueue than the spin lasted
    (the calls would then have waited for their launches)."""
    import torch

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the card's clock
    ev[1].record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    if enqueue_ms >= 0.8 * spin_ms:
        fail(f"queued timing: enqueuing {reps} calls took {enqueue_ms:.2f} ms, the "
             f"spin only {spin_ms:.2f} ms")
    return ev[1].elapsed_time(ev[2]) / reps


def device_ms(fn, kernel: str = None, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call from torch.profiler: the summed device time of
    the CUDA activities whose name contains ``kernel`` (all of the call's
    device activities when None), over ``reps`` calls.  Unlike CUDA-event
    timing of back-to-back calls, this excludes the host's launch overhead,
    which for a microsecond kernel is most of the wall.  A profiler session
    that records no matching device time, or a number of matching records
    that is not a whole multiple of ``reps``, is tried twice more;
    if none does, the calls are timed queued behind a spin kernel
    (``queued_device_ms``, device time too) and ``MS_SOURCE`` says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    MS_SOURCE[0] = "profiler"
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, n_events = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if kernel is None or kernel in e.key:
                v = getattr(e, "self_device_time_total", None)
                total_us += v if v is not None else getattr(e, "self_cuda_time_total", 0)
                n_events += e.count
        # every call launches the same activities: a session that kept fewer
        # of their records (a whole call's or a named kernel's) would read low
        if total_us > 0 and n_events % reps == 0:
            return total_us / reps / 1e3
        if total_us > 0:
            log(f"  the profiler kept {n_events} records of {kernel or 'the call'} over "
                f"{reps} calls")
    MS_SOURCE[0] = "queued_events"
    ms = queued_device_ms(fn, reps)
    log(f"  the profiler recorded no whole device time for {kernel or 'the call'} (three "
        f"sessions): {ms:.5f} ms a call queued behind a spin kernel instead")
    return ms


def ms_one_method(fn, kernel: str = None, *library_fns) -> tuple:
    """(the call's device ms, each library call's device ms, the method):
    ``device_ms`` for all of them, or — when any one of them needs the
    queued-events fallback — ``queued_device_ms`` for all, so that a kernel
    and its yardsticks are never timed two ways."""
    ms = device_ms(fn, kernel)
    sources = {MS_SOURCE[0]}
    libs = []
    for lib in library_fns:
        libs.append(device_ms(lib))
        sources.add(MS_SOURCE[0])
    if sources != {"profiler"}:
        ms = queued_device_ms(fn)
        libs = [queued_device_ms(lib) for lib in library_fns]
    MS_SOURCE[0] = "profiler" if sources == {"profiler"} else "queued_events"
    return ms, libs, MS_SOURCE[0]


def kernel_hit(name: str, symbol: str) -> bool:
    """Does the profiler's activity ``name`` belong to kernel ``symbol``
    (a plain or a templated kernel: ``symbol(`` or ``void symbol<...>(``)?"""
    name = name[5:] if name.startswith("void ") else name
    return name.startswith(symbol + "(") or name.startswith(symbol + "<")


# K2, K3 and K4 at every shape they have a row for (NorthStar's C = 4
# round, the heterogeneous backlog's C = 512 round; K2 also at the scan
# step's C = 1 and in its packed mode): label → (the kernel's call, its
# symbol, its library calls by row key), so that main can time all of them
# by one method
ROUND_CALLS = {}


def time_round_kernels(rows) -> str:
    """K2's, K3's and K4's rows, and their library calls, timed by one
    method (the profiler, or the queued-events fallback for all of them if
    any one needs it) → the method."""
    got = {r["name"]: r for r in rows if r["name"] in ROUND_CALLS}
    if len(got) != len(ROUND_CALLS):
        fail(f"K2 / K3 / K4 timing: rows {sorted(got)} of {sorted(ROUND_CALLS)}")
    times, sources = {}, set()
    for label, (fn, symbol, libs) in ROUND_CALLS.items():
        times[label] = {"ms": device_ms(fn, symbol)}
        sources.add(MS_SOURCE[0])
        for k, f in libs.items():
            times[label][k] = device_ms(f)
            sources.add(MS_SOURCE[0])
    method = "profiler" if sources == {"profiler"} else "queued_events"
    for label, (fn, symbol, libs) in ROUND_CALLS.items():
        if method == "queued_events":
            times[label] = {"ms": queued_device_ms(fn),
                            **{k: queued_device_ms(f) for k, f in libs.items()}}
        r = got[label]
        r.update(times[label])
        r["ms_source"] = method
        if "iterations" in r:
            r["ms_per_iteration"] = r["ms"] / max(r["iterations"], 1)
    log("K2 / K3 / K4 rows, one method (" + method + "): " + "; ".join(
        f"{label} {got[label]['ms']:.5f} ms"
        + "".join(f", {k} {got[label][k]:.5f}" for k in ROUND_CALLS[label][2])
        + (f", {got[label]['iterations']} iterations ({got[label]['prefix_steps']} "
           "by the prefix form)" if "iterations" in got[label] else "")
        for label in ROUND_CALLS))
    return method


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    same = (torch.isinf(a) & torch.isinf(b) & (a == b)) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def _equal(a, b) -> bool:
    """Exactly equal, NaN matching NaN (the snapshot's numeric label planes
    hold NaN for non-numeric values)."""
    import torch

    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def require_equal(name: str, pairs) -> float:
    err = 0.0
    for what, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype or not _equal(a, b):
            bad = (a != b).nonzero()[:5].tolist() if a.shape == b.shape else "shape"
            fail(f"{name}: kernel and plain version differ in {what} at {bad}")
        err = max(err, max_abs_err(a, b))
    return err


def fresh_heap() -> None:
    """Collect, then move every object alive now out of the collector's
    reach (gc.freeze), so a path's measured run pays full collections over
    its own cluster state but not over the clusters of earlier phases, which
    this script keeps alive for its later phases."""
    gc.collect()
    gc.freeze()


class GcWatch:
    """Counts the full (generation 2) collections and their seconds while
    active: the host pauses inside a measured run."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def _cb(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


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


def wide_k1_case(c: int, n: int, gen, device, strategy: str):
    """K1's inputs past every width its shared-memory staging holds: R = 12
    (an extended dimension weighted in Fit and selected by
    BalancedAllocation, requested by half the classes), nodes with up to 16
    taints, host ports and images (most past the staged counts), classes
    with 12 tolerations, host ports and image ids (many past theirs), and
    under RequestedToCapacityRatio a 40-point shape (past the staged
    points) → (rep, snap, dyn, na_mask, na_pref, plan)."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.plugins.noderesources import BalancedAllocationPlugin, FitPlugin

    w = 16
    snap = synthetic_snapshot(n, gen, device)
    rep, na_mask, na_pref = synthetic_classes(c, n, gen, device)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    def pick(vals, *shape):
        v = torch.tensor(vals, dtype=torch.int32)
        return v[torch.randint(0, len(vals), shape, generator=gen)]

    def widen(t, extra):
        return torch.cat([t.cpu(), extra], 1).to(device)

    alloc = widen(snap.allocatable, torch.where(torch.rand((n, 4), generator=gen) < 0.7,
                                                ri(1, 9, n, 4), 0))
    requested = widen(snap.requested, ri(0, 5, n, 4))
    snap = dataclasses.replace(snap, allocatable=alloc, requested=requested, **{
        k: v.to(device) for k, v in {
            "taint_keys": pick([-1, 3, 10, 11, 12], n, w), "taint_vals": pick([20, 21], n, w),
            "taint_effects": pick([-1, 0, 1, 1, 2], n, w),
            "ports": pick([-1, 8080, 9090, 7000, 7001, 65536 + 53], n, w),
            "ports_ip": pick([6, 30, 31], n, w),
            "image_ids": pick([-1, 40, 41, 42, 43, 44, 45], n, w),
            "image_sizes": torch.rand((n, w), generator=gen) * 1e9}.items()})
    dyn = SimpleNamespace(requested=snap.requested, non_zero=snap.non_zero_requested)
    tt = 12
    rep.request = widen(rep.request, torch.where(torch.rand((c, 4), generator=gen) < 0.5,
                                                 ri(1, 4, c, 4), 0))
    rep.tol_valid = (torch.rand((c, tt), generator=gen) < 0.9).to(device)
    rep.tol_key = pick([-1, 3, 10, 11, 12], c, tt).to(device)
    rep.tol_val = pick([20, 21], c, tt).to(device)
    rep.tol_op = pick([0, 1], c, tt).to(device)
    rep.tol_effect = pick([-1, 0, 1, 2], c, tt).to(device)
    rep.ports = pick([-1, 8080, 9090, 7000, 7002], c, tt).to(device)
    rep.ports_ip = pick([6, 30, 31], c, tt).to(device)
    rep.image_ids = pick([-1, 40, 41, 42, 43, 46], c, tt).to(device)
    ext = {"example.com/a": 9, "example.com/b": 11}
    shape = [(2.5 * i, (i * 7) % 11) for i in range(40)] if strategy == \
        "RequestedToCapacityRatio" else None
    fit = FitPlugin(strategy, resources={"cpu": 1, "memory": 1, "example.com/a": 3},
                    num_resource_dims=12, extended_index=ext, shape=shape)
    ba = BalancedAllocationPlugin(resources={"cpu": 1, "memory": 1, "example.com/b": 1},
                                  num_resource_dims=12, extended_index=ext)
    _fw, (fs_plan, _c) = framework_plans()
    plan = dataclasses.replace(fs_plan, fit=fit, balanced=ba)
    return rep, snap, dyn, na_mask, na_pref, plan


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
    from kubernetes_tpu_torch.kernels.topk import topk_rows_plain
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
            err["topk_rows"] = max(err["topk_rows"], topk_equal(f"N={n} K={k}", rows, k))
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
    # K1 past its staged widths (every overflow path), and over C and N
    # that cut its node tiles and class chunks unevenly
    for strategy in ("LeastAllocated", "RequestedToCapacityRatio"):
        rep, snap, dyn, na_mask, na_pref, plan = wide_k1_case(37, 1000, gen, dev, strategy)
        img = image_scaled_by_id(snap)
        kb, kr = filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, plan)
        pb, pr = filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, plan)
        torch.cuda.synchronize()
        err["filter_score_planes"] = max(err["filter_score_planes"], require_equal(
            f"filter_score_planes wide rows, {strategy}", [("bits", kb, pb), ("raw", kr, pr)]))
        cases["filter_score_planes"] += 1
    for c, n in ((1, 8192), (3, 700), (17, 129), (100, 5000), (513, 1000)):
        snap = synthetic_snapshot(n, gen, dev)
        dyn = DynamicState(requested=snap.requested, non_zero=snap.non_zero_requested)
        rep, na_mask, na_pref = synthetic_classes(max(c, 2), n, gen, dev)
        rep = SimpleNamespace(**{k: v[:c] for k, v in vars(rep).items()})
        na_mask, na_pref = na_mask[:c], na_pref[:c]
        img = image_scaled_by_id(snap)
        kb, kr = filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
        pb, pr = filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, fs_plan)
        torch.cuda.synchronize()
        err["filter_score_planes"] = max(err["filter_score_planes"], require_equal(
            f"filter_score_planes C={c} N={n}", [("bits", kb, pb), ("raw", kr, pr)]))
        cases["filter_score_planes"] += 1
    err["topk_rows"] = max(err["topk_rows"], check_topk_grid(dev, cases))
    err["normalize_combine"] = max(err["normalize_combine"], check_normalize_grid(dev, cases))
    err["auction_resolve_commit"] = max(err["auction_resolve_commit"],
                                        check_auction_cases(dev, gen, cases))
    log(f"kernel-vs-plain: all equal ({json.dumps(cases)})")
    return err


def topk_equal(what: str, rows, k: int) -> float:
    """K3 on ``rows`` against its plain version, bit for bit (the values'
    bits too: −0.0 stays −0.0), in one launch."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels.topk import topk_rows, topk_rows_plain

    before = kernels.LAUNCHES["topk_rows"]
    kv, ki = topk_rows(rows, k)
    if kernels.LAUNCHES["topk_rows"] - before != 1:
        fail(f"topk_rows {what}: {kernels.LAUNCHES['topk_rows'] - before} launches, not one")
    pv, pi = topk_rows_plain(rows, k)
    torch.cuda.synchronize()
    return require_equal(f"topk_rows {what}", [
        ("values", kv, pv), ("columns", ki, pi),
        ("value bits", kv.view(torch.int32), pv.view(torch.int32))])


TOPK_GRID_C = (1, 4, 512)
TOPK_GRID_N = (20, 500, 5000, 8192, 131072)
TOPK_GRID_K = (1, 20, 64, 384, 512, 1024)


def topk_rows_case(c: int, n: int, k: int, gen, dev):
    """[C, N] rows for K3's grid: the adversarial rows (all-tie, all −inf,
    ties with −inf holes, ±0.0, 99.9% −inf, and ties at the K-th value
    across hundreds of columns around the middle, where a cluster's row
    splits between two blocks: K/2 larger values scattered, then a run of
    5.0 over the middle 600 columns) rotated by
    the case, then random rows of small integers with −inf holes and of
    normal draws (made on the card)."""
    import torch

    def tied_kth():
        row = torch.randint(0, 3, (n,), generator=gen).float()
        row[torch.randperm(n, generator=gen)[: k // 2]] = 10.0
        row[max(n // 2 - 300, 0): n // 2 + 300] = 5.0
        return row

    adv = [
        torch.full((n,), 300.0),
        torch.full((n,), float("-inf")),
        torch.where(torch.rand(n, generator=gen) < 0.5, float("-inf"),
                    torch.randint(0, 4, (n,), generator=gen).float()),
        torch.where(torch.rand(n, generator=gen) < 0.5, -0.0, 0.0),
        torch.where(torch.rand(n, generator=gen) < 0.999, float("-inf"), 7.0),
        tied_kth(),
    ]
    shift = (n + k) % len(adv)
    adv = adv[shift:] + adv[:shift]
    rows = torch.stack(adv[:c]).to(dev)
    if c > len(adv):
        g = torch.Generator(device=dev).manual_seed(SEED + n + k)
        m = c - len(adv)
        ints = torch.randint(0, 50, (m, n), generator=g, device=dev).float()
        holes = torch.rand((m, n), generator=g, device=dev) < 0.3
        ints = torch.where(holes, float("-inf"), ints)
        normal = torch.randn((m, n), generator=g, device=dev)
        rnd = torch.where((torch.arange(m, device=dev) % 2 == 0)[:, None], ints, normal)
        rows = torch.cat([rows, rnd])
    return rows


def check_topk_grid(dev, cases: dict) -> float:
    """K3 over C ∈ TOPK_GRID_C × N ∈ TOPK_GRID_N × K ∈ TOPK_GRID_K (K <= N),
    bit for bit against its plain version, one launch a call."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 3)
    err = 0.0
    for c in TOPK_GRID_C:
        for n in TOPK_GRID_N:
            for k in TOPK_GRID_K:
                if k > n:
                    continue
                rows = topk_rows_case(c, n, k, gen, dev)
                err = max(err, topk_equal(f"C={c} N={n} K={k}", rows, k))
                cases["topk_rows"] += 1
    return err


NORM_GRID_C = (1, 4, 16, 17, 512)
NORM_GRID_N = (20, 500, 5000, 8192, 131072)
NORM_GRID_P = (1, 5, 8)
# the kinds a P-plane case takes (0 identity, 1 default, 2 reversed): the
# framework's five planes at P = 5 (Fit, BalancedAllocation, ImageLocality
# identity; NodeAffinity default; TaintToleration reversed)
NORM_KINDS = {1: ((1,), (2,), (0,)), 5: ((0, 0, 0, 1, 2),), 8: ((1, 2, 0, 1, 2, 0, 1, 2),)}
NORM_FULL = 0b1111111


def normalize_case(c: int, n: int, p: int, case: int, dev, *, misalign: bool = False):
    """K2's inputs for one grid case, made on the card from a seed: a bit
    plane (7 filter bits, ~70% of the nodes feasible; in every other case
    the last quarter of the nodes dead, bits 0) and P raw planes of
    small integers and fractions, with larger values on infeasible nodes
    (which no maximum may take); special rows, rotated by the case at C =
    1: no feasible node, every normalized plane's maximum 0 on the feasible
    nodes, and a maximum on a floor boundary (values max · k / 100, which
    land on or just beside an integer after the scaling); ``misalign``: the
    bit plane and the raw planes start 4 bytes past an alignment boundary
    (the kernel's scalar path).  → (bits, raw, plan)"""
    import torch

    from kubernetes_tpu_torch.kernels.normalize import CombinePlan

    g = torch.Generator(device=dev).manual_seed(SEED + 7919 * c + 31 * n + p + case)

    def fresh(shape, dtype):
        if not misalign:
            return torch.empty(shape, dtype=dtype, device=dev)
        flat = torch.empty(int(torch.tensor(shape).prod()) + 1, dtype=dtype, device=dev)
        return flat[1:].view(shape)

    bits = fresh((c, n), torch.int32)
    drop = torch.randint(0, 7, (c, n), generator=g, device=dev)
    feasible = torch.rand((c, n), generator=g, device=dev) < 0.7
    bits.copy_(torch.where(feasible, NORM_FULL, NORM_FULL & ~(1 << drop)))
    if case % 2:  # a node tier's dead rows: the last quarter's bits 0
        bits[:, n - n // 4:] = 0
    raw = fresh((p, c, n), torch.float32)
    ints = torch.randint(0, 101, (p, c, n), generator=g, device=dev).float()
    frac = torch.rand((p, c, n), generator=g, device=dev) * 100
    vals = torch.where(torch.rand((p, c, n), generator=g, device=dev) < 0.5, ints, frac)
    raw.copy_(torch.where(feasible[None], vals, vals + 1000.0))
    special = [0, 1, 2] if c >= 4 else [[None, 0, 1, 2][case % 4]]
    for row, kind in zip(range(1, 4), special):
        r = row if c >= 4 else 0
        if kind is None:
            continue
        if kind == 0:  # no feasible node
            bits[r] = NORM_FULL & ~1
        elif kind == 1:  # maxima 0 on the feasible nodes, larger off them
            raw[:, r] = torch.where(feasible[r][None], 0.0, raw[:, r])
        else:  # a maximum on a floor boundary
            mx = torch.tensor([7.0, 3.0, 0.3, 12.5, 99.0, 0.07, 1e-3, 33.0])[:p].to(dev)
            k = torch.randint(0, 101, (p, n), generator=g, device=dev).float()
            edge = (mx[:, None] * k / 100.0).float()
            edge[:, 0] = mx
            raw[:, r] = torch.where(feasible[r][None], edge, raw[:, r])
            bits[r, 0] = NORM_FULL
    kinds = NORM_KINDS[p][(case // len(NORM_GRID_P)) % len(NORM_KINDS[p])]
    weights = tuple(float((case + 3 * j) % 5) for j in range(p))
    plan = CombinePlan(kinds=kinds, weights=weights, const_add=float(case % 3) * 100.0)
    return bits, raw, plan


def normalize_equal(what: str, bits, raw, plan) -> float:
    """K2 on (bits, raw, plan) against its plain version in both modes, the
    totals bit for bit (their int32 views) and the feasible counts exactly,
    one launch a call."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine, \
        normalize_combine_plain

    before = dict(kernels.LAUNCHES)
    kt, kf = normalize_combine(bits, NORM_FULL, raw, plan)
    kp = normalize_combine(bits, NORM_FULL, raw, plan, packed=True)
    got = {k_: kernels.LAUNCHES[k_] - before[k_]
           for k_ in ("normalize_combine", "normalize_combine_packed")}
    if got != {"normalize_combine": 1, "normalize_combine_packed": 1}:
        fail(f"normalize_combine {what}: launches {got}, not one a call")
    pt, pf = normalize_combine_plain(bits, NORM_FULL, raw, plan)
    torch.cuda.synchronize()
    return require_equal(f"normalize_combine {what}", [
        ("total", kt, pt), ("feasible", kf, pf), ("packed", kp, pt),
        ("total bits", kt.view(torch.int32), pt.view(torch.int32)),
        ("packed bits", kp.view(torch.int32), pt.view(torch.int32))])


def check_normalize_grid(dev, cases: dict) -> float:
    """K2 over C ∈ NORM_GRID_C × N ∈ NORM_GRID_N × P ∈ NORM_GRID_P (each
    kind at P = 1 over the cases, the framework's kinds at P = 5), full and
    packed, bit for bit; then N = 4099 and misaligned planes (the scalar
    path) at C = 4 and 512."""
    err, case = 0.0, 0
    for c in NORM_GRID_C:
        for n in NORM_GRID_N:
            for p in NORM_GRID_P:
                err = max(err, normalize_equal(f"C={c} N={n} P={p}",
                                               *normalize_case(c, n, p, case, dev)))
                cases["normalize_combine"] += 1
                case += 1
    for c in (4, 512):
        for n, mis in ((4099, False), (8192, True)):
            err = max(err, normalize_equal(f"C={c} N={n} (scalar path)",
                                           *normalize_case(c, n, 5, case, dev, misalign=mis)))
            cases["normalize_combine"] += 1
            case += 1
    return err


def auction_case(gen, dev, *, n=8192, b=512, k=512, classes=1, nominated=0.0,
                 resolved=0.0, permuted=True, finite=None, same_list=False, overlap=False):
    """K4's inputs: ``classes`` candidate lists (the top K of random class
    rows, as K3 gives them; ``finite``: only that many finite entries a row;
    ``same_list``: every class the first's row; ``overlap``: one base row
    plus small per-class noise, so the lists share most nodes, as the
    heterogeneous backlog's classes do); ``nominated`` of the pods with a
    nominated row, half of them on a node of their list; ``resolved`` of
    the pods not unresolved; positions permuted or in order."""
    import torch

    from kubernetes_tpu_torch.kernels.topk import topk_rows_plain

    if overlap:
        base = torch.randint(0, 100, (n,), generator=gen).float()
        vals = base + torch.randint(0, 3, (classes, n), generator=gen).float()
    else:
        vals = torch.randint(0, 20, (classes, n), generator=gen).float()
    vals[torch.rand(classes, n, generator=gen) < 0.1] = float("-inf")
    if finite is not None:
        vals[:, finite:] = float("-inf")
    if same_list:
        vals[1:] = vals[0]
    cand_val, cand_idx = topk_rows_plain(vals, k)
    class_of = torch.randint(0, classes, (b,), generator=gen)
    unres = torch.rand(b, generator=gen) >= resolved
    nom_ok = torch.rand(b, generator=gen) < nominated
    in_list = cand_idx[class_of, torch.randint(0, k, (b,), generator=gen)].long()
    nom = torch.where(torch.rand(b, generator=gen) < 0.5, in_list,
                      torch.randint(0, n, (b,), generator=gen))
    pos_of = torch.randperm(b, generator=gen) if permuted else torch.arange(b)
    request = torch.randint(1, 500, (b, 8), generator=gen, dtype=torch.int32)
    pod_nz = request[:, :2].clone()
    requested = torch.randint(0, 1 << 20, (n, 8), generator=gen, dtype=torch.int32)
    node_nz = requested[:, :2].clone()
    args = [t.to(dev) for t in (cand_val, cand_idx, class_of, pos_of, unres, nom, nom_ok,
                                request, pod_nz)]
    return args, requested.to(dev), node_nz.to(dev)


# K4's phase-2 cases: name → (auction_case keywords, must the one-class
# closed form end the fixpoint within four iterations)
AUCTION_CASES = {
    "one class, 5% nominated": (dict(nominated=0.05), True),
    "one class, fewer finite entries than bidders": (dict(finite=300), True),
    "one class, 30% resolved, permuted": (dict(resolved=0.3), True),
    "two classes, one list": (dict(classes=2, same_list=True), None),
    "400 overlapping classes": (dict(classes=400, overlap=True, nominated=0.05,
                                     resolved=0.1), None),
    "N = 131072": (dict(n=131072, classes=8, nominated=0.1, resolved=0.1), None),
    "N = 131072, one class": (dict(n=131072), True),
}


def check_auction_cases(dev, gen, cases: dict) -> float:
    """K4 on AUCTION_CASES against its plain version: commit, choice,
    requested and non_zero equal; the closed form ends the one-class cases."""
    import torch

    from kubernetes_tpu_torch.kernels.auction import (
        auction_resolve_commit,
        auction_resolve_commit_plain,
    )

    err = 0.0
    for name, (kw, closed) in AUCTION_CASES.items():
        args, req, nz = auction_case(gen, dev, **kw)
        kreq, knz = req.clone(), nz.clone()
        kc, kch, iters = auction_resolve_commit(*args, kreq, knz, count_iters=True)
        pc, pch = auction_resolve_commit_plain(*args, req, nz)
        torch.cuda.synchronize()
        err = max(err, require_equal(f"auction_resolve_commit ({name})", [
            ("commit", kc, pc), ("choice", kch, pch), ("requested", kreq, req),
            ("non_zero", knz, nz)]))
        it, steps = iters.tolist()
        if closed and not (steps >= 1 and it <= 4):
            fail(f"auction_resolve_commit ({name}): the closed form did not end the "
                 f"fixpoint ({it} iterations, {steps} by the prefix form)")
        log(f"  auction_resolve_commit ({name}): {int(kc.sum())} commits, {it} iterations, "
            f"{steps} by the prefix form")
        cases["auction_resolve_commit"] += 1
    return err


# --- phase 2: K5–K8 vs plain -------------------------------------------------------------


def spread_case(name: str, gen, dev, *, c=4, cc=1, n=8192, p=8192, b=512, d=8, n_dom=3,
                keyless=0.0, counted=0.9, min_domains=0, counts=None, mask_frac=0.9,
                soft=True, hard=0.8):
    """A synthetic PodTopologySpread class view (the TSAux fields) plus the
    round inputs, on ``dev``: ``n_dom`` live domains of ``d``, ``keyless``
    of the nodes without the key, ``counts`` forced soft/hard count values
    on the live domains, ``min_domains`` on every constraint, ``hard`` the
    share of hard constraints."""
    import torch

    from kubernetes_tpu_torch.plugins.podtopologyspread import TSAux

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    dom = torch.randint(0, max(n_dom, 1), (c, cc, n), generator=gen, dtype=torch.int32)
    has_key = rnd(c, cc, n) >= keyless
    dom = torch.where(has_key, dom, d).to(torch.int32)
    counted_hard = rnd(c, n) < counted
    counted_soft = rnd(c, n) < counted
    match_sched = rnd(c, cc, p) < 0.5
    pod_node = torch.randint(-1, n, (p,), generator=gen, dtype=torch.int32)
    hard_counts = torch.randint(0, 40, (c, cc, d + 1), generator=gen, dtype=torch.int32)
    soft_counts = torch.randint(0, 40, (c, cc, d + 1), generator=gen, dtype=torch.int32)
    if counts is not None:
        vals = torch.tensor(counts, dtype=torch.int32)
        idx = torch.randint(0, len(counts), (c, cc, d + 1), generator=gen)
        hard_counts, soft_counts = vals[idx], vals[idx.flip(-1)]
    hard_present = (rnd(c, cc, d + 1) < 0.8)
    hard_present[..., n_dom:] = False
    aux = TSAux(
        hard_valid=rnd(c, cc) < hard,
        soft_valid=(rnd(c, cc) < 0.8) if soft else torch.zeros((c, cc), dtype=torch.bool),
        max_skew=torch.randint(1, 4, (c, cc), generator=gen, dtype=torch.int32),
        min_domains=torch.full((c, cc), min_domains, dtype=torch.int32),
        self_match=rnd(c, cc) < 0.5, dom_val=dom, has_key=has_key,
        counted_hard=counted_hard, counted_soft=counted_soft,
        hard_counts=hard_counts, soft_counts=soft_counts, hard_present=hard_present,
        match_pending=rnd(c, cc, 4) < 0.6)
    if counts is not None:  # the 379 / 4927 cases: maxSkew 1, every row soft
        aux = aux._replace(max_skew=torch.ones((c, cc), dtype=torch.int32),
                           soft_valid=torch.ones((c, cc), dtype=torch.bool))
    full = (1 << 16) - 1
    bits = torch.where(rnd(c, n) < mask_frac, full, full & ~(1 << 3)).to(torch.int32)
    bits[c - 1] = torch.where(rnd(n) < 0.5, full, 0).to(torch.int32)
    total = torch.where(bits == full, torch.randint(0, 700, (c, n), generator=gen).float(),
                        float("-inf"))
    commit = rnd(b) < 0.3
    choice = torch.randint(0, n, (b,), generator=gen, dtype=torch.int32)
    class_of = torch.randint(0, 4, (b,), generator=gen)
    to = lambda t: t.to(dev)  # noqa: E731
    return dict(name=name, aux=aux._replace(**{f: to(getattr(aux, f)) for f in aux._fields}),
                match_sched=to(match_sched), pod_node=to(pod_node), d=d, full=full,
                bits=to(bits), total=to(total), commit=to(commit), choice=to(choice),
                class_of=to(class_of))


def check_spread_kernels(dev) -> dict:
    """K5–K8 against their plain versions on random and adversarial inputs:
    every domain empty, nodes without the key, minDomains above the present
    domains, a row whose raw scores are all 0 (max 0), ignored (NaN) nodes,
    five domains with counts of 379 and 4927 under maxSkew 1, 3 and 64
    domains, one and two constraints, hostname tables, one row (C = 1) whose
    filter clears bits; K8 with class_of int64 and int32 — every output
    exactly equal."""
    import torch

    from kubernetes_tpu_torch.kernels import spread as K

    gen = torch.Generator().manual_seed(SEED + 5)
    cases = [
        spread_case("3 domains", gen, dev),
        spread_case("64 domains, 2 constraints", gen, dev, cc=2, d=64, n_dom=64),
        spread_case("keyless nodes (ignored / NaN)", gen, dev, keyless=0.3, cc=2),
        spread_case("every domain empty", gen, dev, counted=0.0, n_dom=0),
        spread_case("minDomains above present", gen, dev, min_domains=7, d=16, n_dom=5),
        spread_case("5 domains, counts 379 / 4927", gen, dev, n_dom=5, counts=[379, 4927]),
        spread_case("all raw scores 0 (max 0)", gen, dev, n_dom=5, counts=[0]),
        spread_case("no soft constraint", gen, dev, soft=False, cc=2),
        spread_case("no feasible node", gen, dev, mask_frac=0.0),
        spread_case("N = 1001 (scalar loads), 2 constraints", gen, dev, n=1001, cc=2),
        spread_case("hostname bucket (D + 1 = 8193), 2 constraints", gen, dev, cc=2, d=8192,
                    n_dom=5000, keyless=0.1),
        spread_case("hostname bucket, minDomains above present (counts 1 / 2)", gen, dev,
                    d=8192, n_dom=5000, min_domains=4500, counts=[1, 2]),
        spread_case("hostname bucket, N = 1001 (scalar loads, one block)", gen, dev, n=1001,
                    d=8192, n_dom=900, min_domains=800, counts=[3, 5]),
        spread_case("C = 1 (the scan's step), keyless nodes", gen, dev, c=1, keyless=0.2,
                    hard=1.0),
        spread_case("C = 1, hostname bucket", gen, dev, c=1, d=8192, n_dom=5000, keyless=0.1,
                    hard=1.0),
    ]
    err = {k: 0.0 for k in ("spread_prepare_counts", "spread_filter_bits",
                            "spread_score_combine", "spread_update_classes")}
    for cs in cases:
        aux, what = cs["aux"], cs["name"]
        args = (cs["match_sched"], cs["pod_node"], aux.dom_val, aux.counted_hard,
                aux.counted_soft, cs["d"])
        k5 = K.spread_prepare_counts(*args)
        p5 = K.spread_prepare_counts_plain(*args)
        torch.cuda.synchronize()
        err["spread_prepare_counts"] = max(err["spread_prepare_counts"], require_equal(
            f"spread_prepare_counts ({what})",
            [("hard_counts", k5[0], p5[0]), ("soft_counts", k5[1], p5[1]),
             ("hard_present", k5[2], p5[2])]))
        for bit in (3, 12):
            kb, pb = cs["bits"].clone(), cs["bits"].clone()
            K.spread_filter_bits(aux, kb, bit)
            K.spread_filter_bits_plain(aux, pb, bit)
            torch.cuda.synchronize()
            err["spread_filter_bits"] = max(err["spread_filter_bits"], require_equal(
                f"spread_filter_bits ({what}, bit {bit})", [("bits", kb, pb)]))
        kt, pt = cs["total"].clone(), cs["total"].clone()
        K.spread_score_combine(aux, cs["bits"], cs["full"], kt, 2.0)
        K.spread_score_combine_plain(aux, cs["bits"], cs["full"], pt, 2.0)
        torch.cuda.synchronize()
        err["spread_score_combine"] = max(err["spread_score_combine"], require_equal(
            f"spread_score_combine ({what})", [("total", kt, pt)]))
        # K8 reads the engines' int64; the wrapper widens int32 first
        for class_of in (cs["class_of"], cs["class_of"].to(torch.int32)):
            ka = aux._replace(hard_counts=aux.hard_counts.clone(),
                              soft_counts=aux.soft_counts.clone())
            pa = aux._replace(hard_counts=aux.hard_counts.clone(),
                              soft_counts=aux.soft_counts.clone())
            K.spread_update_classes(ka, cs["commit"], cs["choice"], class_of)
            K.spread_update_classes_plain(pa, cs["commit"], cs["choice"], class_of)
            torch.cuda.synchronize()
            err["spread_update_classes"] = max(err["spread_update_classes"], require_equal(
                f"spread_update_classes ({what}, class_of {str(class_of.dtype)[6:]})",
                [("hard_counts", ka.hard_counts, pa.hard_counts),
                 ("soft_counts", ka.soft_counts, pa.soft_counts)]))
    # the adversarial cases hit what they are named for
    c379 = cases[5]
    raw = K.spread_raw_plane(c379["aux"], c379["bits"] == c379["full"])
    # round(379 · log(7)) is 738 with XLA:CPU's log(7), 737 with the
    # correctly rounded one
    if not bool((raw == 738.0).any()) or bool((raw == 737.0).any()):
        fail("spread check: the 379-count case did not score round(379 · log 7) = 738")
    if not bool(torch.isnan(K.spread_raw_plane(cases[2]["aux"])).any()):
        fail("spread check: the keyless case produced no ignored (NaN) node")
    md = cases[11]["aux"]
    if torch.equal(K.spread_filter_plane(md), K.spread_filter_plane(md, False)):
        fail("spread check: minDomains changed no verdict on the hostname bucket")
    for cs in cases[13:]:  # a kernel that stores nothing differs from the plain version
        if torch.equal(K.spread_filter_bits_plain(cs["aux"], cs["bits"].clone(), 3), cs["bits"]):
            fail(f"spread check: the filter cleared no bit in the case {cs['name']}")
    k6_plan_check()
    log(f"spread kernels vs plain: all equal over {len(cases)} cases")
    return err


def k16_plan_check() -> None:
    """K16's plan in csrc/scatter_rows.cu (``scatter_rows_plan``) equal to
    the copy in ``kernel_work.k16_plan`` that the CPU mirror walks."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("scatter_rows").scatter_rows_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    differ = []
    for rb, n, al16, al4 in itertools.product((0, 1, 2, 3, 4, 8, 12, 16, 24, 32, 48, 64, 1024,
                                                4096, 8192, 65536), (1, 37, 8190, 8192, 100000),
                                               (0, 1), (0, 1)):
        fn(rb, n, al16, al4, out)
        want = KW.k16_plan(rb, n, bool(al16), bool(al4))
        if tuple(out) != want:
            differ.append((rb, n, al16, al4, tuple(out), want))
    if differ:
        fail(f"scatter_rows_plan differs from kernel_work.k16_plan: {differ[:4]}")
    else:
        log("scatter_rows: the kernel's plan equals kernel_work.k16_plan")


def k6_plan_check() -> None:
    """K6's plan in csrc/spread.cu (``spread_filter_plan``) equal to the copy
    in ``kernel_work.k6_plan`` that the CPU mirror walks."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("spread").spread_filter_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 4)()
    differ = []
    for n, d1, vec in itertools.product((1, 31, 500, 1001, 1024, 1025, 5000, 8192, 131072),
                                        (9, 33, 65, 8193), (1, 4)):
        fn(n, d1, vec, out)
        if tuple(out) != KW.k6_plan(n, d1, vec):
            differ.append((n, d1, vec, tuple(out), KW.k6_plan(n, d1, vec)))
    if differ:
        fail(f"spread_filter_plan differs from kernel_work.k6_plan: {differ[:4]}")
    else:
        log("spread_filter_bits: the kernel's plan equals kernel_work.k6_plan")


# --- phase 2: K9–K12 vs plain -------------------------------------------------------------

IPA_GROUPS = ("req_affinity", "req_anti_affinity", "pref_affinity", "pref_anti_affinity")
IPA_MUTABLE = ("aff_cnt", "anti_cnt", "paff_cnt", "panti_cnt", "aff_total", "block_dyn",
               "score_dyn")


def strided_view(x):
    """``x``'s values as a view that is not contiguous: its last axis cut
    from a tensor twice as wide."""
    import torch

    return torch.cat([x, x], dim=-1)[..., :x.shape[-1]]


def ipa_case(name: str, gen, dev, *, c=4, t=2, n=8192, p=8192, b=512, d=8, n_dom=3,
             keyless=0.1, present=IPA_GROUPS, trash_group=None, static=None, dyn_zero=False,
             mask_frac=0.9):
    """A synthetic InterPodAffinity class view (the IPAAux fields) plus the
    inputs of K9's passes and one round's commits, on ``dev``: ``n_dom``
    live domains of ``d`` (planes when 4·d ≥ n), ``keyless`` of the nodes
    without the key, ``trash_group`` a present group whose every term is
    keyless, ``static`` a forced score_static plane (the normalize cases)."""
    import torch

    from kubernetes_tpu_torch.kernels import interpodaffinity as K
    from kubernetes_tpu_torch.ops.segment import domain_gather
    from kubernetes_tpu_torch.plugins.interpodaffinity import IPAAux

    def rnd(*shape):
        return torch.rand(shape, generator=gen)

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    planes = 4 * d >= n
    groups = {}
    for g in IPA_GROUPS:
        valid = rnd(c, t) < 0.8
        valid[:, 0] = True
        if g not in present:
            valid[:] = False
        dom = ints(0, max(n_dom, 1), c, t, n)
        dom = torch.where((rnd(c, t, n) >= keyless) & valid[:, :, None], dom, d)
        if g == trash_group:
            dom[:] = d
        tbl = ints(0, 4, c, t, d + 1)
        tbl[..., d] = ints(0, 3, c, t)  # the trash slot holds keyless nodes' pods
        if g == "req_affinity":
            tbl[:2] = 0  # rows 0 and 1: no matching pod anywhere (aff_total 0)
        cnt = domain_gather(tbl, dom).contiguous() if planes else tbl
        if g not in present:
            cnt = torch.zeros_like(cnt)
        groups[g] = dict(valid=valid, dom=dom.to(torch.int32).contiguous(), cnt=cnt,
                         cross=(rnd(c, t, c) < 0.5) & valid[:, :, None],
                         weight=ints(1, 101, c, t).float() * valid)
    aff_total = ints(0, 3, c)
    self_match = rnd(c) < 0.5
    aff_total[0], self_match[0] = 0, True  # the first pod of a series
    aff_total[1], self_match[1] = 0, False
    score_static = ints(-30, 60, c, n).float() if static is None else static
    full = (1 << 16) - 1
    bits = torch.where(rnd(c, n) < mask_frac, full, full & ~(1 << 3)).to(torch.int32)
    if c > 3:
        bits[3] = 0  # an all-masked row
    total = torch.where(bits == full, ints(0, 700, c, n).float(), float("-inf"))
    ga, gn, gp, gq = (groups[g] for g in IPA_GROUPS)
    aux = IPAAux(
        dom_aff=ga["dom"], dom_anti=gn["dom"], dom_paff=gp["dom"], dom_panti=gq["dom"],
        aff_cnt=ga["cnt"], anti_cnt=gn["cnt"], paff_cnt=gp["cnt"], panti_cnt=gq["cnt"],
        aff_total=aff_total, self_match_all=self_match,
        exist_anti_block=rnd(c, n) < 0.05, score_static=score_static,
        aff_term_cross=ga["cross"], aff_cross_all=rnd(c, c) < 0.5,
        anti_cross=gn["cross"], paff_cross=gp["cross"], panti_cross=gq["cross"],
        block_dyn=rnd(c, n) < (0.0 if dyn_zero else 0.05),
        score_dyn=torch.zeros((c, n)) if dyn_zero else ints(-5, 10, c, n).float(),
        depth=d, present=tuple(present), req_aff_valid=ga["valid"],
        paff_weight=gp["weight"], panti_weight=gq["weight"], hard_weight=1.0)
    # K9's inputs: a match plane against P scheduled pods, and G = 8 index
    # groups with a BLOCK, a SCORE_REQ and a negative SCORE group
    g_n, k_cap, dw = 8, 4, max(d, 8)
    node_topo = ints(0, dw + 2, n, k_cap)  # values past the table width read 0
    node_topo[rnd(n, k_cap) < 0.1] = -1
    existing = dict(
        match_g=rnd(g_n, c) < 0.6,
        aff_counts=ints(0, 3, g_n, dw).float(),
        aff_slot=torch.tensor([0, 1, 2, 3, 0, 1, -1, 2], dtype=torch.int32),
        aff_valid=torch.tensor([True] * 7 + [False]),
        aff_kind=torch.tensor([K.KIND_BLOCK, K.KIND_SCORE_REQ, 1, 1, K.KIND_BLOCK,
                               1, 1, 1], dtype=torch.int32),
        aff_weight=torch.tensor([0.0, 1.0, -7.0, 3.0, 0.0, 100.0, 5.0, 2.0]),
        node_topo=node_topo)
    to = lambda x: x.to(dev) if torch.is_tensor(x) else x  # noqa: E731
    return dict(
        name=name, aux=IPAAux(*[to(v) for v in aux]), d=d, planes=planes, full=full,
        bits=to(bits), total=to(total),
        match=to(rnd(c, t, p) < 0.3), pod_node=to(ints(-1, n, p)), pod_valid=to(rnd(p) < 0.9),
        existing={k: to(v) for k, v in existing.items()},
        commit=to(rnd(b) < 0.3), choice=to(ints(0, n, b)), class_of=to(ints(0, c, b).long()))


def check_ipa_kernels(dev) -> dict:
    """K9–K12 against their plain versions, exactly equal, on random and
    adversarial inputs: tables and planes, keyless nodes, an all-trash group,
    aff_total 0 with and without a self-match, an all-masked row, a
    normalization over diff 97 and 100 with the top node at the max,
    negative raw scores, and index groups of every kind."""
    import torch

    from kubernetes_tpu_torch.kernels import interpodaffinity as K
    from kubernetes_tpu_torch.plugins.interpodaffinity import InterPodAffinityPlugin

    plug = InterPodAffinityPlugin()
    gen = torch.Generator().manual_seed(SEED + 9)
    n = 8192

    def normalize_static(diff):
        # raw scores in [0, diff] with both ends present: the top node
        # scores exactly 100 only with the reference's operation order
        s = torch.randint(0, diff + 1, (4, n), generator=gen).float()
        s[:, 0], s[:, 1] = 0.0, float(diff)
        return s

    cases = [
        ipa_case("tables, 3 zones", gen, dev),
        ipa_case("planes, hostname domains", gen, dev, d=8192, n_dom=5000),
        ipa_case("planes, one term, half keyless", gen, dev, t=1, d=4096, n_dom=4000,
                 keyless=0.5),
        ipa_case("all-trash anti group", gen, dev, trash_group="req_anti_affinity"),
        ipa_case("required affinity only", gen, dev, present=("req_affinity",)),
        ipa_case("preferred anti-affinity only (negative scores)", gen, dev,
                 present=("pref_anti_affinity",), static=torch.zeros((4, n))),
        ipa_case("normalize, diff 97", gen, dev, present=("req_anti_affinity",),
                 static=normalize_static(97), dyn_zero=True, mask_frac=1.0),
        ipa_case("normalize, diff 100", gen, dev, present=("req_anti_affinity",),
                 static=normalize_static(100), dyn_zero=True, mask_frac=1.0),
        ipa_case("no feasible node", gen, dev, mask_frac=0.0),
    ]
    err = {k: 0.0 for k in ("ipa_prepare", "ipa_filter_bits", "ipa_score_combine",
                            "ipa_update_classes")}
    for cs in cases:
        aux, what = cs["aux"], cs["name"]
        a9 = (cs["match"], cs["pod_node"], cs["pod_valid"], aux.dom_paff, cs["d"],
              cs["planes"])
        k9, p9 = K.ipa_prepare_counts(*a9), K.ipa_prepare_counts_plain(*a9)
        ex = cs["existing"]
        e9 = (ex["match_g"], ex["aff_counts"], ex["aff_slot"], ex["aff_valid"],
              ex["aff_kind"], ex["aff_weight"], ex["node_topo"], 1.0)
        k9e, p9e = K.ipa_existing_planes(*e9), K.ipa_existing_planes_plain(*e9)
        torch.cuda.synchronize()
        err["ipa_prepare"] = max(err["ipa_prepare"], require_equal(
            f"ipa_prepare ({what})", [("counts", k9[0], p9[0]), ("total", k9[1], p9[1]),
                                      ("exist_anti_block", k9e[0], p9e[0]),
                                      ("score_static", k9e[1], p9e[1])]))
        for bit in (3, 13):
            kb, pb = cs["bits"].clone(), cs["bits"].clone()
            K.ipa_filter_bits(aux, kb, bit)
            K.ipa_filter_bits_plain(aux, pb, bit)
            torch.cuda.synchronize()
            err["ipa_filter_bits"] = max(err["ipa_filter_bits"], require_equal(
                f"ipa_filter_bits ({what}, bit {bit})", [("bits", kb, pb)]))
        kt, pt = cs["total"].clone(), cs["total"].clone()
        K.ipa_score_combine(aux, cs["bits"], cs["full"], kt, 2.0)
        K.ipa_score_combine_plain(aux, cs["bits"], cs["full"], pt, 2.0)
        torch.cuda.synchronize()
        err["ipa_score_combine"] = max(err["ipa_score_combine"], require_equal(
            f"ipa_score_combine ({what})", [("total", kt, pt)]))
        if what.startswith("normalize"):
            # the top node (raw = max) of each unmasked row gains exactly 2 · 100
            if not bool((kt[:3, 1] - cs["total"][:3, 1] == 200.0).all()):
                fail(f"ipa_score_combine ({what}): the top node did not score 100")
        # the engine's working copies, updated in place
        ka, pa = plug.engine_copy(aux), plug.engine_copy(aux)
        K.ipa_update_classes(ka, cs["commit"], cs["choice"], cs["class_of"])
        K.ipa_update_classes_plain(pa, cs["commit"], cs["choice"], cs["class_of"])
        torch.cuda.synchronize()
        err["ipa_update_classes"] = max(err["ipa_update_classes"], require_equal(
            f"ipa_update_classes ({what})",
            [(f, getattr(ka, f), getattr(pa, f)) for f in IPA_MUTABLE]))
    # K11 and K12 at the redesign's shapes (kernel_work.py's inputs: the
    # dedup round, the scan's step, the full auction, zone tables with both
    # preferred groups; one commit, zone tables, the anti-affinity round at
    # C = 512, all four groups) and K12 on a tables-form bucket of 65536
    # domains, beyond what one block could keep as a domain-sized array
    for label in KW.K11_CASES:
        aux, bits, full, total = KW.k11_inputs(label, dev)
        kt, pt = total.clone(), total.clone()
        K.ipa_score_combine(aux, bits, full, kt, 2.0)
        K.ipa_score_combine_plain(aux, bits, full, pt, 2.0)
        torch.cuda.synchronize()
        err["ipa_score_combine"] = max(err["ipa_score_combine"], require_equal(
            f"ipa_score_combine ({label})", [("total", kt, pt)]))
        if torch.equal(kt, total):
            fail(f"ipa_score_combine ({label}): the total did not move")
    cases12 = [(label, KW.k12_inputs(label, dev)) for label in KW.K12_CASES]
    wide = KW.k12_inputs("C = 4, tables", dev, d=65536)
    if wide[0].depth <= K.MAX_SHARED_DOMAINS:
        fail("ipa check: the wide tables case is not past a domain-sized shared array")
    cases12.append(("C = 4, tables, 65536 domains", wide))
    # B = 6000: the commits compacted in two passes (4096 a block)
    aux, commit, choice, class_of = KW.k12_inputs("C = 4, four groups", dev, b=6000)
    commit = torch.rand(6000, generator=gen).to(dev) < 0.5
    cases12.append(("C = 4, four groups, B = 6000, two compaction passes",
                    (aux, commit, choice, class_of)))
    # every group's domains, cross and extras as strided views: the wrapper's
    # contiguous copies must all live until the one launch reads them
    aux, commit, choice, class_of = KW.k12_inputs("C = 4, four groups", dev)
    views = {f: strided_view(getattr(aux, f)) for f in (
        "dom_aff", "dom_anti", "dom_paff", "dom_panti", "aff_term_cross", "anti_cross",
        "paff_cross", "panti_cross", "aff_cross_all", "req_aff_valid", "paff_weight",
        "panti_weight")}
    if any(v.is_contiguous() for v in views.values()):
        fail("ipa check: a strided view of the four-group case is contiguous")
    cases12.append(("C = 4, four groups, strided views",
                    (aux._replace(**views), commit, choice, class_of)))
    for label, (aux, commit, choice, class_of) in cases12:
        ka, pa = plug.engine_copy(aux), plug.engine_copy(aux)
        K.ipa_update_classes(ka, commit, choice, class_of)
        K.ipa_update_classes_plain(pa, commit, choice, class_of)
        torch.cuda.synchronize()
        err["ipa_update_classes"] = max(err["ipa_update_classes"], require_equal(
            f"ipa_update_classes ({label})",
            [(f, getattr(ka, f), getattr(pa, f)) for f in IPA_MUTABLE]))
        if all(torch.equal(getattr(ka, f), getattr(aux, f)) for f in IPA_MUTABLE):
            fail(f"ipa_update_classes ({label}): the round changed nothing")
    # one launch a call: K11 split over a cluster (C = 4) and one block a row
    # (C = 512), K12 with all four groups present
    for label in ("C = 4, planes", "C = 512, anti-affinity classes"):
        aux, bits, full, total = KW.k11_inputs(label, dev)
        one_device_activity(f"ipa_score_combine ({label})",
                            lambda a_=aux, b_=bits, f_=full, t_=total:
                            K.ipa_score_combine(a_, b_, f_, t_, 2.0),
                            "ipa_score_kernel", "ipa_score_combine")
    aux, commit, choice, class_of = KW.k12_inputs("C = 4, four groups", dev)
    work = plug.engine_copy(aux)
    one_device_activity("ipa_update_classes (four groups)",
                        lambda: K.ipa_update_classes(work, commit, choice, class_of),
                        "ipa_update_kernel", "ipa_update_classes")
    # K10 at kernel_work.K10_CASES (C = 1, 4, 512; zone tables with required
    # affinity, hostname planes with required anti-affinity, no required
    # term; N = 8190), bit for bit, and one launch a call
    for label in KW.K10_CASES:
        aux, seeded, bit = KW.k10_inputs(label, dev)
        kb, pb = seeded.clone(), seeded.clone()
        K.ipa_filter_bits(aux, kb, bit)
        K.ipa_filter_bits_plain(aux, pb, bit)
        torch.cuda.synchronize()
        err["ipa_filter_bits"] = max(err["ipa_filter_bits"], require_equal(
            f"ipa_filter_bits ({label})", [("bits", kb, pb)]))
        if torch.equal(kb, seeded) != (KW.K10_CASES[label][2] == ("pref_affinity",)):
            fail(f"ipa_filter_bits ({label}): bits cleared where the case has no required "
                 "term or block, or none where it has")
    for label in ("C = 4, planes, no required term", "C = 4, tables, required affinity",
                  "C = 512, planes, required anti-affinity"):
        aux, seeded, bit = KW.k10_inputs(label, dev)
        one_device_activity(f"ipa_filter_bits ({label})",
                            lambda a_=aux, b_=seeded.clone(): K.ipa_filter_bits(a_, b_, bit),
                            "ipa_filter_kernel", "ipa_filter_bits")
    # the adversarial cases hit what they are named for
    if not bool((K.ipa_raw_plane(cases[5]["aux"]) < 0).any()):
        fail("ipa check: the preferred anti-affinity case produced no negative raw score")
    first = K.ipa_filter_plane(cases[4]["aux"])
    if not bool(first[0].any()) or bool(first[1].any()):
        fail("ipa check: the first-pod escape did not pass row 0 alone")
    log(f"affinity kernels vs plain: all equal over {len(cases)} cases, K11 at "
        f"{len(KW.K11_CASES)} and K12 at {len(cases12)} more shapes")
    return err


# --- phase 2: K13–K16 vs plain ------------------------------------------------------------

PIPE_KERNELS = ("prev_delta_apply", "spread_chain_prev", "ipa_chain_prev", "scatter_rows")


def check_pipeline_kernels(dev) -> dict:
    """K13–K16 against their plain versions, exactly equal: K13 with rows of
    −1, two bundles on one node, a no-op bundle and no bundle; K16 over
    bool / int32 / float32 arrays of word and odd row widths with duplicate
    pad rows, at the node and pod tiers, on 12-byte, bool and 3-byte rows at
    N = 8190 aligned and one element into their storage, with k = 0, and
    its plan against ``kernel_work.k16_plan``; K14 with unplaced and invalid prev
    pods, one and two constraints; K15 in both count forms, with and
    without the prev terms (a carry with and without groups), an all-invalid
    prev term group and every weight sign.  The inputs stay unchanged."""
    import torch

    from kubernetes_tpu_torch.kernels import interpodaffinity as KI
    from kubernetes_tpu_torch.kernels import prev_delta as KD
    from kubernetes_tpu_torch.kernels import scatter as KS
    from kubernetes_tpu_torch.kernels import spread as KSp

    gen = torch.Generator().manual_seed(SEED + 13)
    err = {k: 0.0 for k in PIPE_KERNELS}

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    # K13
    n, r, b0 = 8192, 8, 512
    requested, non_zero = ints(0, 4000, n, r).to(dev), ints(0, 4000, n, 2).to(dev)
    keep = (requested.clone(), non_zero.clone())

    def bundle(kind):
        rows = ints(-1, n, b0)
        rows[:64] = 7  # many pods, and both bundles, on one node
        if kind == "noop":
            rows[:] = -1
        return tuple(t.to(dev) for t in (rows, ints(0, 3000, b0, r), ints(0, 3000, b0, 2)))

    for case in (["real"], ["real", "real"], ["noop", "real"], ["noop"], []):
        bundles = [bundle(k) for k in case]
        kr, kn = KD.prev_delta_apply(requested, non_zero, bundles)
        pr, pn = KD.prev_delta_apply_plain(requested, non_zero, bundles)
        torch.cuda.synchronize()
        err["prev_delta_apply"] = max(err["prev_delta_apply"], require_equal(
            f"prev_delta_apply ({'+'.join(case) or 'none'})",
            [("requested", kr, pr), ("non_zero", kn, pn), ("input requested", requested,
                                                            keep[0]),
             ("input non_zero", non_zero, keep[1])]))

    # K16
    for n_rows, k_real, k in ((8192, 300, 512), (16384, 700, 1024), (8, 3, 8)):
        floats = torch.rand((n_rows, 8), generator=gen)
        floats[floats < 0.3] = float("nan")  # as node_label_num holds
        arrays = [torch.rand(n_rows, generator=gen) < 0.5, ints(-1, 99, n_rows, 16),
                  floats, ints(0, 9, n_rows),
                  torch.rand((n_rows, 4), generator=gen) < 0.5,  # 4 bool bytes a row
                  torch.rand((n_rows, 3), generator=gen) < 0.5]  # 3 bytes: the byte path
        arrays = [a.to(dev) for a in arrays]
        rows = torch.randperm(n_rows, generator=gen)[:k_real].sort().values
        padded = torch.cat([rows, rows[:1].expand(k - k_real)]).to(dev)
        vals = []
        for a in arrays:
            v = torch.empty((k,) + a.shape[1:], dtype=a.dtype)
            v.copy_(torch.rand(v.shape, generator=gen) < 0.5 if a.dtype == torch.bool
                    else torch.randint(-50, 50, v.shape, generator=gen).to(a.dtype))
            v[k_real:] = v[0]  # a duplicate pad row carries its row's value
            vals.append(v.to(dev))
        before = [a.clone() for a in arrays]
        got = KS.scatter_rows(arrays, padded, vals)
        want = KS.scatter_rows_plain(arrays, padded, vals)
        torch.cuda.synchronize()
        err["scatter_rows"] = max(err["scatter_rows"], require_equal(
            f"scatter_rows ({n_rows} rows, {k} payload rows)",
            [(f"array {i}", g, w) for i, (g, w) in enumerate(zip(got, want))]
            + [(f"input {i}", a, b) for i, (a, b) in enumerate(zip(arrays, before))]))
    # K16 on 12-byte rows (4-byte words), a bool row and N = 8190 (no whole
    # number of tiles), unaligned (views one element into their storage:
    # 4-byte words, or bytes for the bool rows), and with k = 0
    n_rows, k_real, k = 8190, 300, 512
    rows = torch.randperm(n_rows, generator=gen)[:k_real].sort().values
    padded = torch.cat([rows, rows[:1].expand(k - k_real)]).to(dev)
    for what, shift in (("aligned", 0), ("unaligned", 1)):
        arrays, vals = [], []
        for shape, make in (((n_rows, 3), lambda *sh: ints(-50, 50, *sh)),
                            ((n_rows,), lambda *sh: torch.rand(sh, generator=gen) < 0.5),
                            ((n_rows, 3), lambda *sh: torch.rand(sh, generator=gen) < 0.5),
                            ((n_rows, 2), lambda *sh: ints(-50, 50, *sh))):
            for rows_of, out in ((n_rows, arrays), (k, vals)):
                x = make(rows_of * (shape[1] if len(shape) > 1 else 1) + shift).to(dev)
                out.append(x[shift:].reshape((rows_of,) + shape[1:]))
        for v in vals:
            v[k_real:] = v[0]
        for kk in (k, 0):
            rows_k, vals_k = padded[:kk], [v[:kk] for v in vals]
            got = KS.scatter_rows(arrays, rows_k, vals_k)
            want = KS.scatter_rows_plain(arrays, rows_k, vals_k)
            torch.cuda.synchronize()
            err["scatter_rows"] = max(err["scatter_rows"], require_equal(
                f"scatter_rows (12-byte, bool and 3-byte rows, N = {n_rows}, {what}, k = {kk})",
                [(f"array {i}", g, w) for i, (g, w) in enumerate(zip(got, want))]))
            if kk == 0 and not all(torch.equal(g, a) for g, a in zip(got, arrays)):
                fail(f"scatter_rows ({what}, k = 0): an array changed")
    k16_plan_check()

    # K14
    for cc in (1, 2):
        cs = spread_case(f"chain, {cc} constraints", gen, dev, cc=cc, keyless=0.2)
        aux = cs["aux"]
        c = aux.hard_counts.shape[0]
        rows = ints(-1, n, b0)
        rows[:32] = 5
        valid = torch.rand(b0, generator=gen) < 0.9
        match = torch.rand((c, cc, b0), generator=gen) < 0.5
        a14 = (aux, match.to(dev), rows.to(dev), valid.to(dev))
        kh, ks = KSp.spread_chain_prev(*a14)
        ph, ps = KSp.spread_chain_prev_plain(*a14)
        torch.cuda.synchronize()
        err["spread_chain_prev"] = max(err["spread_chain_prev"], require_equal(
            f"spread_chain_prev ({cc} constraints)",
            [("hard_counts", kh, ph), ("soft_counts", ks, ps)]))
        if torch.equal(kh, aux.hard_counts):
            fail("spread_chain_prev check: the carry counted nothing")

    # K15
    cases = [("tables", {}), ("planes", dict(d=8192, n_dom=5000)),
             ("planes, one term, half keyless", dict(t=1, d=4096, n_dom=4000, keyless=0.5))]
    for what, kw in cases:
        cs = ipa_case(f"chain, {what}", gen, dev, **kw)
        aux = cs["aux"]
        c, t = aux.aff_cnt.shape[0], aux.aff_cnt.shape[1]
        k_cap = 4
        node_topo = ints(0, 6, n, k_cap)
        node_topo[torch.rand((n, k_cap), generator=gen) < 0.1] = -1
        node_topo[:, 3] = torch.arange(n, dtype=torch.int32)  # a hostname-like slot
        rows = ints(-1, n, b0)
        rows[:16] = 9
        counts = {g: (torch.rand((c, t, b0), generator=gen) < 0.3).to(dev)
                  for g in aux.present}
        own = []
        for gi, (block, w_scalar, sign) in enumerate(
                ((True, 0.0, 1.0), (False, 1.0, 1.0), (False, 0.0, 1.0), (False, 0.0, -1.0))):
            t0 = 2
            term_valid = torch.rand((b0, t0), generator=gen) < (0.0 if gi == 2 else 0.7)
            weight = None if w_scalar else torch.randint(1, 101, (b0, t0), generator=gen).float()
            own.append(KI.OwnTerms(
                block, (torch.rand((b0, t0, c), generator=gen) < 0.4).to(dev),
                ints(0, k_cap, b0, t0).to(dev), term_valid.to(dev),
                None if weight is None else weight.to(dev), w_scalar, sign))
        for with_groups in (True, False):
            o = own if with_groups else []
            a15 = (aux, counts, o, rows.to(dev), node_topo.to(dev), -1)
            got = KI.ipa_chain_prev(*a15)
            want = KI.ipa_chain_prev_plain(*a15)
            torch.cuda.synchronize()
            if set(got) != set(want):
                fail(f"ipa_chain_prev ({what}): fields {sorted(got)} vs {sorted(want)}")
            err["ipa_chain_prev"] = max(err["ipa_chain_prev"], require_equal(
                f"ipa_chain_prev ({what}, {'with' if with_groups else 'without'} prev terms)",
                [(f, got[f], want[f]) for f in sorted(got)]))
            if with_groups and not bool((got["block_dyn"] & ~aux.block_dyn).any()):
                fail("ipa_chain_prev check: the prev anti terms blocked nothing new")
    log(f"pipeline kernels vs plain: all equal ({', '.join(PIPE_KERNELS)})")
    return err


# --- phase 2: K17–K19 vs plain, and the reused kernels at C = 512 and at one row ----

SCAN_KERNELS = ("scan_select_assume", "spread_update_row", "ipa_update_row")

# K17's rows beyond the path's N = 8192: one block (1, 31), a cluster whose
# slices end off the vector grid (5000, 8191), the path's own
K17_SIZES = (1, 31, 5000, 8191, 8192)
K17_SPLIT_KINDS = ("ties across slices", "plus and minus zero", "all infeasible",
                   "nominated feasible", "nominated infeasible", "padding pod")


def k17_plan_check() -> None:
    """K17's plan in csrc/scan.cu (``scan_select_plan``) equal to the copy in
    ``kernel_work.k17_plan`` that the tie cases here, in ``kernel_ab.py``
    and in the CPU mirror take their slice boundaries from."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("scan").scan_select_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    differ = []
    for n in (1, 4, 31, 500, 512, 1024, 1025, 2048, 4096, 4097, 5000, 8191, 8192, 100000):
        for vec in (1, 4):
            fn(n, vec, out)
            if tuple(out) != KW.k17_plan(n, vec):
                differ.append((n, vec, tuple(out), KW.k17_plan(n, vec)))
    if differ:
        fail(f"scan_select_plan differs from kernel_work.k17_plan: {differ}")
    else:
        log("scan_select_assume: the kernel's plan equals kernel_work.k17_plan")


def k17_split_cases(dev, gen, keyed: bool) -> float:
    """K17 (keyless, or keyed under the step keys of PRNGKey(7)) against its
    plain version on the same CUDA tensors at ``K17_SIZES``: the maximum
    tied on the rows either side of every slice boundary and vector tail
    (keyless the lowest must win, keyed the largest draw among them), a row
    of +0.0 and −0.0 totals (a tie, as == says), an all-infeasible row, a
    feasible and an infeasible nominated row, a padding pod; keyed also the
    maximum on two rows in different slices whose draws are equal under the
    step's key (``kernel_work.k17_equal_noise``: the lower must win) at N =
    5000, 8191 and 8192; at N = 31 and 8191 also as row 1 of a [2, N]
    buffer (a view 4 N bytes in: not 16-byte aligned, the scalar form).  →
    the largest difference (0: exactly equal)."""
    import torch

    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import tie_noise as KT
    from kubernetes_tpu_torch.ops import prng

    b, r, full, i = 64, 8, (1 << 16) - 1, 5
    request = torch.randint(0, 3000, (b, r), generator=gen, dtype=torch.int32).to(dev)
    pod_nz = torch.randint(0, 3000, (b, 2), generator=gen, dtype=torch.int32).to(dev)
    keys = KT.tie_split(RNG_KEY, b, dev) if keyed else None
    what = "scan_select_assume" + (" keyed" if keyed else "")
    err = 0.0
    cases = [(n, kind, False) for n in K17_SIZES for kind in K17_SPLIT_KINDS]
    cases += [(n, "ties across slices", True) for n in (31, 8191)]
    if keyed:
        cases += [(n, "equal noise across slices", False) for n in (5000, 8191, 8192)]
    for c_, (n, kind, view) in enumerate(cases):
        bits = torch.where(torch.rand(n, generator=gen) < 0.7, full, full & ~4).to(torch.int32)
        total = torch.randint(0, 400, (n,), generator=gen).float()
        nom, valid = -1, torch.ones(b, dtype=torch.bool)
        k = c_ % b
        tied = KW.k17_tie_rows(n)
        if kind == "ties across slices":
            bits[tied], total[tied] = full, 999.0
        elif kind == "equal noise across slices":
            k, lo, hi = KW.k17_equal_noise(keys, n)
            tied = [lo, hi]
            bits[tied], total[tied] = full, 999.0
        elif kind == "plus and minus zero":
            total = torch.where(torch.arange(n) % 2 == 0, -0.0, 0.0)
            bits[0] = full
        elif kind == "all infeasible":
            bits[:] = full & ~1
        elif kind == "nominated feasible":
            nom = n // 2
            bits[nom] = full
        elif kind == "nominated infeasible":
            nom = n // 2
            bits[nom] = 0
        elif kind == "padding pod":
            valid[i] = False
        total = torch.where(bits == full, total, float("-inf"))
        rows = [x.to(dev) for x in (bits, total)]
        if view:  # row 1 of a [2, N] buffer: 4 N bytes in, not 16-byte aligned
            rows = [torch.stack([torch.zeros_like(x), x])[1] for x in rows]
        bits_d, total_d = rows
        if view and (bits_d.data_ptr() % 16 == 0 or not bits_d.is_contiguous()):
            fail(f"{what}: the N = {n} view case is aligned or not contiguous")
        nominated = torch.full((b,), -1, dtype=torch.int32)
        nominated[i] = nom
        outs_k = [torch.randint(0, 4000, (n, r), generator=gen, dtype=torch.int32).to(dev),
                  torch.randint(0, 4000, (n, 2), generator=gen, dtype=torch.int32).to(dev),
                  torch.full((b,), -7, dtype=torch.int32, device=dev),
                  torch.full((b,), -7, dtype=torch.int32, device=dev)]
        outs_p = [t.clone() for t in outs_k]
        args = (bits_d[None], full, total_d[None], i, nominated.to(dev), valid.to(dev),
                request, pod_nz)
        tail = (keys, k) if keyed else ()
        KS.scan_select_assume(*args, *outs_k, *tail)
        KS.scan_select_assume_plain(*args, *outs_p, *tail)
        torch.cuda.synchronize()
        label = f"{what} (N = {n}, {kind}{', unaligned view' if view else ''})"
        err = max(err, require_equal(label, [
            (f, a, c) for f, a, c in zip(("requested", "non_zero", "node_row",
                                           "feasible_count"), outs_k, outs_p)]))
        row = int(outs_k[2][i])
        want = tied[0]
        if keyed and kind == "ties across slices":
            z = prng.uniform(keys[k].cpu().to(torch.int64) & prng.MASK32, (n,))
            want = tied[int(torch.argmax(z[tied]))]  # the first of equal draws
        if kind in ("ties across slices", "equal noise across slices") and row != want:
            fail(f"{label}: went to {row}, not the tied row {want}")
        if kind == "plus and minus zero" and not keyed and row != 0:
            fail(f"{label}: went to {row}, not the first of the tied zeros")
        if kind in ("all infeasible", "padding pod") and row != -1:
            fail(f"{label}: placed a pod it must not")
        if kind == "nominated feasible" and row != n // 2:
            fail(f"{label}: the feasible nominated row was not taken")
    log(f"  {what}: equal to the plain version on {len(cases)} cases at N = "
        f"{', '.join(map(str, K17_SIZES))} (slice boundaries, vector tails, ±0, unaligned "
        "views" + (", equal draws across slices under a real key" if keyed else "") + ")")
    return err


def full_rows_spread_case(name, gen, dev, *, b=512, cc=2, n=8192, **kw):
    """A spread_case at full-batch rows: every pod its own class row, the
    pending axis of match_pending the batch (B × Cc × B), identity classes."""
    import torch

    cs = spread_case(name, gen, dev, c=b, cc=cc, n=n, b=b, **kw)
    match = (torch.rand((b, cc, b), generator=gen) < 0.5).to(dev)
    cs["aux"] = cs["aux"]._replace(match_pending=match)
    cs["class_of"] = torch.arange(b, device=dev)
    return cs


def check_scan_kernels(dev) -> dict:
    """K17–K19 against their plain versions, exactly equal, on random and
    adversarial inputs — K17: ties across the whole row, an all-infeasible
    row, a nominated row that is infeasible, feasible, out of the bucket or
    at the last node, a padding pod, the maximum at the last node, and
    ``k17_split_cases`` (other N, ties across the cluster's slices, the
    kernel's plan held against ``kernel_work.k17_plan``); K18 and
    K19 (both count forms) at full-batch rows B = 512 with pod i on a live
    node, a keyless node, the last node and no node.  Then the reused
    kernels at the shapes the full auction and the scan give them: K1–K4,
    K6–K8 and K10–K12 at C = B = 512 rows (identity classes), and K1, K2,
    K6, K7, K10 and K11 on one row."""
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.kernels import interpodaffinity as KI
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import spread as KSp
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
    from kubernetes_tpu_torch.plugins.interpodaffinity import InterPodAffinityPlugin
    from kubernetes_tpu_torch.plugins.podtopologyspread import PodTopologySpreadPlugin
    from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id

    gen = torch.Generator().manual_seed(SEED + 17)
    err = {k: 0.0 for k in SCAN_KERNELS}
    reuse = {k: 0.0 for k in ("filter_score_planes", "normalize_combine", "topk_rows",
                              "auction_resolve_commit", "spread_filter_bits",
                              "spread_score_combine", "spread_update_classes",
                              "ipa_filter_bits", "ipa_score_combine",
                              "ipa_update_classes")}
    n, b, r = 8192, 512, 8
    full = (1 << 16) - 1

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    # K17
    valid = torch.ones(b, dtype=torch.bool)
    valid[b - 1] = False  # a padding pod
    nominated = ints(-1, 0, b)
    request, pod_nz = ints(0, 3000, b, r), ints(0, 3000, b, 2)
    requested, node_nz = ints(0, 4000, n, r), ints(0, 4000, n, 2)
    batch_args = [t.to(dev) for t in (nominated, valid, request, pod_nz)]

    def row_case(kind):
        bits = torch.where(torch.rand(n, generator=gen) < 0.7, full,
                           full & ~(1 << 5)).to(torch.int32)
        total = torch.randint(0, 400, (n,), generator=gen).float()
        nom = -1
        if kind == "ties":
            total[:] = 250.0
        elif kind == "infeasible":
            bits[:] = full & ~1
        elif kind == "max at the last node":
            bits[n - 1] = full
            total[n - 1] = 1000.0
        elif kind == "nominated infeasible":
            bits[77] = 0
            nom = 77
        elif kind == "nominated feasible":
            bits[4000] = full
            nom = 4000
        elif kind == "nominated past the bucket":
            nom = n + 5
        elif kind == "nominated last node":
            bits[n - 1] = full
            nom = n - 1
        total = torch.where(bits == full, total, float("-inf"))
        return bits[None].to(dev), total[None].to(dev), nom

    kinds = ("random", "ties", "infeasible", "max at the last node", "nominated infeasible",
             "nominated feasible", "nominated past the bucket", "nominated last node")
    for k, kind in enumerate(kinds):
        bits, total, nom = row_case(kind)
        for i in (k, b - 1):  # a real pod, then the padding pod
            nomd = batch_args[0].clone()
            nomd[i] = nom
            outs_k = [requested.to(dev), node_nz.to(dev),
                      torch.full((b,), -7, dtype=torch.int32, device=dev),
                      torch.full((b,), -7, dtype=torch.int32, device=dev)]
            outs_p = [t.clone() for t in outs_k]
            args = (bits, full, total, i, nomd, *batch_args[1:])
            KS.scan_select_assume(*args, *outs_k)
            KS.scan_select_assume_plain(*args, *outs_p)
            torch.cuda.synchronize()
            err["scan_select_assume"] = max(err["scan_select_assume"], require_equal(
                f"scan_select_assume ({kind}, pod {i})",
                [(f, a, c) for f, a, c in zip(("requested", "non_zero", "node_row",
                                               "feasible_count"), outs_k, outs_p)]))
            row = int(outs_k[2][i])
            if kind == "ties" and i != b - 1 and row != int((bits[0] == full).nonzero()[0]):
                fail("scan_select_assume: a tie did not go to the lowest feasible row")
            if kind in ("infeasible",) or i == b - 1:
                if row != -1:
                    fail(f"scan_select_assume ({kind}, pod {i}): placed a pod it must not")
            if kind == "nominated feasible" and i != b - 1 and row != 4000:
                fail("scan_select_assume: the feasible nominated row was not taken")

    k17_plan_check()
    err["scan_select_assume"] = max(err["scan_select_assume"],
                                    k17_split_cases(dev, gen, keyed=False))

    # K18: full-batch rows, two constraints, keyless nodes
    splug = PodTopologySpreadPlugin()
    for cs in (full_rows_spread_case("K18, 3 domains", gen, dev),
               full_rows_spread_case("K18, keyless nodes", gen, dev, keyless=0.3)):
        aux = cs["aux"]
        keyless = (~aux.has_key[0, 0]).nonzero()
        nodes = [int(torch.randint(0, n, (1,), generator=gen)), n - 1, -1]
        if keyless.numel():
            nodes.append(int(keyless[0, 0]))
        for i in (0, 301, b - 1):
            for node in nodes:
                ka, pa = splug.engine_copy(aux), splug.engine_copy(aux)
                at = torch.tensor([node], dtype=torch.int32, device=dev)
                KSp.spread_update_row(ka, i, at)
                KSp.spread_update_row_plain(pa, i, at)
                torch.cuda.synchronize()
                err["spread_update_row"] = max(err["spread_update_row"], require_equal(
                    f"spread_update_row ({cs['name']}, pod {i}, node {node})",
                    [("hard_counts", ka.hard_counts, pa.hard_counts),
                     ("soft_counts", ka.soft_counts, pa.soft_counts)]))

    # K19: full-batch rows, tables and planes, every group present
    iplug = InterPodAffinityPlugin()
    ipa_full = []
    for what, kw in (("tables", {}), ("planes, hostname domains", dict(d=8192, n_dom=5000)),
                     ("anti-affinity only, planes", dict(d=8192, n_dom=5000, t=1,
                                                          present=("req_anti_affinity",))),
                     ("tables, N = 1001 (scalar loads)", dict(n=1001))):
        cs = ipa_case(f"K19, {what}", gen, dev, c=b, **kw)
        if "n" not in kw:
            ipa_full.append(cs)
        aux = cs["aux"]
        nc = aux.exist_anti_block.shape[1]
        keyless = (aux.dom_anti[0, 0] >= cs["d"]).nonzero()
        nodes = [int(torch.randint(0, nc, (1,), generator=gen)), nc - 1, -1]
        if keyless.numel():
            nodes.append(int(keyless[0, 0]))
        for i in (0, 1, 300):
            for node in nodes:
                ka, pa = iplug.engine_copy(aux), iplug.engine_copy(aux)
                at = torch.tensor([node], dtype=torch.int32, device=dev)
                KI.ipa_update_row(ka, i, at)
                KI.ipa_update_row_plain(pa, i, at)
                torch.cuda.synchronize()
                err["ipa_update_row"] = max(err["ipa_update_row"], require_equal(
                    f"ipa_update_row ({what}, pod {i}, node {node})",
                    [(f, getattr(ka, f), getattr(pa, f)) for f in IPA_MUTABLE]))
        if not bool((ka.block_dyn != aux.block_dyn).any() or
                    (ka.score_dyn != aux.score_dyn).any()):
            log(f"  ipa_update_row ({what}): the last step changed no plane")

    # the reused kernels at C = 512 (identity classes) and on one row
    fw, (fs_plan, comb_plan) = framework_plans()
    fullf = (1 << len(fw.filter_names)) - 1
    snap = synthetic_snapshot(n, gen, dev)
    dyn = DynamicState(requested=snap.requested, non_zero=snap.non_zero_requested)
    rep, na_mask, na_pref = synthetic_classes(b, n, gen, dev)
    img = image_scaled_by_id(snap)
    one = SimpleNamespace(**{k: v[7:8] for k, v in vars(rep).items()})
    for label, rows, m, pr in (("C = 512", rep, na_mask, na_pref),
                               ("one row", one, na_mask[7:8], na_pref[7:8])):
        kb, kr = filter_score_planes(rows, snap, dyn, m, pr, img, fs_plan)
        pb, pr_ = filter_score_planes_plain(rows, snap, dyn, m, pr, img, fs_plan)
        kt, kf = normalize_combine(kb, fullf, kr, comb_plan)
        pt, pf = normalize_combine_plain(kb, fullf, kr, comb_plan)
        torch.cuda.synchronize()
        reuse["filter_score_planes"] = max(reuse["filter_score_planes"], require_equal(
            f"filter_score_planes ({label})", [("bits", kb, pb), ("raw", kr, pr_)]))
        reuse["normalize_combine"] = max(reuse["normalize_combine"], require_equal(
            f"normalize_combine ({label})", [("total", kt, pt), ("feasible", kf, pf)]))
        if label == "C = 512":
            cv, ci = topk_rows(kt, b)
            pv, pi = topk_rows_plain(kt, b)
            ident = torch.arange(b, device=dev)
            unres = (torch.rand(b, generator=gen) < 0.9).to(dev)
            nom = torch.randint(0, n, (b,), generator=gen).to(dev)
            nom_ok = (torch.rand(b, generator=gen) < 0.05).to(dev)
            a4 = (cv, ci, ident, ident, unres, nom, nom_ok, rep.request, rep.non_zero)
            kreq, knz = dyn.requested.clone(), dyn.non_zero.clone()
            preq, pnz = kreq.clone(), knz.clone()
            kc, kch = auction_resolve_commit(*a4, kreq, knz)
            pc, pch = auction_resolve_commit_plain(*a4, preq, pnz)
            torch.cuda.synchronize()
            reuse["topk_rows"] = max(reuse["topk_rows"], require_equal(
                "topk_rows (C = 512)", [("values", cv, pv), ("columns", ci, pi)]))
            reuse["auction_resolve_commit"] = max(
                reuse["auction_resolve_commit"], require_equal(
                    "auction_resolve_commit (C = 512, identity classes)",
                    [("commit", kc, pc), ("choice", kch, pch), ("requested", kreq, preq),
                     ("non_zero", knz, pnz)]))
    for scs in (full_rows_spread_case("K6–K8, C = 512", gen, dev, keyless=0.1),):
        for label, aux, bits, total in (
                ("C = 512", scs["aux"], scs["bits"], scs["total"]),
                ("one row", splug.row(scs["aux"], 5), scs["bits"][5:6], scs["total"][5:6])):
            kb, pb = bits.clone(), bits.clone()
            KSp.spread_filter_bits(aux, kb, 3)
            KSp.spread_filter_bits_plain(aux, pb, 3)
            kt, pt = total.clone(), total.clone()
            KSp.spread_score_combine(aux, bits, scs["full"], kt, 2.0)
            KSp.spread_score_combine_plain(aux, bits, scs["full"], pt, 2.0)
            torch.cuda.synchronize()
            reuse["spread_filter_bits"] = max(reuse["spread_filter_bits"], require_equal(
                f"spread_filter_bits ({label})", [("bits", kb, pb)]))
            reuse["spread_score_combine"] = max(reuse["spread_score_combine"], require_equal(
                f"spread_score_combine ({label})", [("total", kt, pt)]))
        ka, pa = splug.engine_copy(scs["aux"]), splug.engine_copy(scs["aux"])
        KSp.spread_update_classes(ka, scs["commit"], scs["choice"], scs["class_of"])
        KSp.spread_update_classes_plain(pa, scs["commit"], scs["choice"], scs["class_of"])
        torch.cuda.synchronize()
        reuse["spread_update_classes"] = max(reuse["spread_update_classes"], require_equal(
            "spread_update_classes (C = 512, identity classes)",
            [("hard_counts", ka.hard_counts, pa.hard_counts),
             ("soft_counts", ka.soft_counts, pa.soft_counts)]))
    # K6 at C = 512 on a hostname bucket: a row's table split across a cluster
    hcs = full_rows_spread_case("K6, C = 512, hostname bucket", gen, dev, d=8192, n_dom=5000,
                                keyless=0.1)
    kb, pb = hcs["bits"].clone(), hcs["bits"].clone()
    KSp.spread_filter_bits(hcs["aux"], kb, 3)
    KSp.spread_filter_bits_plain(hcs["aux"], pb, 3)
    torch.cuda.synchronize()
    reuse["spread_filter_bits"] = max(reuse["spread_filter_bits"], require_equal(
        "spread_filter_bits (C = 512, hostname bucket)", [("bits", kb, pb)]))
    # K8 at C = 512 on the hostname table (D + 1 = 8193): identity classes
    ka, pa = splug.engine_copy(hcs["aux"]), splug.engine_copy(hcs["aux"])
    KSp.spread_update_classes(ka, hcs["commit"], hcs["choice"], hcs["class_of"])
    KSp.spread_update_classes_plain(pa, hcs["commit"], hcs["choice"], hcs["class_of"])
    torch.cuda.synchronize()
    reuse["spread_update_classes"] = max(reuse["spread_update_classes"], require_equal(
        "spread_update_classes (C = 512, hostname bucket)",
        [("hard_counts", ka.hard_counts, pa.hard_counts),
         ("soft_counts", ka.soft_counts, pa.soft_counts)]))
    del hcs, ka, pa
    for cs in ipa_full[:2]:
        ident = torch.arange(b, device=dev)
        for label, aux, bits, total in (
                ("C = 512", cs["aux"], cs["bits"], cs["total"]),
                ("one row", iplug.row(cs["aux"], 9), cs["bits"][9:10], cs["total"][9:10])):
            kb, pb = bits.clone(), bits.clone()
            KI.ipa_filter_bits(aux, kb, 3)
            KI.ipa_filter_bits_plain(aux, pb, 3)
            kt, pt = total.clone(), total.clone()
            KI.ipa_score_combine(aux, bits, cs["full"], kt, 2.0)
            KI.ipa_score_combine_plain(aux, bits, cs["full"], pt, 2.0)
            torch.cuda.synchronize()
            reuse["ipa_filter_bits"] = max(reuse["ipa_filter_bits"], require_equal(
                f"ipa_filter_bits ({cs['name']}, {label})", [("bits", kb, pb)]))
            reuse["ipa_score_combine"] = max(reuse["ipa_score_combine"], require_equal(
                f"ipa_score_combine ({cs['name']}, {label})", [("total", kt, pt)]))
        ka, pa = iplug.engine_copy(cs["aux"]), iplug.engine_copy(cs["aux"])
        KI.ipa_update_classes(ka, cs["commit"], cs["choice"], ident)
        KI.ipa_update_classes_plain(pa, cs["commit"], cs["choice"], ident)
        torch.cuda.synchronize()
        reuse["ipa_update_classes"] = max(reuse["ipa_update_classes"], require_equal(
            f"ipa_update_classes ({cs['name']}, C = 512, identity classes)",
            [(f, getattr(ka, f), getattr(pa, f)) for f in IPA_MUTABLE]))
    log(f"scan kernels vs plain: all equal ({', '.join(SCAN_KERNELS)}); the reused kernels "
        f"equal at C = 512 and on one row ({', '.join(reuse)})")
    return err, reuse


# --- phase 3b: NorthStar through the port's perf harness -----------------------------------


RT = "kubernetes_tpu_torch.framework.runtime"
SPREAD_PLUGIN = "kubernetes_tpu_torch.plugins.podtopologyspread"
IPA_PLUGIN = "kubernetes_tpu_torch.plugins.interpodaffinity"


class KernelArgs:
    """Kernel wrappers, wrapped where the path looks them up: keeps the
    arguments of the latest call of each (under ``key(name, args)``, by
    default its name) where its ``keep(args)`` holds, for timing at the
    path's shapes.  Of the names in ``seeded`` (kernels that update their
    second argument in place) it keeps that argument as a copy taken before
    the call: the plane as the path handed it over.  ``install()`` wraps
    them for the rest of the run; as a context manager it wraps them for
    the ``with`` block."""

    def __init__(self, targets, key=None, seeded=()):
        # name → (module, attribute, keep or None)
        self.targets = targets
        self.key = key or (lambda name, args: name)
        self.seeded = frozenset(seeded)
        self.last = {}
        self._saved = []

    def install(self):
        import importlib

        for name, (mod_name, attr, keep) in self.targets.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn, keep))
        return self

    __enter__ = install

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        self._saved = []

    def _wrap(self, name, fn, keep):
        def wrapped(*args, **kw):
            if keep is None or keep(args):
                kept = (args[0], args[1].clone(), *args[2:]) if name in self.seeded else args
                self.last[self.key(name, args)] = (kept, kw)
            return fn(*args, **kw)

        return wrapped


# the pipeline kernels' wrappers (K13–K16)
PIPELINE_TARGETS = {
    "prev_delta_apply": (RT, "prev_delta_apply", None),
    "scatter_rows": ("kubernetes_tpu_torch.state.encoding", "scatter_rows", None),
    "spread_chain_prev": (SPREAD_PLUGIN, "spread_chain_prev", None),
    "ipa_chain_prev": (IPA_PLUGIN, "ipa_chain_prev", None),
}


def pipeline_key(name, args):
    """K16's latest call of each array group (by group size); the other
    pipeline kernels' latest call."""
    return (name, len(args[0])) if name == "scatter_rows" else (name, 0)


def harness_summary(items) -> dict:
    """The numbers of one NorthStar harness run that the record keeps."""
    by = {it.labels["Metric"]: it.data for it in items}
    att = by["scheduler_scheduling_attempt_duration_seconds"]
    return {"pods_per_s": by["SchedulingThroughput"]["Average"],
            "attempt_p50_ms": att["Perc50"] * 1e3, "attempt_p99_ms": att["Perc99"] * 1e3,
            "window_phase_wall_s": by["PhaseWallBreakdown"],
            "window_pipeline": by["PipelineInWindow"],
            "window_launches": by["KernelLaunchesInWindow"],
            "window_kernel_builds": by["KernelBuildsInWindow"]["Count"]}


def northstar_harness(counters: KernelArgs, out_dir: Path) -> dict:
    """NorthStar/5000Nodes/10000Pods through the port's perf harness at full
    width (B = 512, pipeline depth 3, the 200 ms micro-bucket target, every
    tier warmed): every measured pod bound, no node oversubscribed, K1–K4,
    K13 and K16 launched in the run and inside the measured window, the
    window's dispatches chaining on real carries, no kernel built in the
    window.  Then (before the harness closes the scheduler) one profiled
    steady pipelined cycle."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    w = build_workload("NorthStar", "5000Nodes/10000Pods")
    seen = {}

    def inspect(store, sched, _ctrl):
        torch.cuda.synchronize()
        seen["launches"] = dict(kernels.LAUNCHES)
        seen["sched"] = sched
        pods = check_bound_and_fit("NorthStar harness", store)
        seen["pods"] = len(pods)
        seen["carried_pods"] = sched.carried_pods
        seen["tiers"] = {int(k): v for k, v in sched._tier_p99.items()}
        seen["phase_wall_s"] = dict(sched.phase_wall)
        seen["profile"] = profile_pipelined_cycle(sched, out_dir)

    fresh_heap()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    with GcWatch() as gcw:
        items = run_workload(w, device="cuda", inspect=inspect)
    wall = time.perf_counter() - t
    launches = seen["launches"]
    summ = harness_summary(items)
    win, pipe = summ["window_launches"], summ["window_pipeline"]
    if seen["pods"] != 2000 + 10000:
        fail(f"NorthStar harness: {seen['pods']} pods in the store, expected 12000")
    for k in ("prev_delta_apply", "scatter_rows") + PATH_KERNELS[:4]:
        if launches[k] <= 0:
            fail(f"NorthStar harness: kernel {k} never launched on the main path")
        if win[k] <= 0:
            fail(f"NorthStar harness: kernel {k} never launched in the measured window")
    if pipe["ChainedDispatches"] <= 0 or pipe["CarriedPods"] <= 0:
        fail(f"NorthStar harness: no dispatch of the measured window chained on a placed "
             f"pod ({pipe})")
    if summ["window_kernel_builds"] != 0:
        fail(f"NorthStar harness: {summ['window_kernel_builds']} kernel builds in the window")
    rec = {"items": json.loads(data_items_to_json(items)), "wall_s": wall, **summ,
           "launches": launches, "carried_pods": seen["carried_pods"],
           "tier_p99_s": seen["tiers"], "gc_full_collections": gcw.count,
           "gc_full_s": gcw.seconds, "profile": seen["profile"]}
    log(f"NorthStar/5000Nodes/10000Pods via perf.harness.run_workload (pipelined, depth 3, "
        f"200 ms target, overlap_sync {seen['sched'].overlap_sync}): "
        f"{rec['pods_per_s']:.1f} pods/s, attempt p50 {rec['attempt_p50_ms']:.1f} ms, p99 "
        f"{rec['attempt_p99_ms']:.1f} ms; window phase wall (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in summ["window_phase_wall_s"].items())
        + f"; window pipeline {pipe}; tiers {seen['tiers']}; kernel builds in window "
        f"{summ['window_kernel_builds']:.0f}; whole run {wall:.1f} s; window launches "
        f"{win}; run launches {launches}")
    return {"record": rec, "sched": seen["sched"]}


def overlap_sync_compare(default_on: bool) -> dict:
    """The NorthStar harness cell again with the overlapped sync switched
    the other way, then as the main run had it (the main run being the
    first of an A-B-A triple in one process): pods/s, attempt quantiles,
    the window's walls and what became of the background payloads."""
    import torch

    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    out = {"main_run_overlap_sync": default_on, "runs": []}
    for on in (not default_on, default_on):
        fresh_heap()
        torch.cuda.synchronize()
        t = time.perf_counter()
        items = run_workload(build_workload("NorthStar", "5000Nodes/10000Pods"),
                             device="cuda", overlap_sync=on)
        summ = harness_summary(items)
        summ["wall_s"] = time.perf_counter() - t
        summ["overlap_sync"] = on
        out["runs"].append(summ)
        log(f"NorthStar harness, overlap_sync {on}: {summ['pods_per_s']:.1f} pods/s, attempt "
            f"p50 {summ['attempt_p50_ms']:.1f} ms, p99 {summ['attempt_p99_ms']:.1f} ms; "
            f"window pipeline {summ['window_pipeline']}; snapshot "
            f"{summ['window_phase_wall_s']['snapshot']:.3f} s, sync_overlap "
            f"{summ['window_phase_wall_s']['sync_overlap']:.3f} s")
    return out


def profile_pipelined_cycle(sched, out_dir: Path) -> dict:
    """One steady pipelined NorthStar-shaped cycle under torch.profiler: 1536
    pod_default pods queued, two cycles to fill the pipeline, then the
    profiled one (it completes the oldest batch, dispatches a chained one
    and binds); the device's idle share of its wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(1536):
        sched.store.create("Pod", default_pod(i, "pprof"))
    sched.schedule_cycle()
    sched.schedule_cycle()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        stats = sched.schedule_cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    pads = [fl.batch.size for fl in sched._inflight_q]
    sched.run_until_idle()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in events), reverse=True)
    lines = [f"one pipelined NorthStar-shaped cycle under torch.profiler (in flight after "
             f"it: pads {pads}; bound {stats.scheduled}): wall {wall_ms:.3f} ms, device "
             f"busy {busy_ms:.3f} ms", f"{'device ms':>10} {'count':>6}  name"]
    lines += [f"{ms:10.4f} {cnt:6d}  {name}" for ms, cnt, name in top]
    (out_dir / "profile_pipelined_cycle.txt").write_text("\n".join(lines) + "\n")
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "bound": stats.scheduled,
           "inflight_pads": pads,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "top": [[ms, cnt, name] for ms, cnt, name in top[:12]]}
    if busy_ms:
        log(f"profiled pipelined NorthStar cycle: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.3f} ms (idle share {rec['device_idle_share']:.4f}); bound "
            f"{stats.scheduled}, in flight {pads}")
    else:
        log("profiled pipelined cycle: the profiler recorded no device time (not measured)")
    return rec


# --- phase 5b: cuda pipelined == cuda sync ------------------------------------------------


def pipelined_vs_sync(kind: str) -> dict:
    """One 1000-node cluster on cuda, pipelined (depth 3) and synchronous, at
    the same segmentation (no latency target, a deterministic clock, no
    backoff hold): the same node for every pod, and the pipelined run chains
    real carries.  "northstar": node_default nodes presized past the
    small-tier bound (so K16 runs), 200 pre-bound pods, 1536 pending pods of
    four sizes; "spread": 1000 pod_default pods first, then 1024
    DoNotSchedule spread pods; "preferred" / "anti": the suites' templates,
    200 first pods then 1024 / 768 measured."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    def run(pipeline):
        t = [0.0]

        def clock():
            t[0] += 1e-6
            return t[0]

        kernels.reset_launches()
        if kind == "northstar":
            store = ObjectStore()
            for i in range(1000):
                store.create("Node", make_node().name(f"node-{i:06d}")
                             .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
            for i in range(200):
                store.create("Pod", make_pod().name(f"pre-{i:06d}").uid(f"pre-{i:06d}")
                             .namespace("default").req({"cpu": "100m", "memory": "500Mi"})
                             .node(f"node-{i:06d}").obj())
            sched = TorchScheduler(store, batch_size=512, device="cuda", clock=clock,
                                   batch_wait=0, pipeline=pipeline)
            sched.presize(1100, 2048)
            for i in range(1536):
                cpu = ("100m", "250m", "500m", "1")[i % 4]
                store.create("Pod", make_pod().name(f"pod-{i:06d}").uid(f"pod-{i:06d}")
                             .namespace("default").creation_timestamp(float(i))
                             .req({"cpu": cpu, "memory": "500Mi"}).obj())
        elif kind == "spread":
            sched = spread_cluster("cuda", 1000, 1000, clock=clock, pipeline=pipeline)
            for i in range(1024):
                sched.store.create("Pod", spread_pod(i, "spread", ts0=1e6))
        else:
            suite = next(s for s, v in AFFINITY_SUITES.items() if v[0] == kind)
            sched = affinity_cluster("cuda", suite, 1000, 200, clock=clock, pipeline=pipeline)
            for i in range(1024 if kind == "preferred" else 768):
                sched.store.create("Pod", affinity_pod(kind, i, "sched-1", ts0=1e6))
        c0 = sched.carried_pods
        t0 = time.perf_counter()
        sched.run_until_idle()
        wall = time.perf_counter() - t0
        pods, _ = sched.store.list("Pod")
        return ({p.metadata.name: p.spec.node_name for p in pods},
                sched.carried_pods - c0, dict(kernels.LAUNCHES), wall)

    pb, carried, launches, p_wall = run(True)
    sb, _, _, s_wall = run(False)
    if pb != sb:
        diff = [k for k in pb if pb[k] != sb.get(k)]
        fail(f"{kind}: cuda pipelined and cuda sync bindings differ for {len(diff)} pods, "
             f"e.g. {diff[:3]}")
    if not all(pb.values()):
        fail(f"{kind}: {sum(1 for v in pb.values() if not v)} pods unbound")
    if carried <= 0 or launches["prev_delta_apply"] <= 0:
        fail(f"{kind}: the pipelined run chained no placed pod ({launches})")
    chain_k = {"spread": "spread_chain_prev", "preferred": "ipa_chain_prev",
               "anti": "ipa_chain_prev", "northstar": "scatter_rows"}[kind]
    if launches[chain_k] <= 0:
        fail(f"{kind}: kernel {chain_k} never launched in the pipelined run")
    rec = {"pods": len(pb), "carried_pods": carried, "launches": launches,
           "pipelined_wall_s": p_wall, "sync_wall_s": s_wall}
    log(f"{kind}-shaped 1000-node cluster: cuda pipelined == cuda sync bindings "
        f"({len(pb)} pods, {carried} carried pods; pipelined {p_wall:.2f} s, sync "
        f"{s_wall:.2f} s)")
    return rec


# --- phase 6: K13–K16 at the main path's shapes -------------------------------------------


def time_pipeline_kernels(last_calls: dict, err: dict) -> list:
    """K13–K16 timed on the arguments of their latest calls on the main path
    (K13 and K16 from the NorthStar harness run, K14 from the pipelined
    TopologySpreading run, K15 from the pipelined
    SchedulingPreferredPodAffinity run), each held once more against its
    plain version there; the bound from what those inputs make the kernel
    touch."""
    import torch

    from kubernetes_tpu_torch.kernels import interpodaffinity as KI
    from kubernetes_tpu_torch.kernels import prev_delta as KD
    from kubernetes_tpu_torch.kernels import scatter as KS
    from kubernetes_tpu_torch.kernels import spread as KSp

    rows_out = []

    def row(name, src, replaces, symbol, fn, plain_fn, n_bytes, n_ops, shape,
            library_fn=None):
        least, bound_by = bound_ms(n_bytes, n_ops)
        ms, libs, source = ms_one_method(fn, symbol, *([library_fn] if library_fn else []))
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err[name],
            "ms": ms, "ms_source": source, "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
            "bound_ms": least, "bound_by": bound_by,
            "library_ms": libs[0] if libs else None,
            "bytes": n_bytes, "ops": n_ops, "shape": shape})

    def last(key):
        got = last_calls.get(key)
        if got is None:
            fail(f"kernel timing: no recorded path call of {key[0]}")
        return got[0]

    # K13: one launch writes the new arrays with the adds folded in; bytes:
    # the bundles, and the rows they touch read and written
    requested, non_zero, bundles = last(("prev_delta_apply", 0))
    kr, kn = KD.prev_delta_apply(requested, non_zero, bundles)
    pr, pn = KD.prev_delta_apply_plain(requested, non_zero, bundles)
    err["prev_delta_apply"] = max(err["prev_delta_apply"], require_equal(
        "prev_delta_apply (path shapes)", [("requested", kr, pr), ("non_zero", kn, pn)]))
    r = requested.shape[1]
    placed = torch.cat([b[0][b[0] >= 0] for b in bundles])
    touched = int(placed.unique().numel())
    b_bytes = sum(nbytes(*(t for t in b if t is not None)) for b in bundles)
    all_rows = torch.cat([b[0] for b in bundles])
    ok = (all_rows >= 0)[:, None]
    at = all_rows.long().clamp(0, requested.shape[0] - 1)
    all_req = torch.where(ok, torch.cat([b[1] for b in bundles]), 0)
    all_nz = torch.where(ok, torch.cat([torch.zeros_like(b[1][:, :2]) if b[2] is None
                                        else b[2] for b in bundles]), 0)
    work_r, work_n = requested.clone(), non_zero.clone()

    def library():
        work_r.index_add_(0, at, all_req)
        work_n.index_add_(0, at, all_nz)

    def k13():
        return KD.prev_delta_apply(requested, non_zero, bundles)

    row("prev_delta_apply", "kubernetes_tpu_torch/csrc/prev_delta.cu",
        "kubernetes_tpu/scheduler.py:897", "prev_delta_kernel", k13,
        lambda: KD.prev_delta_apply_plain(requested, non_zero, bundles),
        b_bytes + touched * (r + 2) * 4 * 2, int(placed.numel()) * (r + 2),
        {"N": requested.shape[0], "R": r, "bundles": len(bundles),
         "B0": [int(b[0].numel()) for b in bundles], "placed": int(placed.numel())},
        library_fn=library)
    # the other method beside it, the library call timed the same way
    rows_out[-1]["queued_ms"] = queued_device_ms(k13)
    rows_out[-1]["library_queued_ms"] = queued_device_ms(library)
    one_device_activity("prev_delta_apply (path shapes)", k13, "prev_delta_kernel",
                        "prev_delta_apply")
    log(f"  prev_delta_apply (path shapes): {rows_out[-1]['ms']:.5f} ms "
        f"({rows_out[-1]['ms_source']}) against index_add_'s "
        f"{rows_out[-1]['library_ms']:.5f}; queued {rows_out[-1]['queued_ms']:.5f} against "
        f"{rows_out[-1]['library_queued_ms']:.5f}")

    # K16: the node group (the largest), bound kernel_work.k16_work; one
    # kernel node a call there and with k = 0
    node_key = max((k for k in last_calls if k[0] == "scatter_rows"), key=lambda k: k[1])
    arrays, rows_t, vals = last(node_key)
    got = KS.scatter_rows(arrays, rows_t, vals)
    want = KS.scatter_rows_plain(arrays, rows_t, vals)
    err["scatter_rows"] = max(err["scatter_rows"], require_equal(
        "scatter_rows (path shapes)", [(f"array {i}", g, w_) for i, (g, w_) in
                                       enumerate(zip(got, want))]))
    rl = rows_t.long()
    row("scatter_rows", "kubernetes_tpu_torch/csrc/scatter_rows.cu",
        "kubernetes_tpu/state/encoding.py:168,883", "scatter_rows_kernel",
        lambda: KS.scatter_rows(arrays, rows_t, vals),
        lambda: KS.scatter_rows_plain(arrays, rows_t, vals),
        *KW.k16_work(arrays, rows_t, vals),
        {"arrays": len(arrays), "rows": arrays[0].shape[0], "payload_rows": rows_t.numel(),
         "distinct": int(rows_t.unique().numel())},
        library_fn=lambda: [a.index_copy(0, rl, v) for a, v in zip(arrays, vals)])
    one_device_activity("scatter_rows (node group, path shapes)",
                        lambda: KS.scatter_rows(arrays, rows_t, vals), "scatter_rows_kernel",
                        "scatter_rows")
    one_device_activity("scatter_rows (node group, k = 0)",
                        lambda: KS.scatter_rows(arrays, rows_t[:0], [v[:0] for v in vals]),
                        "scatter_rows_kernel", "scatter_rows")

    # K14: per matched placed prev pod, its node's counted flags and domain,
    # and the tables' read-modify-write where it counts
    aux, match, rows14, valid14 = last(("spread_chain_prev", 0))
    kh, ks = KSp.spread_chain_prev(aux, match, rows14, valid14)
    ph, ps = KSp.spread_chain_prev_plain(aux, match, rows14, valid14)
    err["spread_chain_prev"] = max(err["spread_chain_prev"], require_equal(
        "spread_chain_prev (path shapes)", [("hard", kh, ph), ("soft", ks, ps)]))
    hits = int((match & ((rows14 >= 0) & valid14)[None, None, :]).sum())
    adds = int((kh - aux.hard_counts).sum() + (ks - aux.soft_counts).sum())
    c, cc, b0 = match.shape
    row("spread_chain_prev", "kubernetes_tpu_torch/csrc/spread.cu",
        "kubernetes_tpu/plugins/podtopologyspread.py:306", "spread_chain_kernel",
        lambda: KSp.spread_chain_prev(aux, match, rows14, valid14),
        lambda: KSp.spread_chain_prev_plain(aux, match, rows14, valid14),
        c * cc * b0 + b0 * 5 + hits * 6 + adds * 8, hits,
        {"C": c, "Cc": cc, "B0": b0, "N": aux.dom_val.shape[-1],
         "D1": aux.hard_counts.shape[-1], "matched_placed": hits})

    # K15: the count half reads the cross and, per matched placed pod, its
    # node's domain, then writes the touched tables or planes; the own half
    # reads the key column of node_topo once per placed valid prev term and
    # writes the block / score of every matched (class, node)
    aux, counts, own, rows15, node_topo, missing = last(("ipa_chain_prev", 0))
    got = KI.ipa_chain_prev(aux, counts, own, rows15, node_topo, missing)
    want = KI.ipa_chain_prev_plain(aux, counts, own, rows15, node_topo, missing)
    err["ipa_chain_prev"] = max(err["ipa_chain_prev"], require_equal(
        "ipa_chain_prev (path shapes)", [(f, got[f], want[f]) for f in sorted(got)]))
    n = aux.exist_anti_block.shape[1]
    placed15 = rows15 >= 0
    b15 = nbytes(rows15)
    ops15 = 0
    for name, cross in counts.items():
        hit = cross & placed15[None, None, :]
        b15 += cross.numel() + int(hit.sum()) * 4
        cnt_f = KI.GROUP_FIELDS[name][1]
        changed = int((got[cnt_f] != getattr(aux, cnt_f)).sum())
        b15 += changed * 8
        ops15 += int(hit.sum())
    for g in own:
        live = int((g.term_valid & placed15[:, None]).sum())
        b15 += g.mm.numel() + nbytes(g.topo_key) + g.term_valid.numel() + live * n * 4
        ops15 += live * n
    if own:
        b15 += int((got["block_dyn"] != aux.block_dyn).sum()) \
            + int((got["score_dyn"] != aux.score_dyn).sum()) * 8
    row("ipa_chain_prev", "kubernetes_tpu_torch/csrc/interpodaffinity.cu",
        "kubernetes_tpu/plugins/interpodaffinity.py:533", "ipa_chain",
        lambda: KI.ipa_chain_prev(aux, counts, own, rows15, node_topo, missing),
        lambda: KI.ipa_chain_prev_plain(aux, counts, own, rows15, node_topo, missing),
        b15, ops15,
        {"C": aux.exist_anti_block.shape[0], "N": n, "B0": rows15.numel(),
         "count_groups": sorted(counts), "own_groups": len(own),
         "planes": any(getattr(aux, KI.GROUP_FIELDS[g][1]).shape[-1] == n for g in counts)})
    for rr in rows_out:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms"
            + (f", library {rr['library_ms']:.5f} ms" if rr["library_ms"] is not None else "")
            + f"; {rr['shape']}")
    return rows_out


# --- phase 3: NorthStar ---------------------------------------------------------------


def northstar(dev_name: str) -> dict:
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    n_nodes, n_pre, n_pods = 5000, 2000, 10000
    fresh_heap()
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
    with GcWatch() as gcw:
        stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)

    check_bound_and_fit("NorthStar", store)
    if stats.scheduled != n_pods:
        fail(f"NorthStar: scheduled {stats.scheduled} of {n_pods}")
    for k in ("filter_score_planes", "normalize_combine", "topk_rows",
              "auction_resolve_commit"):
        if launches[k] <= 0:
            fail(f"NorthStar: kernel {k} never launched on the main path")
    # a claim-free batch leaves DynamicResources' kernels idle (its aux is None)
    if any(launches[k] for k in ("dra_filter_bits", "dra_score_into", "dra_take")):
        fail(f"NorthStar: a DynamicResources kernel launched on claim-free batches "
             f"({launches})")
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
        "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds,
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
        f"{gcw.count} full collections ({gcw.seconds:.3f} s); launches {launches}")
    return {"record": out, "sched": sched}


# --- phase 4: TopologySpreading / PreferredTopologySpreading ----------------------------

ZONE_KEY = "topology.kubernetes.io/zone"
ZONES3 = ["moon-1", "moon-2", "moon-3"]  # the suite's zones (perf/workloads.py)


def zoned_node(i: int):
    """node_zoned(ZONES3): a 4-cpu / 32Gi / 110-pod node in one of three zones."""
    from kubernetes_tpu_torch.testutil import make_node

    return (make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label(ZONE_KEY, ZONES3[i % len(ZONES3)]).obj())


def default_pod(i: int, prefix: str = "pod"):
    """pod_default: 100m / 500Mi."""
    from kubernetes_tpu_torch.testutil import make_pod

    return (make_pod().name(f"{prefix}-{i:06d}").uid(f"{prefix}-{i:06d}")
            .namespace("default").creation_timestamp(float(i))
            .req({"cpu": "100m", "memory": "500Mi"}).obj())


def spread_pod(i: int, prefix: str = "spread", when: str = "DoNotSchedule",
               ts0: float = 1e6, priority: int = 0):
    """pod_topology_spread (maxSkew 5, DoNotSchedule on the zone, selecting
    color=blue, itself blue) or, with ScheduleAnyway, the preferred twin;
    with ``priority`` a pod of that priority (it could preempt)."""
    from kubernetes_tpu_torch.testutil import make_pod

    w = (make_pod().name(f"{prefix}-{i:06d}").uid(f"{prefix}-{i:06d}")
         .namespace("default").creation_timestamp(ts0 + i)
         .req({"cpu": "100m", "memory": "500Mi"}).label("color", "blue")
         .topology_spread(5, ZONE_KEY, when, labels={"color": "blue"}))
    return (w.priority(priority) if priority else w).obj()


def check_bound_and_fit(what: str, store):
    """Every pod bound, no node past 4 cpu / 32Gi / 110 pods; → the pods."""
    from kubernetes_tpu_torch.api.resource import compute_pod_resource_request

    pods, _ = store.list("Pod")
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    if unbound:
        fail(f"{what}: {len(unbound)} pods unbound, e.g. {unbound[:3]}")
    used = {}
    for p in pods:
        if not p.spec.node_name:
            continue
        r = compute_pod_resource_request(p)
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    for name, (cpu, mem, count) in used.items():
        if cpu > 4000 or mem > 32 * 1024 ** 3 or count > 110:
            fail(f"{what}: node {name} oversubscribed ({cpu}m, {mem} B, {count} pods)")
    return pods


def spread_cluster(dev_name: str, n_nodes: int, n_first: int, batch_size: int = 512,
                   clock=None, pipeline: bool = False, **sched_kw):
    """A TopologySpreading-shaped cluster: zoned nodes, then pod_default pods
    scheduled first through the path (as the suite does) — → the scheduler."""
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    store = ObjectStore()
    for i in range(n_nodes):
        store.create("Node", zoned_node(i))
    kw = {} if clock is None else {"clock": clock, "batch_wait": 0}
    sched = TorchScheduler(store, batch_size=batch_size, device=dev_name,
                           pipeline=pipeline, **kw, **sched_kw)
    sched.presize(n_nodes, n_first + 2048)
    for i in range(n_first):
        store.create("Pod", default_pod(i))
    stats = sched.run_until_idle()
    if stats.scheduled != n_first:
        fail(f"spread cluster: scheduled {stats.scheduled} of the {n_first} first pods")
    return sched


def zone_counts(pods, prefix: str):
    zone = {f"node-{i:06d}": i % 3 for i in range(100000)}
    counts = [0, 0, 0]
    for p in pods:
        if p.metadata.name.startswith(prefix) and p.spec.node_name:
            counts[zone[p.spec.node_name]] += 1
    return counts


def topology_spreading(dev_name: str, pipeline: bool = False) -> dict:
    """TopologySpreading/5000Nodes at full width: 5000 zoned nodes, 5000
    pod_default pods scheduled first, then 2000 pod_topology_spread pods —
    the measured run, with the launch counts zeroed just before it.  With
    ``pipeline`` through TorchScheduler(pipeline=True): K14 must launch on
    real carries."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels

    n_nodes, n_first, n_pods = 5000, 5000, 2000
    what = "TopologySpreading" + (" (pipelined)" if pipeline else "")
    fresh_heap()
    t0 = time.perf_counter()
    sched = spread_cluster(dev_name, n_nodes, n_first, pipeline=pipeline)
    for i in range(n_pods):
        sched.store.create("Pod", spread_pod(i))
    setup_s = time.perf_counter() - t0
    c0, r0, rr0 = sched.cycles, sched.rounds_total, sched.round_read_s
    pw0 = dict(sched.phase_wall)
    att0 = len(sched.attempt_seconds)
    carried0 = sched.carried_pods

    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw:
        stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)

    pods = check_bound_and_fit(what, sched.store)
    if stats.scheduled != n_pods:
        fail(f"{what}: scheduled {stats.scheduled} of {n_pods}")
    zc = zone_counts(pods, "spread-")
    if max(zc) - min(zc) > 5:
        fail(f"{what}: zone skew {zc} exceeds maxSkew 5")
    for k in PATH_KERNELS[:8] + (("spread_chain_prev", "prev_delta_apply") if pipeline else ()):
        if launches[k] <= 0:
            fail(f"{what}: kernel {k} never launched on the main path")
    carried = sched.carried_pods - carried0
    if pipeline and carried <= 0:
        fail(f"{what}: no placed pod reached a later dispatch as a carry")
    cycles = sched.cycles - c0
    rounds = sched.rounds_total - r0
    read_s = sched.round_read_s - rr0
    phase = {k: sched.phase_wall[k] - pw0[k] for k in pw0}
    att = np.asarray(sched.attempt_seconds[att0:])
    rec = {
        "nodes": n_nodes, "first_pods": n_first, "pods": n_pods, "batch_size": 512,
        "setup_s": setup_s, "wall_s": wall, "pods_per_s": n_pods / wall,
        "cycles": cycles, "rounds": rounds, "rounds_per_cycle": rounds / max(cycles, 1),
        "round_wall_ms": phase["device"] / max(rounds, 1) * 1e3,
        "host_read_ms_per_round": read_s / max(rounds, 1) * 1e3,
        "phase_wall_s": phase, "zone_counts": zc, "launches": launches,
        "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds,
        "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
        "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
        "node_tier": sched.encoder._n, "pipeline": pipeline, "carried_pods": carried,
    }
    log(f"{what}/5000Nodes: {n_pods} spread pods bound in {wall:.3f} s = "
        f"{rec['pods_per_s']:.1f} pods/s; {cycles} cycles, {rec['rounds_per_cycle']:.1f} "
        f"rounds/cycle; device half {rec['round_wall_ms']:.3f} ms/round, of which host "
        f"read {rec['host_read_ms_per_round']:.3f} ms; phase wall (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
        + f"; zones {zc}; attempt p50 {rec['attempt_p50_ms']:.1f} ms, p99 "
        f"{rec['attempt_p99_ms']:.1f} ms; {gcw.count} full collections "
        f"({gcw.seconds:.3f} s); setup {setup_s:.1f} s; launches {launches}")
    return {"record": rec, "sched": sched}


def preferred_spreading(dev_name: str) -> dict:
    """PreferredTopologySpreading at 5000 nodes: the same cluster shape,
    then one cycle of 512 ScheduleAnyway spread pods (the score half)."""
    import torch

    from kubernetes_tpu_torch import kernels

    sched = spread_cluster(dev_name, 5000, 5000)
    for i in range(512):
        sched.store.create("Pod", spread_pod(i, "pspread", "ScheduleAnyway"))
    torch.cuda.synchronize()
    kernels.reset_launches()
    r0 = sched.rounds_total
    t = time.perf_counter()
    stats = sched.schedule_cycle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    if stats.scheduled != 512:
        fail(f"PreferredTopologySpreading: scheduled {stats.scheduled} of 512")
    check_bound_and_fit("PreferredTopologySpreading", sched.store)
    if launches["spread_score_combine"] <= 0 or launches["spread_prepare_counts"] <= 0:
        fail(f"PreferredTopologySpreading: the spread kernels did not launch ({launches})")
    rec = {"pods": 512, "wall_s": wall, "pods_per_s": 512 / wall,
           "rounds": sched.rounds_total - r0, "launches": launches}
    log(f"PreferredTopologySpreading/5000Nodes: one cycle of 512 pods in {wall:.3f} s "
        f"({rec['rounds']} rounds); launches {launches}")
    return rec


# --- phase 4: the pod-affinity suites ------------------------------------------------------

HOST_KEY = "kubernetes.io/hostname"


def host_node(i: int):
    """node_unique_hostname: a 4-cpu / 32Gi / 110-pod node, its own hostname."""
    from kubernetes_tpu_torch.testutil import make_node

    return (make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label(HOST_KEY, f"node-{i:06d}").obj())


def zone1_node(i: int):
    """node_zoned(["zone1"]): every node in the one zone."""
    from kubernetes_tpu_torch.testutil import make_node

    return (make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label(ZONE_KEY, "zone1").obj())


def affinity_pod(kind: str, i: int, ns: str, ts0: float = 0.0, tag: str = "",
                 priority: int = 0):
    """The suites' pod templates (perf/workloads.py): pod_anti_affinity
    (green, required anti-affinity on the hostname), pod_affinity (blue,
    required affinity on the zone) and pod_preferred_affinity (red,
    preferred affinity of weight 1 on the hostname), each over the
    namespaces sched-0 and sched-1."""
    from kubernetes_tpu_torch.testutil import make_pod

    prefix = {"anti": "anti", "affinity": "aff", "preferred": "paff"}[kind] + tag
    w = (make_pod().name(f"{prefix}-{ns}-{i:06d}").uid(f"{prefix}-{ns}-{i:06d}")
         .namespace(ns).creation_timestamp(ts0 + i)
         .req({"cpu": "100m", "memory": "500Mi"}))
    if priority:
        w = w.priority(priority)
    if kind == "anti":
        return (w.label("color", "green").pod_affinity(
            HOST_KEY, {"color": "green"}, anti=True, namespaces=["sched-0", "sched-1"]).obj())
    if kind == "affinity":
        return (w.label("color", "blue").pod_affinity(
            ZONE_KEY, {"color": "blue"}, namespaces=["sched-0", "sched-1"]).obj())
    return (w.label("color", "red").pod_affinity(
        HOST_KEY, {"color": "red"}, weight=1, namespaces=["sched-1", "sched-0"]).obj())


# suite → (pod kind, node template, (nodes, first pods, measured pods)) at 5000Nodes
AFFINITY_SUITES = {
    "SchedulingPodAntiAffinity": ("anti", host_node, (5000, 1000, 1000)),
    "SchedulingPodAffinity": ("affinity", zone1_node, (5000, 5000, 1000)),
    "SchedulingPreferredPodAffinity": ("preferred", host_node, (5000, 5000, 1000)),
}


def affinity_cluster(dev_name: str, suite: str, n_nodes: int, n_first: int,
                     clock=None, pipeline: bool = False, **sched_kw):
    """A suite's cluster: its nodes, then its first pods (namespace sched-0)
    scheduled through the path, as the suite does — → the scheduler."""
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    kind, node_of, _ = AFFINITY_SUITES[suite]
    store = ObjectStore()
    for i in range(n_nodes):
        store.create("Node", node_of(i))
    kw = {} if clock is None else {"clock": clock, "batch_wait": 0}
    sched = TorchScheduler(store, batch_size=512, device=dev_name, pipeline=pipeline, **kw,
                           **sched_kw)
    sched.presize(n_nodes, n_first + 2048)
    for i in range(n_first):
        store.create("Pod", affinity_pod(kind, i, "sched-0"))
    stats = sched.run_until_idle()
    if stats.scheduled != n_first:
        fail(f"{suite}: scheduled {stats.scheduled} of the {n_first} first pods")
    return sched


def affinity_suite(dev_name: str, suite: str, pipeline: bool = False) -> dict:
    """One pod-affinity suite at 5000Nodes, full width: the first pods
    scheduled through the path, then the measured pods (namespace sched-1),
    with the launch counts zeroed just before them.  With ``pipeline``
    through TorchScheduler(pipeline=True): K15 must launch on real
    carries."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels

    kind, _, (n_nodes, n_first, n_pods) = AFFINITY_SUITES[suite]
    what = suite + (" (pipelined)" if pipeline else "")
    fresh_heap()
    t0 = time.perf_counter()
    sched = affinity_cluster(dev_name, suite, n_nodes, n_first, pipeline=pipeline)
    for i in range(n_pods):
        sched.store.create("Pod", affinity_pod(kind, i, "sched-1", ts0=1e6))
    setup_s = time.perf_counter() - t0
    c0, r0, rr0 = sched.cycles, sched.rounds_total, sched.round_read_s
    pw0 = dict(sched.phase_wall)
    att0 = len(sched.attempt_seconds)
    carried0 = sched.carried_pods

    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw:
        stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)

    pods = check_bound_and_fit(what, sched.store)
    if stats.scheduled != n_pods:
        fail(f"{what}: scheduled {stats.scheduled} of {n_pods}")
    placed = [p.spec.node_name for p in pods]
    if kind == "anti" and len(set(placed)) != len(placed):
        fail(f"{what}: two green pods share a host")
    if kind == "affinity":
        zone = {n.metadata.name: n.metadata.labels.get(ZONE_KEY)
                for n in sched.store.list("Node")[0]}
        if any(zone[name] != "zone1" for name in placed):
            fail(f"{what}: a blue pod landed outside zone1")
    for k in PATH_KERNELS[:4] + IPA_KERNELS + (
            ("ipa_chain_prev", "prev_delta_apply") if pipeline else ()):
        if launches[k] <= 0:
            fail(f"{what}: kernel {k} never launched on the main path")
    carried = sched.carried_pods - carried0
    if pipeline and carried <= 0:
        fail(f"{what}: no placed pod reached a later dispatch as a carry")
    cycles = sched.cycles - c0
    rounds = sched.rounds_total - r0
    read_s = sched.round_read_s - rr0
    phase = {k: sched.phase_wall[k] - pw0[k] for k in pw0}
    att = np.asarray(sched.attempt_seconds[att0:])
    rec = {
        "nodes": n_nodes, "first_pods": n_first, "pods": n_pods, "batch_size": 512,
        "setup_s": setup_s, "wall_s": wall, "pods_per_s": n_pods / wall,
        "cycles": cycles, "rounds": rounds, "rounds_per_cycle": rounds / max(cycles, 1),
        "round_wall_ms": phase["device"] / max(rounds, 1) * 1e3,
        "host_read_ms_per_round": read_s / max(rounds, 1) * 1e3,
        "phase_wall_s": phase, "launches": launches,
        "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
        "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
        "node_tier": sched.encoder._n, "pod_tier": sched.encoder._p,
        "live_groups": sched.encoder.aff.live_groups,
        "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds,
        "pipeline": pipeline, "carried_pods": carried,
    }
    log(f"{what}/5000Nodes: {n_pods} pods bound in {wall:.3f} s = "
        f"{rec['pods_per_s']:.1f} pods/s; {cycles} cycles, {rec['rounds_per_cycle']:.1f} "
        f"rounds/cycle; device half {rec['round_wall_ms']:.3f} ms/round, of which host "
        f"read {rec['host_read_ms_per_round']:.3f} ms; phase wall (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
        + f"; attempt p50 {rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms;"
        f" {gcw.count} full collections ({gcw.seconds:.3f} s); setup {setup_s:.1f} s; "
        f"launches {launches}")
    return {"record": rec, "sched": sched}


def affinity_bindings(device: str, kind: str):
    """The suites cut so the CPU half stays short: 1000 nodes, 200 first
    pods, 512 measured; "mixed": 1000 zoned nodes, 200 zone-affinity pods
    first, then one queue of affinity, spread, pod_default and preferred
    hostname-affinity pods — → (bindings, launches)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    t = [0.0]

    def clock():
        t[0] += 1e-6
        return t[0]

    if kind == "mixed":
        store = ObjectStore()
        for i in range(1000):
            store.create("Node", zoned_node(i))
        sched = TorchScheduler(store, batch_size=512, device=device, clock=clock,
                               batch_wait=0)
        for i in range(200):
            store.create("Pod", affinity_pod("affinity", i, "sched-0"))
        sched.run_until_idle()
        for i in range(512):
            k = i % 4
            if k == 0:
                store.create("Pod", affinity_pod("affinity", i, "sched-1", ts0=1e6))
            elif k == 1:
                store.create("Pod", spread_pod(i, "mspread", ts0=1e6))
            elif k == 2:
                store.create("Pod", default_pod(i, "mixdef"))
            else:
                store.create("Pod", affinity_pod("preferred", i, "sched-1", ts0=1e6))
    else:
        suite = next(s for s, v in AFFINITY_SUITES.items() if v[0] == kind)
        sched = affinity_cluster(device, suite, 1000, 200, clock=clock)
        store = sched.store
        for i in range(512):
            store.create("Pod", affinity_pod(kind, i, "sched-1", ts0=1e6))
    kernels.reset_launches()
    while sched.schedule_cycle().attempted:
        pass
    pods, _ = store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in pods}, dict(kernels.LAUNCHES)


# --- phase 5: spread clusters, cuda vs cpu ----------------------------------------------


def spread_bindings(device: str, kind: str):
    """1000 zoned nodes, 1000 pod_default pods first, then 512 spread pods
    (DoNotSchedule, ScheduleAnyway, or "mixed": 256 spread and 256
    pod_default pods interleaved in one batch) — → (bindings, launches)."""
    from kubernetes_tpu_torch import kernels

    t = [0.0]

    def clock():
        t[0] += 1e-6
        return t[0]

    sched = spread_cluster(device, 1000, 1000, clock=clock)
    for i in range(512):
        if kind == "mixed" and i % 2:
            sched.store.create("Pod", default_pod(i, "mixdef"))
            continue
        when = "ScheduleAnyway" if kind == "preferred" else "DoNotSchedule"
        sched.store.create("Pod", spread_pod(i, "spread", when, ts0=1e6))
    kernels.reset_launches()
    while sched.schedule_cycle().attempted:
        pass
    pods, _ = sched.store.list("Pod")
    return {p.metadata.name: p.spec.node_name for p in pods}, dict(kernels.LAUNCHES)


# --- phase 5: heterogeneous cluster, cuda vs cpu ------------------------------------------


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


# --- phase 6: timing at the main path's shapes ------------------------------------------


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
    fs_plan, comb_plan = sched._framework().kernel_plans()
    full = (1 << len(sched._framework().filter_names)) - 1
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
    # int32 index inputs, as the engine passes them (no conversion in the call)
    class_t = torch.from_numpy(class_of.astype(np.int32)).to(dev)
    pos_of = torch.arange(b, dtype=torch.int32, device=dev)
    unres = dbatch.valid.clone()
    nom = torch.zeros(b, dtype=torch.int32, device=dev)
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
        ms, libs, source = ms_one_method(fn, symbol, *([library_fn] if library_fn else []))
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": None, "max_abs_err": err[name],
            "ms": ms, "ms_source": source, "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=plain_reps, warmup=1),
            "bound_ms": least, "bound_by": bound_by,
            "library_ms": libs[0] if libs else None,
            "bytes": n_bytes, "ops": n_ops, "shape": {"C": c, "N": n, "B": b, "K": k},
        })

    r = dyn.requested.shape[1]
    row("filter_score_planes", "kubernetes_tpu_torch/csrc/filter_score.cu",
        "kubernetes_tpu/framework/runtime.py:852", "filter_score_kernel",
        lambda: filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, fs_plan),
        lambda: filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, fs_plan),
        *k1_work(rep, snap, dyn, na_mask, na_pref, img, bits, raw))
    one_device_activity("filter_score_planes (NorthStar)",
                        lambda: filter_score_planes(rep, snap, dyn, na_mask, na_pref, img,
                                                    fs_plan),
                        "filter_score_kernel", "filter_score_planes")
    # per (class, feasible node, plane): the row max, the scaling, the
    # floor, the add; K2 reads the raw planes only on feasible nodes
    n_feas = int(feas.sum())
    row("normalize_combine", "kubernetes_tpu_torch/csrc/normalize_combine.cu",
        "kubernetes_tpu/framework/runtime.py:857", "normalize_combine_kernel",
        lambda: normalize_combine(bits, full, raw, comb_plan),
        lambda: normalize_combine_plain(bits, full, raw, comb_plan),
        nbytes(bits, total, feas) + 4 * raw.shape[0] * n_feas, n_feas * raw.shape[0] * 4)
    rows[-1]["shape"]["feasible"] = n_feas
    ROUND_CALLS["normalize_combine"] = (
        lambda: normalize_combine(bits, full, raw, comb_plan), "normalize_combine_kernel", {})
    # a selection compares every entry at least once
    row("topk_rows", "kubernetes_tpu_torch/csrc/topk_rows.cu",
        "kubernetes_tpu/framework/runtime.py:875", "topk_select_kernel",
        lambda: topk_rows(total, k), lambda: topk_rows_plain(total, k),
        nbytes(total) + c * k * 8, c * n, library_fn=lambda: torch.topk(total, k, dim=1))
    ROUND_CALLS["topk_rows"] = (
        lambda: topk_rows(total, k), "topk_select_kernel",
        {"library_ms": lambda: torch.topk(total, k, dim=1),
         "library_sort_ms": lambda: torch.sort(total, dim=1, descending=True, stable=True)})
    # K4 reads its index inputs as int32 and writes only the committed rows
    # of requested / non_zero; each commit takes at least one bid, one
    # resolve and its R + 2 adds
    k4_bytes = (nbytes(cv, unres, nom_ok, dbatch.request, dbatch.non_zero)
                + 4 * (ci.numel() + class_t.numel() + pos_of.numel() + nom.numel())
                + b * 8 + commits * (r + 2) * 4 * 2)
    row("auction_resolve_commit", "kubernetes_tpu_torch/csrc/auction.cu",
        "kubernetes_tpu/framework/runtime.py:898", "auction_kernel",
        lambda: auction_resolve_commit(*a_args, work_req, work_nz),
        lambda: auction_resolve_commit_plain(*a_args, work_req, work_nz),
        k4_bytes, commits * (r + 4), plain_reps=3)
    rows[-1].update(auction_iterations(a_args, dyn.requested, dyn.non_zero))
    ROUND_CALLS["auction_resolve_commit"] = (
        lambda: auction_resolve_commit(*a_args, work_req, work_nz), "auction_kernel", {})
    return rows


def auction_iterations(args, requested, node_nz) -> dict:
    """K4's fixpoint iterations on these inputs (its ``iters`` output, read
    here only) and how many were steps of the closed form's prefix form."""
    from kubernetes_tpu_torch.kernels.auction import auction_resolve_commit

    _c, _ch, iters = auction_resolve_commit(*args, requested.clone(), node_nz.clone(),
                                            count_iters=True)
    it, steps = iters.tolist()
    return {"iterations": it, "prefix_steps": steps}


def time_extender_programs(sched, err: dict) -> list:
    """compute_static and compute_row (the reference's runtime.py:259,
    274; the extender rounds' programs, which no path of the port calls)
    once each at B = 512, N = 8192 (the extender path's shape) on the
    NorthStar snapshot, held against the same methods with K1, K2 and K23
    swapped for their plain versions (``plain_kernels``), timed as in 6
    (device time of the whole call).  Bound: compute_static is K1 at C = B
    plus the mask written; compute_row K1 and K2 on one row."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.framework.podbatch import batch_to_device
    from kubernetes_tpu_torch.kernels.filter_score import filter_score_planes, pod_row
    from kubernetes_tpu_torch.testutil import make_pod

    snap = sched.encoder.to_device(force_full=True)
    pods = [make_pod().name(f"x{i}").uid(f"x{i}").namespace("default")
            .req({"cpu": "100m", "memory": "500Mi"}).obj() for i in range(512)]
    batch = sched.compiler.compile(pods, pad_to=512)
    dyn = DynamicState(requested=snap.requested.clone(),
                       non_zero=snap.non_zero_requested.clone())
    fw = sched._framework()
    dbatch = batch_to_device(batch, sched.device)
    got = fw.compute_static(dbatch, snap, dyn)
    with plain_kernels():
        want = fw.compute_static(dbatch, snap, dyn)
    torch.cuda.synchronize()
    err["compute_static"] = require_equal("compute_static (B = 512)", [
        ("static_mask", got[0], want[0])] + [
        (f"static_raw[{i}]", a, b_) for i, (a, b_) in enumerate(zip(got[1], want[1]))])
    mask, raw = got
    i = int(np.flatnonzero(batch.valid)[-1])
    row_got = fw.compute_row(dbatch, snap, dyn, None, mask, raw, i)
    with plain_kernels():
        row_want = fw.compute_row(dbatch, snap, dyn, None, mask, raw, i)
    torch.cuda.synchronize()
    err["compute_row"] = require_equal("compute_row (one row)", [
        ("row_mask", row_got[0], row_want[0]), ("total", row_got[1], row_want[1])])
    static = fw.static_inputs(dbatch, snap, dyn)
    fs_plan, _ = fw.kernel_plans(frozenset())
    bits, raw5 = filter_score_planes(dbatch, snap, dyn, *static, fs_plan)
    k1_b, k1_o = k1_work(dbatch, snap, dyn, *static, bits, raw5)
    one = pod_row(dbatch, i)
    rbits, rraw = filter_score_planes(one, snap, dyn, static[0][i:i + 1],
                                      static[1][i:i + 1], static[2], fs_plan)
    r1_b, r1_o = k1_work(one, snap, dyn, static[0][i:i + 1], static[1][i:i + 1],
                         static[2], rbits, rraw)
    b, n = mask.shape
    out = []
    for name, fn, plain, n_bytes, n_ops in (
            ("compute_static", lambda: fw.compute_static(dbatch, snap, dyn),
             lambda: plain_call(fw.compute_static, dbatch, snap, dyn),
             k1_b + b * n, k1_o),
            # K2 on the row: the bits and the raw planes read where feasible,
            # the total written
            ("compute_row", lambda: fw.compute_row(dbatch, snap, dyn, None, mask, raw, i),
             lambda: plain_call(fw.compute_row, dbatch, snap, dyn, None, mask, raw, i),
             r1_b + 4 * n * (1 + rraw.shape[0]) + 4 * n, r1_o + 4 * n * rraw.shape[0])):
        least, bound_by = bound_ms(n_bytes, n_ops)
        out.append({
            "name": name, "route": "cuda", "source": "kubernetes_tpu_torch/framework/runtime.py",
            "replaces": "kubernetes_tpu/framework/runtime.py:"
                        + ("259" if name == "compute_static" else "274"),
            "launches": 0, "max_abs_err": err[name], "ms": device_ms(fn),
            "ms_source": MS_SOURCE[0], "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain, reps=5, warmup=1), "bound_ms": least,
            "bound_by": bound_by, "library_ms": None, "bytes": n_bytes, "ops": n_ops,
            "shape": {"B": b, "N": n, "row": i if name == "compute_row" else None}})
        log(f"  {name}: {out[-1]['ms']:.5f} ms device ({out[-1]['ms_source']}), bound "
            f"{least:.7f} ms ({bound_by}), plain {out[-1]['plain_ms']:.4f} ms")
    return out


PLAIN_SWAPS = (
    ("kubernetes_tpu_torch.framework.runtime", "filter_score_planes",
     "kubernetes_tpu_torch.kernels.filter_score", "filter_score_planes_plain"),
    ("kubernetes_tpu_torch.framework.runtime", "normalize_combine",
     "kubernetes_tpu_torch.kernels.normalize", "normalize_combine_plain"),
    ("kubernetes_tpu_torch.state.selectors", "selector_match",
     "kubernetes_tpu_torch.kernels.selectors", "selector_match_plain"),
)


class plain_kernels:
    """For the ``with`` block the runtime's K1 and K2 and the selectors'
    K23 are their plain versions (the same call sites, on the card)."""

    def __enter__(self):
        import importlib

        self._saved = []
        for mod_name, attr, plain_mod, plain_attr in PLAIN_SWAPS:
            mod = importlib.import_module(mod_name)
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, getattr(importlib.import_module(plain_mod), plain_attr))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def plain_call(fn, *args):
    with plain_kernels():
        return fn(*args)


# --- phase 6: K5–K8 at the TopologySpreading shapes --------------------------------------


def time_spread_kernels(sched, err: dict) -> list:
    """K5–K8 and their plain versions on the inputs of a TopologySpreading
    cycle's first round: the live 8192-row snapshot (8192-pod tier), a
    512-pod spread batch (one class, padded to 4), one constraint, the
    batch's domain bucket; K8 with the commits of that round."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.framework.podbatch import batch_to_device, identity_classes
    from kubernetes_tpu_torch.kernels import spread as K
    from kubernetes_tpu_torch.kernels.auction import auction_resolve_commit
    from kubernetes_tpu_torch.kernels.filter_score import filter_score_planes
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine
    from kubernetes_tpu_torch.kernels.topk import topk_rows

    dev = sched.device
    fw = sched._framework()
    snap = sched.encoder.to_device(force_full=True)
    pods = [spread_pod(i, "tspread", ts0=2e6) for i in range(512)]
    batch = sched.compiler.compile(pods, pad_to=512)
    class_of, reps = identity_classes(batch)
    rep_rows = np.full(4, reps[0], dtype=np.int64)
    rep_rows[: len(reps)] = reps
    dbatch = batch_to_device(batch, dev)
    rep = dbatch.take(torch.from_numpy(rep_rows).to(dev))
    dyn = DynamicState(requested=snap.requested.clone(),
                       non_zero=snap.non_zero_requested.clone())
    idx = next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == "PodTopologySpread")
    plug, weight = fw.plugins[idx].plugin, float(fw.plugins[idx].weight)
    aux = fw.prepare(rep, snap, dyn)[idx]
    live = frozenset({"PodTopologySpread"})
    fs_plan, comb_plan = fw.kernel_plans(live)
    bit = fs_plan.dynamic_bits["PodTopologySpread"]
    full = (1 << len(fw.filter_names)) - 1
    bits, raw = filter_score_planes(rep, snap, dyn, *fw.static_inputs(rep, snap, dyn),
                                    fs_plan)
    seeded = bits.clone()
    K.spread_filter_bits(aux, bits, bit)
    total, _ = normalize_combine(bits, full, raw, comb_plan)
    base_total = total.clone()
    K.spread_score_combine(aux, bits, full, total, weight)
    cv, ci = topk_rows(total, 512)
    class_t = torch.from_numpy(class_of.astype(np.int64)).to(dev)
    b = 512
    pos_of = torch.arange(b, device=dev)
    # the coupled component's head: the first pod of the order
    unres = torch.zeros(b, dtype=torch.bool, device=dev)
    unres[0] = True
    nom = torch.zeros(b, dtype=torch.long, device=dev)
    nom_ok = torch.zeros(b, dtype=torch.bool, device=dev)
    commit, choice = auction_resolve_commit(
        cv, ci, class_t, pos_of, unres, nom, nom_ok, dbatch.request, dbatch.non_zero,
        dyn.requested.clone(), dyn.non_zero.clone())

    # the kernels against their plain versions on these inputs
    match_sched = plug._selector_vs_pods(rep, snap.pod_label_keys, snap.pod_label_vals,
                                         snap.pod_ns, snap.numeric) & snap.pod_valid[None, None, :]
    d = aux.hard_counts.shape[-1] - 1
    a5 = (match_sched, snap.pod_node, aux.dom_val, aux.counted_hard, aux.counted_soft, d)
    k5, p5 = K.spread_prepare_counts(*a5), K.spread_prepare_counts_plain(*a5)
    err["spread_prepare_counts"] = max(err["spread_prepare_counts"], require_equal(
        "spread_prepare_counts (TopologySpreading)",
        [("hard", k5[0], p5[0]), ("soft", k5[1], p5[1]), ("present", k5[2], p5[2])]))
    pb = seeded.clone()
    K.spread_filter_bits_plain(aux, pb, bit)
    err["spread_filter_bits"] = max(err["spread_filter_bits"], require_equal(
        "spread_filter_bits (TopologySpreading)", [("bits", bits, pb)]))
    pt = base_total.clone()
    K.spread_score_combine_plain(aux, bits, full, pt, weight)
    err["spread_score_combine"] = max(err["spread_score_combine"], require_equal(
        "spread_score_combine (TopologySpreading)", [("total", total, pt)]))
    ka, pa = plug.engine_copy(aux), plug.engine_copy(aux)
    K.spread_update_classes(ka, commit, choice, class_t)
    K.spread_update_classes_plain(pa, commit, choice, class_t)
    err["spread_update_classes"] = max(err["spread_update_classes"], require_equal(
        "spread_update_classes (TopologySpreading)",
        [("hard", ka.hard_counts, pa.hard_counts), ("soft", ka.soft_counts, pa.soft_counts)]))
    commits = int(commit.sum())
    if commits != 1:
        fail(f"spread timing inputs: expected the head's one commit, got {commits}")

    c, cc, d1 = aux.hard_counts.shape
    n, p = snap.num_nodes, snap.num_pods
    n_match = int(match_sched.sum())
    work_bits, work_total = bits.clone(), total.clone()
    work_aux = plug.engine_copy(aux)
    rows = []

    def row(name, symbol, fn, plain_fn, n_bytes, n_ops, device_fn=None, less=None):
        # device_fn: what the device time is taken on, when not fn; less: the
        # call it begins with, taken off when the queued-events fallback
        # timed the two together
        least, bound_by = bound_ms(n_bytes, n_ops)
        ms = device_ms(device_fn or fn, symbol)
        if less is not None and MS_SOURCE[0] != "profiler":
            ms -= queued_device_ms(less)
        rows.append({
            "name": name, "route": "cuda", "source": "kubernetes_tpu_torch/csrc/spread.cu",
            "replaces": SPREAD_REPLACES[name], "launches": None, "max_abs_err": err[name],
            "ms": ms, "ms_source": MS_SOURCE[0], "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
            "bound_ms": least, "bound_by": bound_by, "library_ms": None,
            "bytes": n_bytes, "ops": n_ops,
            "shape": {"C": c, "Cc": cc, "D+1": d1, "N": n, "P": p, "B": b}})

    # Each input counts at the width the kernel reads it and only where this
    # run's data makes the function touch it.
    # K5: the match plane, dom_val and counted_hard read once (the node pass
    # reads them all); pod_node for the pods some row matches, counted_soft
    # at their nodes; three tables written; per matching (row, pod) one
    # gather and up to two atomics, per (row, node) one compare
    matched = match_sched.any(dim=1) & (snap.pod_node >= 0)[None, :]  # [C, P]
    m_row, m_pod = torch.nonzero(matched, as_tuple=True)
    hit_nodes = torch.zeros((c, n), dtype=torch.bool, device=dev)
    hit_nodes[m_row, snap.pod_node.long().clamp(0, n - 1)[m_pod]] = True
    row("spread_prepare_counts", "spread_prepare_kernel",
        lambda: K.spread_prepare_counts(*a5), lambda: K.spread_prepare_counts_plain(*a5),
        nbytes(match_sched, aux.dom_val, aux.counted_hard) + 4 * int(matched.any(dim=0).sum())
        + int(hit_nodes.sum()) + 9 * c * cc * d1, 4 * n_match + c * cc * n)
    # K6 on the plane as K1 seeded it, as the path hands it over: each timed
    # call copies it in first and only the kernel's device time counts
    # (k6_work on that plane); ms_filtered on a plane it already filtered
    # (no word changes); one device activity a call
    def reseed():
        work_bits.copy_(seeded)

    def seeded_k6():
        reseed()
        K.spread_filter_bits(aux, work_bits, bit)

    row("spread_filter_bits", "spread_filter_kernel",
        lambda: K.spread_filter_bits(aux, work_bits, bit),
        lambda: K.spread_filter_bits_plain(aux, seeded.clone(), bit),
        *KW.k6_work(aux, seeded, bit), device_fn=seeded_k6, less=reseed)
    rows[-1]["ms_filtered"] = device_ms(lambda: K.spread_filter_bits(aux, work_bits, bit),
                                        "spread_filter_kernel")
    one_device_activity("spread_filter_bits (TopologySpreading, C = 4)",
                        lambda: K.spread_filter_bits(aux, work_bits, bit),
                        "spread_filter_kernel", "spread_filter_bits")
    # K7 (k7_work), one device activity a call
    row("spread_score_combine", "spread_score_kernel",
        lambda: K.spread_score_combine(aux, bits, full, work_total, weight),
        lambda: K.spread_score_combine_plain(aux, bits, full, work_total.clone(), weight),
        *k7_work(aux, bits, full))
    one_device_activity("spread_score_combine (TopologySpreading)",
                        lambda: K.spread_score_combine(aux, bits, full, work_total, weight),
                        "spread_score_kernel", "spread_score_combine")
    # K8 (k8_work) with the auction's own int64 class_of; one kernel node a
    # call through the plugin's hook (no cast beside it)
    row("spread_update_classes", "spread_update_kernel",
        lambda: K.spread_update_classes(work_aux, commit, choice, class_t),
        lambda: K.spread_update_classes_plain(work_aux, commit, choice, class_t),
        *KW.k8_work(aux, commit, choice, class_t))
    one_device_activity("spread_update_classes (TopologySpreading, C = 4, int64 class_of)",
                        lambda: plug.update_batch_classes(work_aux, commit, choice, class_t),
                        "spread_update_kernel", "spread_update_classes")
    return rows


_CU = {}


def _driver() -> dict:
    """The CUDA driver API (libcuda) calls that read a graph's kernel nodes,
    typed, by name (None where the driver lacks one: then the check names
    no kernel, and fails)."""
    import ctypes

    if not _CU:
        cu = ctypes.CDLL("libcuda.so.1")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        for name, args in (("cuGraphGetNodes", [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)]),
                           ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)]),
                           ("cuGraphKernelNodeGetParams_v2", [vp, ctypes.c_void_p]),
                           ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), vp]),
                           ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), vp])):
            fn = getattr(cu, name, None)
            if fn is not None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _CU[name] = fn
    return _CU


def graph_nodes(call, calls: int) -> list:
    """``calls`` calls captured into a CUDA graph (``torch.cuda.graph``,
    relaxed mode, the graph kept and never run), then the graph's nodes
    read through the driver API: → [(node type, kernel name or None)], in
    the graph's order.  A call that synchronizes or reads the card on the
    host breaks the capture, and raises."""
    import ctypes

    import torch

    class KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                    ("args", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = _driver()
    call()  # built, loaded and launched once outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            call()
    try:
        handle = ctypes.c_void_p(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        cu["cuGraphGetNodes"](handle, None, ctypes.byref(count))
        nodes = (ctypes.c_void_p * max(count.value, 1))()
        cu["cuGraphGetNodes"](handle, nodes, ctypes.byref(count))
        out = []
        for k in range(count.value):
            kind = ctypes.c_int(-1)
            cu["cuGraphNodeGetType"](nodes[k], ctypes.byref(kind))
            name, got, params = None, ctypes.c_char_p(), KernelParams()
            if kind.value == 0 \
                    and cu["cuGraphKernelNodeGetParams_v2"](nodes[k], ctypes.byref(params)) == 0:
                if params.func and cu["cuFuncGetName"] \
                        and cu["cuFuncGetName"](ctypes.byref(got), params.func) == 0:
                    name = got.value.decode()
                elif params.kern and cu["cuKernelGetName"] \
                        and cu["cuKernelGetName"](ctypes.byref(got), params.kern) == 0:
                    name = got.value.decode()
            out.append((kind.value, name))  # kind 0: CU_GRAPH_NODE_TYPE_KERNEL
        return out
    finally:
        graph.reset()


def one_device_activity(label: str, call, symbol: str, key: str, calls: int = 3,
                        host_ops: bool = False) -> list:
    """One launch a call, proven without the profiler: ``calls`` calls
    captured in a CUDA graph (``graph_nodes``) raise the wrapper's count
    ``key`` by exactly ``calls``, and the graph holds exactly ``calls``
    nodes, each a kernel node of the kernel ``symbol`` (its mangled name
    holds it) — no torch op, copy or memset on the card beside it.  Fails
    otherwise.  With ``host_ops``, one more call under the profiler (host
    activities only) → the torch ops the call ran on the host."""
    from kubernetes_tpu_torch.kernels import LAUNCHES

    before = LAUNCHES[key]
    nodes = graph_nodes(call, calls)
    launched = LAUNCHES[key] - before - 1  # the warm-up call launched once too
    names = [nm for kind, nm in nodes]
    if launched != calls:
        fail(f"{label}: {launched} launches in {calls} calls")
    if len(nodes) != calls or any(kind != 0 for kind, _ in nodes) \
            or any(nm is None or symbol not in nm for nm in names):
        fail(f"{label}: the graph of {calls} calls holds {nodes}, not {calls} kernel nodes "
             f"of {symbol}")
    log(f"  {label}: {calls} calls, {calls} launches, a graph of {calls} kernel nodes, all "
        f"{sorted(set(names))}")
    if not host_ops:
        return []
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA and e.key.startswith("aten::")})


SPREAD_REPLACES = {
    "spread_prepare_counts": "kubernetes_tpu/plugins/podtopologyspread.py:73",
    "spread_filter_bits": "kubernetes_tpu/plugins/podtopologyspread.py:166",
    "spread_score_combine": "kubernetes_tpu/plugins/podtopologyspread.py:186",
    "spread_update_classes": "kubernetes_tpu/plugins/podtopologyspread.py:341",
}


IPA_REPLACES = {
    "ipa_prepare": "kubernetes_tpu/plugins/interpodaffinity.py:197",
    "ipa_filter_bits": "kubernetes_tpu/plugins/interpodaffinity.py:337",
    "ipa_score_combine": "kubernetes_tpu/plugins/interpodaffinity.py:368",
    "ipa_update_classes": "kubernetes_tpu/plugins/interpodaffinity.py:676",
}


# --- phase 6: K9–K12 at the SchedulingPreferredPodAffinity shapes ---------------------------


def time_ipa_kernels(sched, err: dict) -> list:
    """K9–K12 and their plain versions on the inputs of a
    SchedulingPreferredPodAffinity cycle's first round: the live 8192-row
    snapshot and pod tier, a 512-pod batch of the measured template (one
    class, padded to 4), its host match matrix, planes over the hostname
    bucket; K12 with the commit of that round (the component's head)."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.framework.podbatch import batch_to_device, identity_classes
    from kubernetes_tpu_torch.kernels import interpodaffinity as K
    from kubernetes_tpu_torch.kernels.auction import auction_resolve_commit
    from kubernetes_tpu_torch.kernels.filter_score import filter_score_planes
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine
    from kubernetes_tpu_torch.kernels.topk import topk_rows
    from kubernetes_tpu_torch.scheduler import _host_aux_take

    dev = sched.device
    fw = sched._framework()
    snap = sched.encoder.to_device(force_full=True)
    pods = [affinity_pod("preferred", i, "sched-1", ts0=2e6) for i in range(512)]
    batch = sched.compiler.compile(pods, pad_to=512)
    class_of, reps = identity_classes(batch)
    rep_rows = np.full(4, reps[0], dtype=np.int64)
    rep_rows[: len(reps)] = reps
    dbatch = batch_to_device(batch, dev)
    rep = dbatch.take(torch.from_numpy(rep_rows).to(dev))
    host = fw.host_prepare(batch, sched.snapshot, sched.encoder,
                           namespace_labels=sched.namespace_labels)
    rep_host = _host_aux_take(fw, host, rep_rows)
    dyn = DynamicState(requested=snap.requested.clone(),
                       non_zero=snap.non_zero_requested.clone())
    idx = next(i for i, pw in enumerate(fw.plugins) if pw.plugin.name == "InterPodAffinity")
    plug, weight = fw.plugins[idx].plugin, float(fw.plugins[idx].weight)
    aux = fw.prepare(rep, snap, dyn, rep_host)[idx]
    live = frozenset({"InterPodAffinity"})
    fs_plan, comb_plan = fw.kernel_plans(live)
    bit = fs_plan.dynamic_bits["InterPodAffinity"]
    full = (1 << len(fw.filter_names)) - 1
    bits, raw = filter_score_planes(rep, snap, dyn, *fw.static_inputs(rep, snap, dyn),
                                    fs_plan)
    seeded = bits.clone()
    K.ipa_filter_bits(aux, bits, bit)
    total, _ = normalize_combine(bits, full, raw, comb_plan)
    base_total = total.clone()
    K.ipa_score_combine(aux, bits, full, total, weight)
    cv, ci = topk_rows(total, 512)
    class_t = torch.from_numpy(class_of.astype(np.int64)).to(dev)
    b = 512
    pos_of = torch.arange(b, device=dev)
    unres = torch.zeros(b, dtype=torch.bool, device=dev)
    unres[0] = True  # the coupled component's head
    nom = torch.zeros(b, dtype=torch.long, device=dev)
    nom_ok = torch.zeros(b, dtype=torch.bool, device=dev)
    commit, choice = auction_resolve_commit(
        cv, ci, class_t, pos_of, unres, nom, nom_ok, dbatch.request, dbatch.non_zero,
        dyn.requested.clone(), dyn.non_zero.clone())
    if int(commit.sum()) != 1:
        fail(f"affinity timing inputs: expected the head's one commit, got {int(commit.sum())}")

    # the kernels against their plain versions on these inputs
    d = aux.depth
    planes = plug._use_planes(rep, snap)
    match = plug._match_vs(rep.pref_affinity, snap.pod_label_keys, snap.pod_label_vals,
                           snap.pod_ns, snap.numeric)
    a9 = (match, snap.pod_node, snap.pod_valid, aux.dom_paff, d, planes)
    match_g = torch.as_tensor(rep_host["InterPodAffinity"]["match"]).to(dev)
    e9 = (match_g, snap.aff_counts, snap.aff_slot, snap.aff_valid, snap.aff_kind,
          snap.aff_weight, snap.node_topo, plug.hard_weight)
    k9, p9 = K.ipa_prepare_counts(*a9), K.ipa_prepare_counts_plain(*a9)
    k9e, p9e = K.ipa_existing_planes(*e9), K.ipa_existing_planes_plain(*e9)
    err["ipa_prepare"] = max(err["ipa_prepare"], require_equal(
        "ipa_prepare (SchedulingPreferredPodAffinity)",
        [("counts", k9[0], p9[0]), ("total", k9[1], p9[1]), ("block", k9e[0], p9e[0]),
         ("score_static", k9e[1], p9e[1])]))
    pb = seeded.clone()
    K.ipa_filter_bits_plain(aux, pb, bit)
    err["ipa_filter_bits"] = max(err["ipa_filter_bits"], require_equal(
        "ipa_filter_bits (SchedulingPreferredPodAffinity)", [("bits", bits, pb)]))
    pt = base_total.clone()
    K.ipa_score_combine_plain(aux, bits, full, pt, weight)
    err["ipa_score_combine"] = max(err["ipa_score_combine"], require_equal(
        "ipa_score_combine (SchedulingPreferredPodAffinity)", [("total", total, pt)]))
    ka, pa = plug.engine_copy(aux), plug.engine_copy(aux)
    K.ipa_update_classes(ka, commit, choice, class_t)
    K.ipa_update_classes_plain(pa, commit, choice, class_t)
    err["ipa_update_classes"] = max(err["ipa_update_classes"], require_equal(
        "ipa_update_classes (SchedulingPreferredPodAffinity)",
        [(f, getattr(ka, f), getattr(pa, f)) for f in IPA_MUTABLE]))
    if not bool((ka.score_dyn != 0).any()):
        fail("affinity timing inputs: the head's commit moved no score")

    c, t, n = aux.dom_paff.shape
    p, g_n = snap.num_pods, snap.aff_valid.shape[0]
    work_bits, work_total = bits.clone(), total.clone()
    work_aux = plug.engine_copy(aux)
    rows = []

    def row(name, symbol, fn, plain_fn, n_bytes, n_ops):
        least, bound_by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "kubernetes_tpu_torch/csrc/interpodaffinity.cu",
            "replaces": IPA_REPLACES[name], "launches": None, "max_abs_err": err[name],
            "ms": device_ms(fn, symbol), "ms_source": MS_SOURCE[0], "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
            "bound_ms": least, "bound_by": bound_by, "library_ms": None,
            "bytes": n_bytes, "ops": n_ops,
            "shape": {"C": c, "T": t, "D": d, "N": n, "P": p, "G": g_n, "B": b,
                      "planes": planes}})

    # Each input counts once, at the width the kernel reads it, and only
    # where this run's data makes the function touch it; each output once.
    # K9: the match plane and pod_valid whole; pod_node and the node's domain
    # for each matching placed pod; dom and the planes for the gather; for the
    # existing pass, the host match matrix and the group scalars whole, the
    # node_topo column and the count at each node's domain of every matched
    # group, and the block and score planes written.
    placed = match & snap.pod_valid[None, None, :] & (snap.pod_node >= 0)[None, None, :]
    n_placed = int(placed.sum())
    matched_g = int(match_g.any(dim=1).sum())
    k9_bytes = (nbytes(match, snap.pod_valid) + 8 * n_placed + 4 * c
                + (2 * 4 * c * t * n if planes else 4 * c * t * (d + 1))
                + nbytes(match_g) + 13 * g_n + matched_g * n * 8 + c * n * 5)
    k9_ops = 2 * n_placed + (c * t * n if planes else 0) + 3 * c * n * matched_g
    row("ipa_prepare", "ipa_",
        lambda: (K.ipa_prepare_counts(*a9), K.ipa_existing_planes(*e9)),
        lambda: (K.ipa_prepare_counts_plain(*a9), K.ipa_existing_planes_plain(*e9)),
        k9_bytes, k9_ops)
    # K10 (no required term in this batch): kernel_work.k10_work on the plane
    # as K1 seeded it
    row("ipa_filter_bits", "ipa_filter_kernel",
        lambda: K.ipa_filter_bits(aux, work_bits, bit),
        lambda: K.ipa_filter_bits_plain(aux, work_bits.clone(), bit),
        *KW.k10_work(aux, seeded, bit))
    # K11 and K12: kernel_work.py's k11_work / k12_work (the bytes and
    # operations each must move and do on these inputs)
    row("ipa_score_combine", "ipa_score_kernel",
        lambda: K.ipa_score_combine(aux, bits, full, work_total, weight),
        lambda: K.ipa_score_combine_plain(aux, bits, full, work_total.clone(), weight),
        *KW.k11_work(aux, bits, full))
    row("ipa_update_classes", "ipa_update_kernel",
        lambda: K.ipa_update_classes(work_aux, commit, choice, class_t),
        lambda: K.ipa_update_classes_plain(work_aux, commit, choice, class_t),
        *KW.k12_work(aux, commit, choice, class_t))
    return rows


# --- phase 2c: K20–K23 vs plain (the gang slice's kernels) --------------------------

GANG_KERNELS = ("gang_all_or_nothing", "cosched_score_into", "diag_pack", "selector_match")
GANG_SOURCES = {"gang_all_or_nothing": "kubernetes_tpu_torch/csrc/gang.cu",
                "cosched_score_into": "kubernetes_tpu_torch/csrc/cosched.cu",
                "diag_pack": "kubernetes_tpu_torch/csrc/diag_pack.cu",
                "selector_match": "kubernetes_tpu_torch/csrc/selector_match.cu"}
GANG_REPLACES = {"gang_all_or_nothing": "kubernetes_tpu/gang/device.py:17",
                 "cosched_score_into": "kubernetes_tpu/gang/coscheduling.py:100",
                 "diag_pack": "kubernetes_tpu/framework/runtime.py:237",
                 "selector_match": "kubernetes_tpu/state/selectors.py:299"}
GANG_SYMBOLS = {"gang_all_or_nothing": "gang_all_or_nothing_kernel",
                "cosched_score_into": "cosched_score_into_kernel",
                "diag_pack": "diag_pack_kernel", "selector_match": "selector_match_kernel"}
SLICE_LABEL = "tpu.kubernetes.io/slice"
POD_GROUP_LABEL = "pod-group.scheduling/name"


def selector_case(dev):
    """Compiled label and node selectors of every operator (NaN and absent
    keys, empty terms, match_all / match_none, a duplicate) and label sets,
    as the plugins hand them to K23: the compiled arrays on the card."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.framework.podbatch import _field_to_device
    from kubernetes_tpu_torch.state.dictionary import Dictionary
    from kubernetes_tpu_torch.state.selectors import (
        compile_label_selectors,
        compile_node_selectors,
    )

    E, NE = v1.LabelSelectorRequirement, v1.NodeSelectorRequirement
    LS, NS, T = v1.LabelSelector, v1.NodeSelector, v1.NodeSelectorTerm
    labels = [
        LS(match_labels={"zone": "z1"}),
        LS(match_expressions=[E(key="zone", operator="NotIn", values=["z1", "z9"])]),
        LS(match_expressions=[E(key="disk", operator="Exists")]),
        LS(match_expressions=[E(key="disk", operator="DoesNotExist")]),
        LS(match_expressions=[E(key="gen", operator="Gt", values=["5"])]),
        LS(match_expressions=[E(key="gen", operator="Lt", values=["5"])]),
        LS(match_expressions=[E(key="gen", operator="Gt", values=["nan"])]),
        LS(match_expressions=[E(key="absent", operator="NotIn", values=["a"]),
                              E(key="absent", operator="Lt", values=["100"])]),
        LS(match_expressions=[E(key="rack", operator="In", values=["r1", "r7", "r8"]),
                              E(key="zone", operator="NotIn", values=["z2"])]),
        LS(), None, LS(match_labels={"zone": "z1"}),
    ]
    nodes_sel = [
        NS(node_selector_terms=[T(match_expressions=[NE(key="zone", operator="In",
                                                        values=["z1", "z3"])])]),
        NS(node_selector_terms=[T(match_expressions=[NE(key="gen", operator="Gt",
                                                        values=["5"])]),
                                T(match_expressions=[NE(key="disk",
                                                        operator="DoesNotExist")])]),
        NS(node_selector_terms=[T(match_expressions=[]),
                                T(match_expressions=[NE(key="rack", operator="Exists"),
                                                     NE(key="gen", operator="Lt",
                                                        values=["0"])])]),
        NS(node_selector_terms=[T(match_expressions=[])]),
        None,
    ]
    dic = Dictionary()
    cs = compile_label_selectors(labels, dic)
    cns = compile_node_selectors(nodes_sel, dic)
    rng = np.random.default_rng(SEED + 23)
    o, width = 8192, 8
    keys = np.full((o, width), -1, np.int32)
    vals = np.full((o, width), -1, np.int32)
    pool = {"zone": ["z1", "z2", "z3"], "disk": ["ssd", "hdd"], "gen": ["3", "12", "abc", "-4", "7"],
            "rack": ["r1", "r7", "r2"], "note": ["x"]}
    for i in range(o):
        ks = [k for k in pool if rng.random() < 0.6]
        for j, k in enumerate(sorted(ks)):
            keys[i, j] = dic.intern(k)
            vals[i, j] = dic.intern(pool[k][int(rng.integers(len(pool[k])))])
    numeric = dic.numeric_table(min_size=64)
    vals_num = np.where(vals >= 0, numeric[np.clip(vals, 0, numeric.shape[0] - 1)],
                        np.nan).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (_field_to_device(cs, dev), _field_to_device(cns, dev), t(keys), t(vals),
            t(vals_num), t(numeric))


def check_gang_kernels(dev) -> dict:
    """K20–K23 against their plain versions, exactly equal, at GangBasic's
    shapes (B = 512, gangs of 8; C = 512 anchored rows over N = 8192 nodes
    in slices of 8) and on edge inputs: K20 with no gangs, one incomplete
    gang, B = 1024; K21 with an anchor slice that holds no feasible node,
    anchor −2, one row; K22 at 31 filters, on class-gathered rows and on
    one row per pod; K23 with every operator, NaN and absent keys, empty
    terms, match_all / match_none, a side-table and a vals_num form, the
    numeric path off, at the path's node-affinity shape, and on
    ``kernel_work.K23_CASES`` (U = 512 distinct rows, O = 8190, 20 label
    columns) and unaligned label views."""
    import torch

    from kubernetes_tpu_torch.kernels import cosched as KC
    from kubernetes_tpu_torch.kernels import diag as KD
    from kubernetes_tpu_torch.kernels import gang as KG
    from kubernetes_tpu_torch.kernels import selectors as KS

    gen = torch.Generator().manual_seed(SEED + 20)
    err = {k: 0.0 for k in GANG_KERNELS}

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    # K20
    cases = []
    for b in (512, 1024):
        node_row = ints(0, 8192, b)
        node_row[torch.rand(b, generator=gen) < 0.02] = -1
        seg = torch.arange(b, dtype=torch.int32) // 8
        seg[torch.rand(b, generator=gen) < 0.1] = -1
        cases.append((f"B = {b}, gangs of 8", node_row, seg))
    cases.append(("no gangs", ints(-1, 50, 512), torch.full((512,), -1, dtype=torch.int32)))
    one = ints(0, 100, 64)
    one[3] = -1
    seg = torch.full((64,), -1, dtype=torch.int32)
    seg[:8] = 0
    cases.append(("one incomplete gang", one, seg))
    for what, node_row, seg in cases:
        a = (node_row.to(dev), seg.to(dev))
        got, want = KG.gang_all_or_nothing(*a), KG.gang_all_or_nothing_plain(*a)
        torch.cuda.synchronize()
        err["gang_all_or_nothing"] = max(err["gang_all_or_nothing"], require_equal(
            f"gang_all_or_nothing ({what})", [("node_row", got, want)]))
    if not bool((got[:8] == -1).all()):
        fail("gang_all_or_nothing check: the incomplete gang was not withdrawn")

    # K21
    n, full = 8192, (1 << 12) - 1
    slice_dom = (torch.arange(n, dtype=torch.int32) // 8)
    slice_dom[5000:] = -1  # rows past the cluster's nodes: no slice
    for what, c in (("C = 512 anchored rows", 512), ("one row", 1)):
        anchor = ints(0, 625, c)
        anchor[torch.rand(c, generator=gen) < 0.2] = -2
        bits = torch.where(torch.rand((c, n), generator=gen) < 0.7, full,
                           ints(0, full, c, n))
        if c > 1:
            anchor[0] = 3  # its slice holds no feasible node
            bits[0, 24:32] = 0
            anchor[1] = -2
        total = torch.where(bits == full, torch.randint(0, 400, (c, n), generator=gen).float(),
                            float("-inf"))
        a = [x.to(dev) for x in (bits, total, anchor, slice_dom)]
        got = KC.cosched_score_into(a[0], full, a[1].clone(), a[2], a[3], 1.0)
        want = KC.cosched_score_into_plain(a[0], full, a[1].clone(), a[2], a[3], 1.0)
        torch.cuda.synchronize()
        err["cosched_score_into"] = max(err["cosched_score_into"], require_equal(
            f"cosched_score_into ({what})", [("total", got, want)]))
        if c > 1 and not torch.equal(got[0], a[1][0]):
            fail("cosched_score_into check: a row with no feasible anchor node scored")

    # K22
    nf = 12
    for what, c, b, nbits in (("C = B = 512", 512, 512, nf), ("class rows, C = 4", 4, 512, nf),
                              ("31 filters", 64, 64, 31)):
        plane = torch.randint(0, 1 << nbits, (c, n), generator=gen, dtype=torch.int32)
        plane[0] &= ~(1 << 3)  # filter 3 fails every node of row 0
        class_of = None if c == b else torch.randint(0, c, (b,), generator=gen)
        node_row = ints(-1, n, b)
        a = (plane.to(dev), nbits, None if class_of is None else class_of.to(dev),
             node_row.to(dev), 17)
        got, want = KD.diag_pack(*a), KD.diag_pack_plain(*a)
        torch.cuda.synchronize()
        err["diag_pack"] = max(err["diag_pack"], require_equal(
            f"diag_pack ({what})", [("packed", got, want)]))

    # K23
    cs, cns, keys, vals, vals_num, numeric = selector_case(dev)
    u, s_ = cs.req_key.shape
    lab = (cs.req_key.reshape(u, 1, s_), cs.req_op.reshape(u, 1, s_),
           cs.req_vals.reshape(u, 1, s_, -1), cs.req_num.reshape(u, 1, s_))
    node = (cns.req_key, cns.req_op, cns.req_vals, cns.req_num)
    sel_cases = [
        ("label selectors, side table", lab, (None, None, cs.match_none), None, True,
         cs.index),
        ("label selectors, vals_num", lab, (None, None, cs.match_none), vals_num, True,
         cs.index),
        ("label selectors, numeric off", lab, (None, None, cs.match_none), None, False,
         cs.index),
        ("node selectors", node, (cns.term_valid, cns.match_all, None), vals_num, True,
         cns.index),
        ("requirement rows, no index", lab, (None, None, None), None, True, None),
    ]
    calls = [(what, (*req, *opt, keys, vals),
              dict(vals_num=vn, numeric=numeric, has_numeric=has_num, index=index))
             for what, req, opt, vn, has_num, index in sel_cases]
    # the hot cases: kernel_work.K23_CASES (U = 512 distinct rows, O = 8190,
    # labels past 16 columns in shared memory, ...) and the path's shape on
    # label views 4 bytes off 16-byte alignment (the scalar label loads)
    for label in KW.K23_CASES:
        args, kw = KW.k23_inputs(label, dev)
        calls.append((label, args, kw))
    args, kw = KW.k23_inputs("O = 8190", dev)
    off = [torch.zeros(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
           for x in args[7:9]]
    for v_, x in zip(off, args[7:9]):
        v_.copy_(x)
    if off[0].data_ptr() % 16 == 0 or not off[0].is_contiguous():
        fail("selector_match check: the label view is aligned or not contiguous")
    calls.append(("unaligned label views, O = 8190", (*args[:7], *off), kw))
    for what, args, kw in calls:
        got = KS.selector_match(*args, **kw)
        want = KS.selector_match_plain(*args, **kw)
        torch.cuda.synchronize()
        err["selector_match"] = max(err["selector_match"], require_equal(
            f"selector_match ({what})", [("match", got, want)]))
        if not 0 < int(got.sum()) < got.numel():
            fail(f"selector_match check ({what}): a degenerate matrix")
    log(f"gang-slice kernels vs plain: all equal ({', '.join(GANG_KERNELS)})")
    return err


# --- phase 4c: GangBasic -------------------------------------------------------------

GANG_TARGETS = {
    "gang_all_or_nothing": ("kubernetes_tpu_torch.scheduler", "gang_all_or_nothing", None),
    "diag_pack": ("kubernetes_tpu_torch.scheduler", "diag_pack", None),
    # the full auction's planes (C = B), not a scan row
    "cosched_score_into": ("kubernetes_tpu_torch.gang.coscheduling", "cosched_score_into",
                           lambda a: a[0].shape[0] > 1),
    "selector_match": ("kubernetes_tpu_torch.state.selectors", "selector_match", None),
}


def gang_key(name, args):
    """K23's latest call of each mode (label / node selectors); the others'
    latest call."""
    if name == "selector_match":
        return (name, "node" if args[4] is not None else "label")
    return (name, 0)


def gang_slices(store):
    """(gangs, gangs split over more than one slice, partly bound gangs)."""
    nodes = {n.metadata.name: n.metadata.labels.get(SLICE_LABEL)
             for n in store.list("Node")[0]}
    members = {}
    for p in store.list("Pod")[0]:
        g = p.metadata.labels.get(POD_GROUP_LABEL)
        if g:
            members.setdefault(g, []).append(p.spec.node_name)
    split = sum(1 for ns in members.values()
                if all(ns) and len({nodes[x] for x in ns}) > 1)
    partial = sum(1 for ns in members.values() if any(ns) and not all(ns))
    return len(members), split, partial


def gang_cluster(dev_name: str, n_nodes: int, n_gangs: int, batch_size: int, clock=None):
    """GangBasic's cluster (perf/workloads.py: node_sliced, podgroup_template,
    pod_gang; gangs of 8): → (store, synchronous scheduler) with every
    object created."""
    from kubernetes_tpu_torch.perf.workloads import node_sliced, pod_gang, podgroup_template
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    store = ObjectStore()
    kw = {} if clock is None else {"clock": clock, "batch_wait": 0}
    sched = TorchScheduler(store, batch_size=batch_size, device=dev_name, **kw)
    sched.presize(n_nodes, n_gangs * 8)
    nt, pt, gt = node_sliced(), pod_gang(), podgroup_template()
    for i in range(n_nodes):
        n = nt(i)
        n.metadata.creation_timestamp = 0.0
        store.create("Node", n)
    for j in range(n_gangs):
        kind, pg = gt(j)
        pg.metadata.creation_timestamp = 1.0
        store.create(kind, pg)
    for i in range(n_gangs * 8):
        p = pt(i)
        p.metadata.creation_timestamp = 2.0 + i
        store.create("Pod", p)
    return store, sched


def gang_basic_sync(kargs: KernelArgs, out_dir: Path, dev_name: str = "cuda") -> dict:
    """GangBasic/5000Nodes through TorchScheduler(batch_size=512), synchronous:
    5000 sliced nodes, 600 PodGroups of 8, 4800 gang pods (one per host),
    launch counts zeroed just before the run and read just after.  Every pod
    bound, no gang partly bound, no node oversubscribed, K1–K4 and K20–K23
    launched; then one profiled cycle of 64 fresh gangs on the hosts the
    first 64 gangs freed."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.workloads import pod_gang, podgroup_template

    fresh_heap()
    t0 = time.perf_counter()
    store, sched = gang_cluster(dev_name, 5000, 600, 512)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw, kargs:
        stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    check_bound_and_fit("GangBasic", store)
    gangs, split, partial = gang_slices(store)
    if stats.scheduled != 4800 or partial:
        fail(f"GangBasic: scheduled {stats.scheduled} of 4800, {partial} gangs partly bound")
    for k in PATH_KERNELS[:4] + GANG_KERNELS:
        if launches[k] <= 0:
            fail(f"GangBasic: kernel {k} never launched on the main path")
    if any(launches[k] for k in DRA_KERNELS):
        fail(f"GangBasic: a DynamicResources kernel launched on claim-free gangs ({launches})")
    d = sched.gangs
    rec = {"nodes": 5000, "gangs": gangs, "pods": 4800, "batch_size": 512,
           "setup_s": setup_s, "wall_s": wall, "pods_per_s": 4800 / wall,
           "gangs_per_s": gangs / wall, "gangs_split_over_slices": split,
           "partly_bound_gangs": partial, "cycles": sched.cycles,
           "rounds_per_cycle": sched.rounds_total / max(sched.cycles, 1),
           "phase_wall_s": dict(sched.phase_wall), "launches": launches,
           "gang_attempts": dict(d.attempts), "gang_timeouts": d.timeouts,
           "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds}
    log(f"GangBasic/5000Nodes synchronous: 4800 pods in {gangs} gangs bound in {wall:.3f} s "
        f"= {rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} gangs/s; "
        f"{sched.cycles} cycles, {rec['rounds_per_cycle']:.2f} rounds/cycle; partly bound "
        f"gangs {partial}; gangs over more than one slice {split}; gang attempts "
        f"{d.attempts}; launches {launches}")
    # the profiled cycle: the first 64 gangs' pods deleted, 64 new gangs
    for i in range(512):
        store.delete("Pod", "default", pod_gang()(i).metadata.name)
    for j in range(64):
        kind, pg = podgroup_template()(700 + j)
        store.create(kind, pg)
    rec["profile"] = profile_cycle(sched, out_dir, "GangBasic", lambda i: pod_gang()(5600 + i),
                                   "profile_gang_cycle.txt")
    return {"record": rec, "sched": sched}


def gang_basic_harness(dev_name: str = "cuda") -> dict:
    """GangBasic/5000Nodes through the port's perf harness
    (``run_workload``: pipelined, depth 3, B = 512): every measured pod
    bound, no gang partly bound, K1–K4 and K20–K23 launched inside the
    measured window, GangThroughput and TimeToFullSlice."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    seen = {}

    def inspect(store, sched, _ctrl):
        torch.cuda.synchronize()
        seen["launches"] = dict(kernels.LAUNCHES)
        check_bound_and_fit("GangBasic harness", store)
        seen["gangs"] = gang_slices(store)
        seen["phase_wall_s"] = dict(sched.phase_wall)

    fresh_heap()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    items = run_workload(build_workload("GangBasic", "5000Nodes"), device=dev_name,
                         inspect=inspect)
    wall = time.perf_counter() - t
    by = {it.labels["Metric"]: it.data for it in items}
    win = by["KernelLaunchesInWindow"]
    gangs, split, partial = seen["gangs"]
    if partial or by["GangThroughput"]["Gangs"] != 600:
        fail(f"GangBasic harness: {by['GangThroughput']['Gangs']:.0f} of 600 gangs whole, "
             f"{partial} partly bound")
    for k in PATH_KERNELS[:4] + GANG_KERNELS:
        if win[k] <= 0:
            fail(f"GangBasic harness: kernel {k} never launched in the measured window")
    if by["KernelBuildsInWindow"]["Count"] != 0:
        fail("GangBasic harness: a kernel was built inside the measured window")
    att, tfs = by["scheduler_scheduling_attempt_duration_seconds"], by["TimeToFullSlice"]
    rec = {"items": json.loads(data_items_to_json(items)), "wall_s": wall,
           "pods_per_s": by["SchedulingThroughput"]["Average"],
           "gangs_per_s": by["GangThroughput"]["Average"],
           "time_to_full_slice_p50_s": tfs["Perc50"], "time_to_full_slice_p99_s": tfs["Perc99"],
           "attempt_p50_ms": att["Perc50"] * 1e3, "attempt_p99_ms": att["Perc99"] * 1e3,
           "gangs_split_over_slices": split, "partly_bound_gangs": partial,
           "window_launches": win, "window_phase_wall_s": by["PhaseWallBreakdown"],
           "launches": seen["launches"]}
    log(f"GangBasic/5000Nodes via perf.harness.run_workload (pipelined): "
        f"{rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} gangs/s, time to full "
        f"slice p50 {tfs['Perc50'] * 1e3:.1f} ms, p99 {tfs['Perc99'] * 1e3:.1f} ms; attempt "
        f"p50 {rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms; partly "
        f"bound gangs {partial}; gangs over more than one slice {split}; window launches "
        + ", ".join(f"{k} {win[k]:.0f}" for k in PATH_KERNELS[:4] + GANG_KERNELS))
    return rec


def gang_bindings(device: str):
    """GangBasic/500Nodes (500 sliced nodes, 60 gangs of 8, B = 64) through
    the synchronous scheduler: → (bindings, launches)."""
    from kubernetes_tpu_torch import kernels

    store, sched = gang_cluster(device, 500, 60, 64, clock=_FixedClock())
    kernels.reset_launches()
    sched.run_until_idle()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return ({p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]},
            dict(kernels.LAUNCHES))


class _FixedClock:
    """A clock the caller moves: deadlines in the gang paths and backoffs in
    the preemption paths reproduce."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def gang_starved(device: str):
    """1020 sliced nodes (room for 127 gangs and half of one more) and 130
    gangs of 8 at B = 20, so every other gang splits over two batches and
    holds its first half at Permit until the second half places; the last
    split gang's second half finds no node.  A fake clock moves 5 s a
    cycle: that gang times out after its 60 s and requeues atomically; no
    gang is ever partly bound.  → (bindings, PodGroup phases, held binds
    per cycle, queue counts per cycle, partly bound gangs per cycle, the
    directory's counters, launches)."""
    from kubernetes_tpu_torch import kernels

    clock = _FixedClock()
    store, sched = gang_cluster(device, 1020, 130, 20, clock=clock)
    kernels.reset_launches()
    held, active, partial = [], [], []
    for _ in range(120):
        s = sched.schedule_cycle()
        held.append(s.waiting)
        active.append(sched.queue.pending_count())
        partial.append(gang_slices(store)[2])
        clock.t += 5.0
        if s.attempted == 0 and s.waiting == 0 and sched.queue.pending_count()[0] == 0:
            break
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    d = sched.gangs
    return ({p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]},
            {g.metadata.name: g.phase for g in store.list("PodGroup")[0]},
            held, active, partial, (dict(d.attempts), d.timeouts), dict(kernels.LAUNCHES))


def time_gang_kernels(last_calls: dict, err: dict) -> list:
    """K20–K23 timed on the arguments of their latest calls on the
    GangBasic/5000Nodes synchronous run, each held once more against its
    plain version there; the bound from what those inputs need."""
    import torch

    from kubernetes_tpu_torch.kernels import cosched as KC
    from kubernetes_tpu_torch.kernels import diag as KD
    from kubernetes_tpu_torch.kernels import gang as KG
    from kubernetes_tpu_torch.kernels import selectors as KS

    rows_out = []

    def last(key):
        got = last_calls.get(key)
        if got is None:
            fail(f"kernel timing: no recorded path call of {key}")
        return got

    def row(name, fn, plain_fn, n_bytes, n_ops, shape, library_fn=None):
        least, bound_by = bound_ms(n_bytes, n_ops)
        ms, libs, source = ms_one_method(fn, GANG_SYMBOLS[name],
                                         *([library_fn] if library_fn else []))
        rows_out.append({
            "name": name, "route": "cuda", "source": GANG_SOURCES[name],
            "replaces": GANG_REPLACES[name], "launches": None, "max_abs_err": err[name],
            "ms": ms, "ms_source": source,
            "call_ms": time_ms(fn), "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
            "bound_ms": least, "bound_by": bound_by,
            "library_ms": libs[0] if libs else None,
            "bytes": n_bytes, "ops": n_ops, "shape": shape})

    # K20: node_row and gang_seg read, the rows written
    (node_row, seg), _ = last(("gang_all_or_nothing", 0))
    got, want = KG.gang_all_or_nothing(node_row, seg), KG.gang_all_or_nothing_plain(node_row, seg)
    err["gang_all_or_nothing"] = max(err["gang_all_or_nothing"], require_equal(
        "gang_all_or_nothing (path shapes)", [("node_row", got, want)]))
    b = node_row.numel()
    member = seg >= 0
    segl = torch.where(member, seg, b).long()
    missed = (member & (node_row < 0)).float()
    acc = torch.zeros(b + 1, device=node_row.device)
    row("gang_all_or_nothing", lambda: KG.gang_all_or_nothing(node_row, seg),
        lambda: KG.gang_all_or_nothing_plain(node_row, seg), 3 * 4 * b, 2 * b,
        {"B": b, "gangs": int(seg.max()) + 1, "members": int(member.sum())},
        library_fn=lambda: acc.zero_().index_add_(0, segl, missed)[segl])

    # K21: the anchors and the slice plane once, then bits + total read and
    # the total written where a row's anchor slice holds the node
    (bits, full, total, anchor, slice_dom, weight), _ = last(("cosched_score_into", 0))
    base = total.clone()
    got = KC.cosched_score_into(bits, full, base.clone(), anchor, slice_dom, weight)
    want = KC.cosched_score_into_plain(bits, full, base.clone(), anchor, slice_dom, weight)
    err["cosched_score_into"] = max(err["cosched_score_into"], require_equal(
        "cosched_score_into (path shapes)", [("total", got, want)]))
    c, n = bits.shape
    match = int(((anchor[:, None] >= 0) & (slice_dom[None, :] == anchor[:, None])).sum())
    work = base.clone()
    row("cosched_score_into", lambda: KC.cosched_score_into(bits, full, work, anchor,
                                                            slice_dom, weight),
        lambda: KC.cosched_score_into_plain(bits, full, base.clone(), anchor, slice_dom,
                                            weight),
        4 * (c + n) + 12 * match, match,
        {"C": c, "N": n, "anchored_rows": int((anchor >= 0).sum()), "matches": match})

    # K22: the plane once, node_row (and class_of) read, [3, B] written
    (plane, nf, class_of, node_row2, rounds), _ = last(("diag_pack", 0))
    got = KD.diag_pack(plane, nf, class_of, node_row2, rounds)
    want = KD.diag_pack_plain(plane, nf, class_of, node_row2, rounds)
    err["diag_pack"] = max(err["diag_pack"], require_equal(
        "diag_pack (path shapes)", [("packed", got, want)]))
    b2 = node_row2.numel()
    row("diag_pack", lambda: KD.diag_pack(plane, nf, class_of, node_row2, rounds),
        lambda: KD.diag_pack_plain(plane, nf, class_of, node_row2, rounds),
        nbytes(plane) + 4 * b2 * (4 + (class_of is not None)), plane.numel(),
        {"C": plane.shape[0], "N": plane.shape[1], "B": b2, "filters": nf,
         "classes": class_of is not None})

    # K23: the node-affinity filter's node-selector call (the wider mode);
    # kernel_work.k23_work: label sets, selectors, the numbers and the index
    # read once, [B, O] written once; one key compare per (row, term,
    # requirement, object, label column).  One kernel node a call.
    args, kw = last(("selector_match", "node"))
    got, want = KS.selector_match(*args, **kw), KS.selector_match_plain(*args, **kw)
    err["selector_match"] = max(err["selector_match"], require_equal(
        "selector_match (path shapes)", [("match", got, want)]))
    req_key, keys = args[0], args[7]
    u, t, s_ = req_key.shape
    o, lab = keys.shape
    row("selector_match", lambda: KS.selector_match(*args, **kw),
        lambda: KS.selector_match_plain(*args, **kw), *KW.k23_work(*args, **kw),
        {"U": u, "T": t, "S": s_, "O": o, "L": lab, "B": got.shape[0],
         "has_numeric": bool(kw.get("has_numeric", True))})
    one_device_activity("selector_match (path shapes)",
                        lambda: KS.selector_match(*args, **kw), "selector_match_kernel",
                        "selector_match")
    for rr in rows_out:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms"
            + (f", library {rr['library_ms']:.5f} ms" if rr["library_ms"] is not None else "")
            + f"; {rr['shape']}")
    return rows_out


# --- K24–K26 and DeviceClaimGang -------------------------------------------------------

DRA_KERNELS = ("dra_filter_bits", "dra_score_into", "dra_take")
DRA_SOURCE = "kubernetes_tpu_torch/csrc/dra.cu"
DRA_REPLACES = {"dra_filter_bits": "kubernetes_tpu/dra/plugin.py:109",
                "dra_score_into": "kubernetes_tpu/dra/plugin.py:137",
                "dra_take": "kubernetes_tpu/dra/plugin.py:157"}
DRA_SYMBOLS = {k: k + "_kernel" for k in DRA_KERNELS}
DRA_PLUGIN = "kubernetes_tpu_torch.dra.plugin"
# the full auction's planes (C = B), not a scan row
DRA_TARGETS = {
    "dra_filter_bits": (DRA_PLUGIN, "dra_filter_bits", lambda a: a[0].shape[0] > 1),
    "dra_score_into": (DRA_PLUGIN, "dra_score_into", lambda a: a[0].shape[0] > 1),
    "dra_take": (DRA_PLUGIN, "dra_take", lambda a: a[1].numel() > 1),
}


def dra_case(gen, c: int, n: int):
    """A claim batch's inputs on the CPU: demand 0–8 (a fifth of the rows
    0), a fifth of the rows pinned (some to nodes without inventory), a
    tenth blocked; node inventories of 0–16 chips (the first three and the
    rows past 5000 empty) with allocations up to three past the capacity
    (negative free, a slice that shrank under allocated claims)."""
    import torch

    demand = torch.randint(0, 9, (c,), generator=gen, dtype=torch.int32)
    demand[torch.rand(c, generator=gen) < 0.2] = 0
    pinned = torch.where(torch.rand(c, generator=gen) < 0.2,
                         torch.randint(0, n, (c,), generator=gen), -1).to(torch.int32)
    blocked = torch.rand(c, generator=gen) < 0.1
    cap = torch.tensor([0, 2, 4, 8, 16], dtype=torch.int32)[
        torch.randint(0, 5, (n,), generator=gen)]
    cap[:3] = 0
    cap[5000:] = 0
    alloc = torch.minimum(torch.randint(0, 18, (n,), generator=gen, dtype=torch.int32),
                          cap + 3)
    alloc[cap == 0] = 0
    return demand, pinned, blocked, cap, (cap - alloc).to(torch.int32)


def check_dra_kernels(dev) -> dict:
    """K24–K26 against their plain versions on the card, exactly: K24 and
    K25 at C = 1, 64 and 512 rows over N = 8192 nodes (pinned, blocked and
    zero-demand rows, nodes without inventory, negative free; K25 with
    weights 1 and 2 over a bit plane with infeasible entries), K25 over the
    full floor grid (capacity 1–256 × used 0–capacity: every score equals
    the integer floor(100 · used / capacity), the pins (61, 61) → 100 and
    (53, 100) → 53); K26 as an auction round (a commit mask, many pods on
    one node), at class rows, and as a scan step (one pod, at a node and
    not placed)."""
    import torch

    from kubernetes_tpu_torch.kernels import dra as KR

    gen = torch.Generator().manual_seed(SEED + 24)
    err = {k: 0.0 for k in DRA_KERNELS}
    n = 8192
    for c in (1, 64, 512):
        demand, pinned, blocked, cap, free = (t.to(dev) for t in dra_case(gen, c, n))
        bit, full = 11, (1 << 16) - 1
        bits = torch.where(torch.rand((c, n), generator=gen) < 0.7, full,
                           torch.randint(0, full, (c, n), generator=gen,
                                         dtype=torch.int32)).to(torch.int32).to(dev)
        got = KR.dra_filter_bits(bits.clone(), bit, demand, pinned, blocked, free)
        want = KR.dra_filter_bits_plain(bits.clone(), bit, demand, pinned, blocked, free)
        torch.cuda.synchronize()
        err["dra_filter_bits"] = max(err["dra_filter_bits"], require_equal(
            f"dra_filter_bits (C = {c})", [("bits", got, want)]))
        for w in (1.0, 2.0):
            total = torch.where(bits == full, torch.randint(0, 400, (c, n), generator=gen)
                                .float().to(dev), float("-inf"))
            got = KR.dra_score_into(bits, full, total.clone(), cap, free, demand, w)
            want = KR.dra_score_into_plain(bits, full, total.clone(), cap, free, demand, w)
            torch.cuda.synchronize()
            err["dra_score_into"] = max(err["dra_score_into"], require_equal(
                f"dra_score_into (C = {c}, weight {w})", [("total", got, want)]))
        if c == 512 and torch.equal(got, total):
            fail("dra_score_into check: the score added nothing")
        # K26: an auction round (class rows = pods), then at class rows
        commit = (torch.rand(c, generator=gen) < 0.6).to(dev)
        choice = torch.randint(0, n, (c,), generator=gen, dtype=torch.int32).to(dev)
        choice[: c // 4] = 7  # many commits on one node
        got = KR.dra_take(free.clone(), choice, demand, commit=commit)
        want = KR.dra_take_plain(free.clone(), choice, demand, commit=commit)
        cls = torch.randint(0, max(c // 8, 1), (c,), generator=gen,
                            dtype=torch.int32).to(dev)
        got2 = KR.dra_take(free.clone(), choice, demand, commit=commit, class_of=cls)
        want2 = KR.dra_take_plain(free.clone(), choice, demand, commit=commit, class_of=cls)
        torch.cuda.synchronize()
        err["dra_take"] = max(err["dra_take"], require_equal(
            f"dra_take (C = {c})", [("free", got, want), ("free, class rows", got2, want2)]))
    for node in (5, -1, n - 1):  # the scan's step
        at = torch.tensor([node], dtype=torch.int32, device=dev)
        got = KR.dra_take(free.clone(), at, demand[3:4])
        want = KR.dra_take_plain(free.clone(), at, demand[3:4])
        torch.cuda.synchronize()
        err["dra_take"] = max(err["dra_take"], require_equal(
            f"dra_take (scan step at {node})", [("free", got, want)]))
    # the floor grid: one row of demand 1, one node per (used, capacity)
    pairs = [(u, cp) for cp in range(1, 257) for u in range(cp + 1)]
    used = torch.tensor([u for u, _ in pairs], dtype=torch.int32)
    cap = torch.tensor([cp for _, cp in pairs], dtype=torch.int32)
    free = (cap - used + 1).to(torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    a = [x.to(dev) for x in (torch.ones((1, len(pairs)), dtype=torch.int32),
                             torch.zeros((1, len(pairs))), cap, free, one)]
    got = KR.dra_score_into(a[0], 1, a[1].clone(), a[2], a[3], a[4], 1.0)
    want = KR.dra_score_into_plain(a[0], 1, a[1].clone(), a[2], a[3], a[4], 1.0)
    torch.cuda.synchronize()
    err["dra_score_into"] = max(err["dra_score_into"], require_equal(
        "dra_score_into (floor grid)", [("total", got, want)]))
    exact = (used.long() * 100 // cap.long()).float().to(dev)
    if not torch.equal(got[0], exact):
        fail("dra_score_into check: the floor grid differs from floor(100 · used / cap)")
    at = {p: k for k, p in enumerate(pairs)}
    if float(got[0, at[(61, 61)]]) != 100.0 or float(got[0, at[(53, 100)]]) != 53.0:
        fail("dra_score_into check: a floor pin moved")
    err["dra_score_into"] = max(err["dra_score_into"], score_cases_equal(dev))
    log(f"DRA kernels vs plain: all equal ({', '.join(DRA_KERNELS)}; floor grid of "
        f"{len(pairs)} pairs)")
    return err


def score_cases_equal(dev) -> float:
    """K25 against its plain version on CPU copies, bit for bit, one launch
    a call: kernel_work.K25_CASES (the DeviceClaimGang path's C = 64, C =
    512, C = 1, N = 8190, no feasible entry, random claims, the floor grid)
    and a bit plane off 16-byte boundaries; its plan against
    kernel_work.k25_plan; on the path, one kernel node a call."""
    import ctypes

    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import dra as KR
    from kubernetes_tpu_torch.kernels.build import load

    plan = load("dra").dra_score_plan
    plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    differ = [(c, n) for c in (0, 1, 4, 5, 64, 132, 512, 1024, 4096)
              for n in (1, 8190, 8192, 33152, 100000)
              if plan(c, n, out) != 0 or tuple(out) != KW.k25_plan(c, n)]
    if differ:
        fail(f"dra_score_plan differs from kernel_work.k25_plan at {differ[:4]}")
    cases = {label: KW.k25_inputs(label, dev) for label in KW.K25_CASES}
    a = list(cases["C = 64, path"])
    flat = torch.empty(a[0].numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = a[0].reshape(-1)
    a[0] = flat[1:].reshape(a[0].shape)
    cases["bits off 16 bytes"] = tuple(a)
    err = 0.0
    for name, (bits, full, total, cap, free, demand, weight) in cases.items():
        before = kernels.LAUNCHES["dra_score_into"]
        got = KR.dra_score_into(bits, full, total.clone(), cap, free, demand, weight)
        if kernels.LAUNCHES["dra_score_into"] - before != 1:
            fail(f"dra_score_into ({name}): not one launch")
        want = KR.dra_score_into_plain(bits.cpu(), full, total.cpu(), cap.cpu(), free.cpu(),
                                       demand.cpu(), weight)
        torch.cuda.synchronize()
        err = max(err, require_equal(f"dra_score_into ({name})", [("total", got.cpu(), want)]))
    bits, full, total, cap, free, demand, weight = cases["C = 64, path"]
    work = total.clone()
    one_device_activity("dra_score_into (path shapes)",
                        lambda: KR.dra_score_into(bits, full, work, cap, free, demand, weight),
                        "dra_score_into_kernel", "dra_score_into")
    log(f"dra_score_into: equal on {len(cases)} cases, one launch each; its plan equal to "
        "kernel_work.k25_plan")
    return err


def claim_gang_cluster(dev_name: str, size: str, batch_size: int, scale: float = 1.0,
                       clock=None):
    """DeviceClaimGang's cluster from the port's workload (perf/workloads.py:
    sliced nodes, the warm host, the device class, one 4-chip ResourceSlice
    per host, the warm pool, the PodGroups, one 4-chip claim per member and
    the members, one per host): → (store, synchronous scheduler, workload)
    with every object created (node indices across the createNodes ops, as
    the harness counts them)."""
    from kubernetes_tpu_torch.perf.workloads import build_workload
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    w = build_workload("DeviceClaimGang", size, scale=scale)
    store = ObjectStore()
    kw = {} if clock is None else {"clock": clock, "batch_wait": 0}
    sched = TorchScheduler(store, batch_size=batch_size, device=dev_name, **kw)
    sched.presize(sum(op.count for op in w.ops if op.opcode == "createNodes"),
                  sum(op.count for op in w.ops if op.opcode == "createPods"))
    node_idx = 0
    for op in w.ops:
        if op.opcode == "createNodes":
            for _ in range(op.count):
                nd = op.node_template(node_idx)
                node_idx += 1
                nd.metadata.creation_timestamp = 0.0
                store.create("Node", nd)
        elif op.opcode == "createObjects":
            for j in range(op.count):
                kind, obj = op.object_template(j)
                obj.metadata.creation_timestamp = 1.0
                store.create(kind, obj)
        else:
            for i in range(op.count):
                p = op.pod_template(i)
                p.metadata.creation_timestamp = 2.0 + i
                store.create("Pod", p)
    return store, sched, w


def claim_checks(what: str, store) -> dict:
    """Every gang pod bound (no node oversubscribed), every gang claim
    Reserved for its pod with 4 named chips of that pod's node in its slice's
    pool, no chip held by two claims, no gang partly bound or split over
    slices; → the counts."""
    check_bound_and_fit(what, store)
    nodes = {nd.metadata.name: nd.metadata.labels.get(SLICE_LABEL)
             for nd in store.list("Node")[0]}
    pods = {p.metadata.uid: p for p in store.list("Pod")[0]}
    held, reserved = [], 0
    for c in store.list("ResourceClaim")[0]:
        held += list(c.allocated_devices)
        if not c.metadata.name.startswith("gangclaim-"):
            continue
        pod = pods.get(c.reserved_for)
        node = pod.spec.node_name if pod is not None else None
        want = [f"{nodes.get(node)}/{node}-chip{k}" for k in range(4)]
        if c.state != "Reserved" or node is None or c.allocated_node != node \
                or list(c.allocated_devices) != want:
            fail(f"{what}: claim {c.metadata.name} is {c.state} on {c.allocated_node!r} "
                 f"with {c.allocated_devices} for {c.reserved_for!r}")
        reserved += 1
    if len(held) != len(set(held)):
        fail(f"{what}: {len(held) - len(set(held))} chips held by two claims")
    gangs, split, partial = gang_slices(store)
    if split or partial:
        fail(f"{what}: {split} gangs split over slices, {partial} partly bound")
    return {"claims_reserved": reserved, "chips_held": len(held), "gangs": gangs}


def claim_gang_sync(kargs: KernelArgs, out_dir: Path, dev_name: str = "cuda") -> dict:
    """DeviceClaimGang/5000Nodes through TorchScheduler(batch_size=64),
    synchronous, launch counts zeroed just before the run and read just
    after: all 4800 pods bound, 4800 claims Reserved with 4 named chips of
    their pod's node, no chip twice, no gang split or partly bound, K1–K4,
    K20–K23 and K24–K26 launched; pods/s, gangs/s, claims/s; then one
    profiled cycle of 8 more gangs on the 200 hosts left free."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.workloads import (
        dra_claim_template,
        pod_claim_gang,
        podgroup_template,
    )

    fresh_heap()
    t0 = time.perf_counter()
    store, sched, w = claim_gang_cluster(dev_name, "5000Nodes", 64)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw, kargs:
        stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    if stats.scheduled != 4800:
        fail(f"DeviceClaimGang: scheduled {stats.scheduled} of 4800")
    got = claim_checks("DeviceClaimGang", store)
    if got["claims_reserved"] != 4800:
        fail(f"DeviceClaimGang: {got['claims_reserved']} of 4800 claims Reserved")
    for k in PATH_KERNELS[:4] + GANG_KERNELS + DRA_KERNELS:
        if launches[k] <= 0:
            fail(f"DeviceClaimGang: kernel {k} never launched on the main path")
    series = dict(sched.dra_plugin.claims_allocated)
    if series["allocated"] != 4800:
        fail(f"DeviceClaimGang: the claim series counted {series}")
    rec = {"nodes": 5000, "gangs": got["gangs"], "pods": 4800, "batch_size": 64,
           "setup_s": setup_s, "wall_s": wall, "pods_per_s": 4800 / wall,
           "gangs_per_s": got["gangs"] / wall, "claims_per_s": series["allocated"] / wall,
           "claims_reserved": got["claims_reserved"], "chips_held": got["chips_held"],
           "claim_series": series, "cycles": sched.cycles,
           "rounds_per_cycle": sched.rounds_total / max(sched.cycles, 1),
           "phase_wall_s": dict(sched.phase_wall), "launches": launches,
           "gang_attempts": dict(sched.gangs.attempts),
           "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds}
    log(f"DeviceClaimGang/5000Nodes synchronous (B = 64): 4800 pods in {got['gangs']} gangs "
        f"bound in {wall:.3f} s = {rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} "
        f"gangs/s, {rec['claims_per_s']:.1f} claims/s; {sched.cycles} cycles, "
        f"{rec['rounds_per_cycle']:.2f} rounds/cycle; {got['claims_reserved']} claims "
        f"Reserved, {got['chips_held']} chips held once each, no gang split; launches "
        + ", ".join(f"{k} {launches[k]}" for k in PATH_KERNELS[:4] + GANG_KERNELS
                    + DRA_KERNELS))
    # the profiled cycle: 8 more gangs (64 pods, their claims) on hosts 4800–4999
    for j in range(600, 608):
        kind, pg = podgroup_template()(j)
        store.create(kind, pg)
    for i in range(4800, 4864):
        kind, claim = dra_claim_template(i)
        store.create(kind, claim)
    rec["profile"] = profile_cycle(sched, out_dir, "DeviceClaimGang",
                                   lambda i: pod_claim_gang()(4800 + i),
                                   "profile_claim_gang_cycle.txt", n_pods=64)
    return {"record": rec, "sched": sched}


def claim_gang_harness(dev_name: str = "cuda") -> dict:
    """DeviceClaimGang/5000Nodes through the port's perf harness
    (``run_workload``: pipelined, depth 3, the suite's B = 512): every
    measured pod bound, every claim Reserved on its pod's node, no chip
    twice, no gang split or partly bound, K1–K4, K20–K23 and K24–K26
    launched inside the measured window; pods/s, GangThroughput,
    TimeToFullSlice p50 / p99 and ClaimsAllocated."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    seen = {}

    def inspect(store, sched, _ctrl):
        torch.cuda.synchronize()
        seen["launches"] = dict(kernels.LAUNCHES)
        seen["claims"] = claim_checks("DeviceClaimGang harness", store)
        seen["phase_wall_s"] = dict(sched.phase_wall)

    fresh_heap()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    w = build_workload("DeviceClaimGang", "5000Nodes")
    items = run_workload(w, device=dev_name, inspect=inspect)
    wall = time.perf_counter() - t
    by = {it.labels["Metric"]: it.data for it in items}
    win = by["KernelLaunchesInWindow"]
    if by["GangThroughput"]["Gangs"] != 600 or by["ClaimsAllocated"]["Count"] != 4800:
        fail(f"DeviceClaimGang harness: {by['GangThroughput']['Gangs']:.0f} of 600 gangs, "
             f"{by['ClaimsAllocated']['Count']:.0f} of 4800 claims in the window")
    if seen["claims"]["claims_reserved"] != 4800:
        fail(f"DeviceClaimGang harness: {seen['claims']['claims_reserved']} claims Reserved")
    for k in PATH_KERNELS[:4] + GANG_KERNELS + DRA_KERNELS:
        if win[k] <= 0:
            fail(f"DeviceClaimGang harness: kernel {k} never launched in the measured window")
    if by["KernelBuildsInWindow"]["Count"] != 0:
        fail("DeviceClaimGang harness: a kernel was built inside the measured window")
    att, tfs = by["scheduler_scheduling_attempt_duration_seconds"], by["TimeToFullSlice"]
    rec = {"items": json.loads(data_items_to_json(items)), "wall_s": wall,
           "batch_size": w.batch_size,
           "pods_per_s": by["SchedulingThroughput"]["Average"],
           "gangs_per_s": by["GangThroughput"]["Average"],
           "claims_per_s": by["ClaimsAllocated"]["PerSecond"],
           "time_to_full_slice_p50_s": tfs["Perc50"], "time_to_full_slice_p99_s": tfs["Perc99"],
           "attempt_p50_ms": att["Perc50"] * 1e3, "attempt_p99_ms": att["Perc99"] * 1e3,
           "window_launches": win, "window_phase_wall_s": by["PhaseWallBreakdown"],
           "launches": seen["launches"], **seen["claims"]}
    log(f"DeviceClaimGang/5000Nodes via perf.harness.run_workload (pipelined, B = "
        f"{w.batch_size}): {rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} gangs/s, "
        f"{rec['claims_per_s']:.1f} claims/s; time to full slice p50 "
        f"{tfs['Perc50'] * 1e3:.1f} ms, p99 {tfs['Perc99'] * 1e3:.1f} ms; attempt p50 "
        f"{rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms; window launches "
        + ", ".join(f"{k} {win[k]:.0f}" for k in PATH_KERNELS[:4] + GANG_KERNELS
                    + DRA_KERNELS))
    return rec


def claim_gang_bindings(device: str):
    """DeviceClaimGang/500Nodes cut to a quarter (125 sliced nodes, 15 gangs
    of 8 with their claims, B = 64) through the synchronous scheduler: →
    (bindings, claims, the claim series, launches)."""
    from kubernetes_tpu_torch import kernels

    store, sched, _w = claim_gang_cluster(device, "500Nodes", 64, scale=0.25,
                                          clock=_FixedClock())
    kernels.reset_launches()
    sched.run_until_idle()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    claims = {c.metadata.name: (c.state, c.allocated_node, list(c.allocated_devices),
                                c.reserved_for) for c in store.list("ResourceClaim")[0]}
    return ({p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}, claims,
            dict(sched.dra_plugin.claims_allocated), dict(kernels.LAUNCHES))


def time_dra_kernels(last_calls: dict, err: dict) -> list:
    """K24–K26 timed on the arguments of their latest calls on the
    DeviceClaimGang/5000Nodes synchronous run, each held once more against
    its plain version there; the bound from what those inputs need."""
    import torch

    from kubernetes_tpu_torch.kernels import dra as KR

    rows_out = []

    def last(name):
        got = last_calls.get(name)
        if got is None:
            fail(f"kernel timing: no recorded path call of {name}")
        return got

    def row(name, fn, plain_fn, n_bytes, n_ops, shape, library_fn=None, queued=False):
        least, bound_by = bound_ms(n_bytes, n_ops)
        if queued:  # queued behind a spin kernel, its library call too
            ms, source = queued_device_ms(fn), "queued_events"
            libs = [queued_device_ms(library_fn)] if library_fn else []
        else:
            ms, libs, source = ms_one_method(fn, DRA_SYMBOLS[name],
                                             *([library_fn] if library_fn else []))
        rows_out.append({
            "name": name, "route": "cuda", "source": DRA_SOURCE,
            "replaces": DRA_REPLACES[name], "launches": None, "max_abs_err": err[name],
            "ms": ms, "ms_source": source,
            "call_ms": time_ms(fn), "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
            "bound_ms": least, "bound_by": bound_by,
            "library_ms": libs[0] if libs else None,
            "bytes": n_bytes, "ops": n_ops, "shape": shape})

    # K24: demand / pinned / blocked and free read once, the failing
    # entries' words read and written; four compares per entry
    (bits, bit, demand, pinned, blocked, free), _ = last("dra_filter_bits")
    base = bits.clone()
    got = KR.dra_filter_bits(base.clone(), bit, demand, pinned, blocked, free)
    want = KR.dra_filter_bits_plain(base.clone(), bit, demand, pinned, blocked, free)
    err["dra_filter_bits"] = max(err["dra_filter_bits"], require_equal(
        "dra_filter_bits (path shapes)", [("bits", got, want)]))
    c, n = bits.shape
    # the recorded plane is the one the call wrote: count the entries the
    # test fails (each written, whatever its bit held)
    n_fail = int((~KR.dra_filter_plane(demand, pinned, blocked, free)).sum())
    work = base.clone()
    row("dra_filter_bits", lambda: KR.dra_filter_bits(work, bit, demand, pinned, blocked,
                                                      free),
        lambda: KR.dra_filter_bits_plain(base.clone(), bit, demand, pinned, blocked, free),
        9 * c + 4 * n + 8 * n_fail, 4 * c * n,
        {"C": c, "N": n, "failing": n_fail, "demand_rows": int((demand > 0).sum())})

    # K25: kernel_work.k25_work (the bit plane read, the feasible entries'
    # totals read and written, cap / free and demand once; six float32
    # operations a scored entry)
    (bits2, full, total, cap, free2, demand2, weight), _ = last("dra_score_into")
    base = total.clone()
    got = KR.dra_score_into(bits2, full, base.clone(), cap, free2, demand2, weight)
    want = KR.dra_score_into_plain(bits2, full, base.clone(), cap, free2, demand2, weight)
    err["dra_score_into"] = max(err["dra_score_into"], require_equal(
        "dra_score_into (path shapes)", [("total", got, want)]))
    c2, n2 = bits2.shape
    feas = bits2 == full
    n_feas = int(feas.sum())
    n_scored = int((feas & (demand2[:, None] > 0) & (cap[None, :] > 0)).sum())
    work = base.clone()
    row("dra_score_into", lambda: KR.dra_score_into(bits2, full, work, cap, free2, demand2,
                                                    weight),
        lambda: KR.dra_score_into_plain(bits2, full, base.clone(), cap, free2, demand2,
                                        weight),
        *KW.k25_work(bits2, full, base, cap, free2, demand2, weight),
        {"C": c2, "N": n2, "feasible": n_feas, "scored": n_scored})

    # K26: commit, choice and demand read once, each committed pod's node
    # read and written; one subtraction a commit.  Library: index_add_ of
    # the committed pods' demands, the dead rows masked inside the timed
    # call (the same function on the kernel's inputs).  Both by queued
    # events: the profiler's reading of this sub-2 µs launch moved between
    # runs
    (free3, choice, demand3), kw = last("dra_take")
    commit, class_of = kw.get("commit"), kw.get("class_of")
    base = free3.clone()
    got = KR.dra_take(base.clone(), choice, demand3, commit=commit, class_of=class_of)
    want = KR.dra_take_plain(base.clone(), choice, demand3, commit=commit, class_of=class_of)
    err["dra_take"] = max(err["dra_take"], require_equal(
        "dra_take (path shapes)", [("free", got, want)]))
    b = choice.numel()
    n_commit = int((commit if commit is not None else choice >= 0).sum())
    work = base.clone()
    lib = base.clone()
    n_free = free3.shape[0]

    def library_take():
        ch = choice.reshape(-1).long()
        take = (ch >= 0) & (ch < n_free)
        if commit is not None:
            take = take & commit.reshape(-1)
        d = demand3.reshape(-1)
        d = d if class_of is None else d[class_of.long()]
        return lib.index_add_(0, torch.where(take, ch, 0), torch.where(take, -d, 0))
    row("dra_take", lambda: KR.dra_take(work, choice, demand3, commit=commit,
                                        class_of=class_of),
        lambda: KR.dra_take_plain(base.clone(), choice, demand3, commit=commit,
                                  class_of=class_of),
        b * (1 + 4 + 4) + 8 * n_commit, n_commit,
        {"B": b, "N": free3.numel(), "commits": n_commit},
        library_fn=library_take, queued=True)
    for rr in rows_out:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms"
            + (f", library {rr['library_ms']:.5f} ms" if rr["library_ms"] is not None else "")
            + f"; {rr['shape']}")
    return rows_out


# --- phase 4e: preemption (PreemptionBasic, K27–K29, K13's nominated bundle) -----------

PREEMPT_KERNELS = ("priority_prefix", "candidate_fit", "candidate_dense")
PREEMPT_SOURCE = "kubernetes_tpu_torch/csrc/preempt.cu"
PREEMPT_REPLACES = {"priority_prefix": "kubernetes_tpu/whatif/dryrun.py:56",
                    "candidate_fit": "kubernetes_tpu/whatif/dryrun.py:71",
                    "candidate_dense": "kubernetes_tpu/whatif/dryrun.py:75"}
PREEMPT_SYMBOLS = {k: k + "_kernel" for k in PREEMPT_KERNELS}
DRYRUN = "kubernetes_tpu_torch.whatif.dryrun"
PREEMPT_TARGETS = {k: (DRYRUN, k, None) for k in PREEMPT_KERNELS}
PREEMPT_LEVEL_CAP = 128


def preempt_case(gen, *, n=8192, p=32768, b=512, r=4, n_prio=128, dead=64):
    """The candidate mask's inputs on the CPU: 2^25-KiB (32Gi) nodes, the
    last ``dead`` of them dead; pods with odd-KiB memory requests near 1.6M
    (float32 sums round) over ``n_prio`` priorities, a twentieth unbound, a
    twentieth invalid; batch rows across the priorities (some above all),
    a tenth padding, a twentieth with a failing static bit."""
    import torch

    alloc = torch.zeros((n, r), dtype=torch.int32)
    alloc[:, 0] = 4000
    alloc[:, 1] = 1 << 25
    alloc[:, r - 1] = 110
    requested = (alloc.float() * torch.rand((n, r), generator=gen) * 0.98).to(torch.int32)
    node = torch.randint(0, n, (p,), generator=gen, dtype=torch.int32)
    node[torch.rand(p, generator=gen) < 0.05] = -1
    valid = torch.rand(p, generator=gen) >= 0.05
    prios = torch.arange(n_prio, dtype=torch.int32) * 3 - 40
    prio = prios[torch.randint(0, n_prio, (p,), generator=gen)]
    req = torch.zeros((p, r), dtype=torch.int32)
    req[:, 0] = torch.randint(100, 1000, (p,), generator=gen, dtype=torch.int32)
    req[:, 1] = torch.randint(700_000, 900_000, (p,), generator=gen, dtype=torch.int32) * 2 + 1
    req[:, r - 1] = 1
    bprio = prios[torch.randint(0, n_prio, (b,), generator=gen)] + 1
    bprio[: b // 16] = int(prios.max()) + 10
    breq = torch.zeros((b, r), dtype=torch.int32)
    breq[:, 0] = torch.randint(0, 3000, (b,), generator=gen, dtype=torch.int32)
    breq[:, 1] = torch.randint(0, 1 << 25, (b,), generator=gen, dtype=torch.int32)
    breq[:, r - 1] = 1
    rows_ok = torch.rand(b, generator=gen) >= 0.1
    bits = torch.where(torch.rand((b, n), generator=gen) < 0.05, 0b1011, 0b1111)
    bits = torch.where(rows_ok[:, None], bits, 0).to(torch.int32)
    bits[:, n - dead:] = 0
    return {"pod_valid": valid, "pod_node": node, "pod_priority": prio, "pod_request": req,
            "priority": bprio, "request": breq, "allocatable": alloc,
            "requested": requested, "static_bits": bits}


def _levels(prio, valid):
    import torch

    u = torch.unique(prio[valid])
    if u.numel() > PREEMPT_LEVEL_CAP:
        return None
    out = torch.full((PREEMPT_LEVEL_CAP,), 2 ** 31 - 1, dtype=torch.int32)
    out[: u.numel()] = u
    return out


def check_preempt_kernels(dev) -> dict:
    """K27–K29 and K13's nominated bundle against their plain versions,
    exactly (the plain versions run on CPU copies of the same inputs, whose
    index_add_ walks its index in order as the reference's scatter does):
    K27 + K28 at N = 8192, P = 32768, B = 512, R = 4 over 128 live levels
    with odd-KiB requests on 2^25-KiB nodes, unbound and invalid pods, dead
    nodes, padding rows and failing static bits, then with 64 batch rows
    asking exactly for one (node, threshold)'s float32 fit value and 64 for
    one ulp more; K29 at B = 64 over 300 priorities; K13 with a nominated
    bundle (no nz rows) beside two in-flight bundles, rows past N among
    them, at the path's sizes and at sizes that take several staging
    chunks, one launch a call."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.kernels import LAUNCHES
    from kubernetes_tpu_torch.kernels import preempt as KP
    from kubernetes_tpu_torch.kernels.prev_delta import prev_delta_apply, \
        prev_delta_apply_plain

    gen = torch.Generator().manual_seed(SEED + 27)
    err = {k: 0.0 for k in PREEMPT_KERNELS}
    err["prev_delta_apply (nominated)"] = 0.0
    c = preempt_case(gen)
    n = c["allocatable"].shape[0]
    lv = _levels(c["pod_priority"], c["pod_valid"] & (c["pod_node"] >= 0))
    if lv is None or int((lv < 2 ** 31 - 1).sum()) != PREEMPT_LEVEL_CAP:
        fail("preempt kernel check: the case does not hold 128 live levels")
    g = {k: v.to(dev) for k, v in c.items()}
    pod = ("pod_valid", "pod_node", "pod_priority", "pod_request")
    prefix, cnt = KP.priority_prefix(*(g[k] for k in pod), lv.to(dev), n)
    want_p, want_c = KP.priority_prefix_plain(*(c[k] for k in pod), lv, n)
    torch.cuda.synchronize()
    err["priority_prefix"] = require_equal("priority_prefix (128 levels)", [
        ("prefix", prefix.cpu(), want_p), ("prefix_cnt", cnt.cpu(), want_c)])
    err["priority_prefix"] = max(err["priority_prefix"], prefix_cases_equal(gen, dev))
    # the boundary rows: the port's float32 fit value for (node, threshold)
    # and one ulp above it
    b = c["priority"].shape[0]
    free = c["allocatable"].float() - c["requested"].float()
    nodes = torch.randint(0, n - 64, (64,), generator=gen)
    ths = torch.randint(1, PREEMPT_LEVEL_CAP, (64,), generator=gen)
    prio_b, req_b = c["priority"].clone(), c["request"].clone()
    for j in range(64):
        v = float(free[nodes[j], 1] + want_p[ths[j], nodes[j], 1])
        step = max(1, int(np.spacing(np.float32(v))))
        for row, val in ((2 * j, int(v)), (2 * j + 1, int(v) + step)):
            prio_b[row] = lv[ths[j]]
            req_b[row] = 0
            req_b[row, 1] = val
    c2 = dict(c, priority=prio_b, request=req_b)
    g2 = {k: v.to(dev) for k, v in c2.items()}
    side = ("priority", "request", "allocatable", "requested", "static_bits")
    for name, case, gcase in (("random", c, g), ("boundary", c2, g2)):
        got = KP.candidate_fit(prefix, cnt, lv.to(dev), *(gcase[k] for k in side), 0b1111)
        want = KP.candidate_fit_plain(want_p, want_c, lv, *(case[k] for k in side), 0b1111)
        torch.cuda.synchronize()
        err["candidate_fit"] = max(err["candidate_fit"], require_equal(
            f"candidate_fit ({name})", [("mask", got.cpu(), want)]))
        if not 0 < int(want.sum()) < int((case["static_bits"] == 0b1111).sum()):
            fail(f"candidate_fit check ({name}): the mask is all one way")
    hits = sum(bool(want[2 * j, nodes[j]]) and not bool(want[2 * j + 1, nodes[j]])
               for j in range(64) if bool(c2["static_bits"][2 * j, nodes[j]] == 0b1111)
               and float(want_c[ths[j], nodes[j]]) > 0)
    if hits < 16:
        fail(f"candidate_fit check: only {hits} boundary pairs split as the fit value says")
    # K29: more than 128 priorities, B = 64; then the tier's edge cases
    d = preempt_case(gen, b=64, n_prio=300)
    if _levels(d["pod_priority"], d["pod_valid"] & (d["pod_node"] >= 0)) is not None:
        fail("candidate_dense check: the case has at most 128 priorities")
    err["candidate_dense"] = dense_equal("300 priorities", d, dev)
    if not 0 < int(KP.candidate_dense_plain(*(d[k] for k in pod), *(d[k] for k in side),
                                            0b1111).sum()):
        fail("candidate_dense check: no pair passes")
    for name, case in dense_cases(gen).items():
        err["candidate_dense"] = max(err["candidate_dense"], dense_equal(name, case, dev))
    dense_single_launch({k: v.to(dev) for k, v in d.items()})
    # K13: the nominated rows (no nz rows) and two in-flight bundles, rows
    # past N (clipped to N - 1) among them; then bundles of odd sizes whose
    # rows take more than one staging chunk
    req = c["requested"].to(dev)
    nz = torch.randint(0, 1000, (n, 2), generator=gen, dtype=torch.int32).to(dev)
    for sizes in ((1024, 512, 512), (4099, 1023, 2045)):
        bundles = []
        for k_, m in enumerate(sizes):
            rows = torch.randint(-1, n + 3, (m,), generator=gen, dtype=torch.int32)
            breq = torch.randint(0, 5000, (m, 4), generator=gen, dtype=torch.int32)
            bnz = None if k_ == 0 else \
                torch.randint(0, 5000, (m, 2), generator=gen, dtype=torch.int32).to(dev)
            bundles.append((rows.to(dev), breq.to(dev), bnz))
        before = LAUNCHES["prev_delta_apply"]
        got = prev_delta_apply(req, nz, bundles)
        if LAUNCHES["prev_delta_apply"] - before != 1:
            fail(f"prev_delta_apply {sizes}: {LAUNCHES['prev_delta_apply'] - before} launches")
        want = prev_delta_apply_plain(req, nz, bundles)
        torch.cuda.synchronize()
        err["prev_delta_apply (nominated)"] = max(err["prev_delta_apply (nominated)"],
                                                  require_equal(
            f"prev_delta_apply (nominated + two in-flight bundles, {sizes})",
            [("requested", got[0], want[0]), ("non_zero", got[1], want[1])]))
    k28_plan_check()
    err["candidate_fit"] = max(err["candidate_fit"], fit_cases_equal(dev))
    k27_plan_check()
    a27 = KW.k27_inputs("path", dev)
    host = one_device_activity("priority_prefix (path shapes)",
                               lambda: KP.priority_prefix(*a27), "priority_prefix_kernel",
                               "priority_prefix", host_ops=True)
    if [k_ for k_ in host if not k_.startswith("aten::empty")]:
        fail(f"priority_prefix: torch ops beside the kernel on the host: {host}")
    log("preempt kernels vs plain: all equal (K27 + K28 at 128 levels with rounding sums, "
        f"{hits} boundary pairs split; K29 at 300 priorities and on {len(DENSE_CASES)} edge "
        "cases, one kernel a call and no sort; K13 with the nominated bundle)")
    return err


def prefix_cases_equal(gen, dev) -> float:
    """K27 against its plain version on CPU copies, bit for bit, one launch a
    call: kernel_work.K27_CASES (the path's two live levels, a hot node past
    a round, R = 16 over 128 levels in windows) and edge cases — N = 1000
    (not a multiple of the tile) and 999 (no 16-byte count rows), R = 5
    (scalar request rows), two live levels of 2 and no live level, a tier
    of 3001 rows whose node column starts 4 bytes past a boundary."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import preempt as KP

    pod = ("pod_valid", "pod_node", "pod_priority", "pod_request")
    cases = {label: KW.k27_inputs(label, dev) for label in KW.K27_CASES}
    for name, kw_ in (("N = 1000", dict(n=1000, p=6000)), ("N = 999", dict(n=999, p=6000)),
                      ("R = 5", dict(n=1000, p=5000, r=5)),
                      ("misaligned tier, P = 3001", dict(n=700, p=3001))):
        c = preempt_case(gen, b=8, **kw_)
        lv = _levels(c["pod_priority"], c["pod_valid"] & (c["pod_node"] >= 0))
        args = [c[k].to(dev) for k in pod]
        if name.startswith("misaligned"):
            flat = torch.empty(args[1].numel() + 1, dtype=torch.int32, device=dev)
            flat[1:] = args[1]
            args[1] = flat[1:]
        cases[name] = (*args, lv.to(dev), c["allocatable"].shape[0])
    c = preempt_case(gen, n=600, p=4000, b=8, n_prio=2)
    cases["no live level"] = (*(c[k].to(dev) for k in pod),
                              torch.full((128,), 2 ** 31 - 1, dtype=torch.int32, device=dev), 600)
    err = 0.0
    for name, a in cases.items():
        before = kernels.LAUNCHES["priority_prefix"]
        got = KP.priority_prefix(*a)
        if kernels.LAUNCHES["priority_prefix"] - before != 1:
            fail(f"priority_prefix ({name}): not one launch")
        want = KP.priority_prefix_plain(*[x.cpu() if isinstance(x, torch.Tensor) else x
                                          for x in a])
        torch.cuda.synchronize()
        err = max(err, require_equal(f"priority_prefix ({name})", [
            ("prefix", got[0].cpu(), want[0]), ("prefix_cnt", got[1].cpu(), want[1])]))
        if name != "no live level" and not float(want[1].max()) > 0:
            fail(f"priority_prefix ({name}): no pod counted")
    hot = cases["hot node"]
    if int(((hot[0] & (hot[1] == 7)).sum())) <= KP.PREFIX_CAP:
        fail("priority_prefix: the hot node holds no more pods than a round")
    if KW.k27_plan(16, 128)[0] >= 128:
        fail("priority_prefix: R = 16 over 128 levels takes no second window")
    log(f"priority_prefix: equal on {len(cases)} more cases, one launch each")
    return err


def fit_cases_equal(dev) -> float:
    """K28 against its plain version on CPU copies, bit for bit, one launch
    a call: kernel_work.K28_CASES (the path's two live levels, the check
    case's 128 levels with more distinct thresholds in a row group than
    slots, ulp-boundary rows, R = 4 and 16, N = 8190, static bits that
    mostly fail), B = 37 and N = 1000 (a part group and a part tile), R =
    5 (scalar threshold rows), and static bits off 16-byte boundaries; on
    the path, one kernel node a call."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import preempt as KP

    cases = {label: KW.k28_inputs(label, dev) for label in KW.K28_CASES}
    gen = torch.Generator().manual_seed(SEED + 28)
    c = preempt_case(gen, n=1000, p=6000, b=37, r=5, n_prio=20)
    lv = _levels(c["pod_priority"], c["pod_valid"] & (c["pod_node"] >= 0))
    pod = [c[k] for k in ("pod_valid", "pod_node", "pod_priority", "pod_request")]
    pre = KP.priority_prefix_plain(*pod, lv, 1000)
    side = [c[k] for k in ("priority", "request", "allocatable", "requested", "static_bits")]
    cases["B = 37, N = 1000, R = 5"] = tuple(x.to(dev) for x in (*pre, lv, *side)) + (0b1111,)
    a = list(cases["path"])
    flat = torch.empty(a[7].numel() + 1, dtype=torch.int32, device=dev)
    flat[1:] = a[7].reshape(-1)
    a[7] = flat[1:].reshape(a[7].shape)
    cases["static bits off 16 bytes"] = tuple(a)
    err = 0.0
    for name, a in cases.items():
        before = kernels.LAUNCHES["candidate_fit"]
        got = KP.candidate_fit(*a)
        if kernels.LAUNCHES["candidate_fit"] - before != 1:
            fail(f"candidate_fit ({name}): not one launch")
        want = KP.candidate_fit_plain(*[x.cpu() if isinstance(x, torch.Tensor) else x
                                        for x in a])
        torch.cuda.synchronize()
        err = max(err, require_equal(f"candidate_fit ({name})", [("mask", got.cpu(), want)]))
        if name != "static bits mostly fail" and not 0 < int(want.sum()) < want.numel():
            fail(f"candidate_fit ({name}): the mask is all one way")
    a = cases["path"]
    one_device_activity("candidate_fit (path shapes)", lambda: KP.candidate_fit(*a),
                        "candidate_fit_kernel", "candidate_fit")
    log(f"candidate_fit: equal on {len(cases)} cases, one launch each")
    return err


def k28_plan_check() -> None:
    """K28's plan in csrc/preempt.cu (``candidate_fit_plan``) equal to the
    copy in ``kernel_work.k28_plan`` that the CPU mirror walks."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("preempt").candidate_fit_plan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    differ = [(r, tuple(out), KW.k28_plan(r)) for r in range(17)
              if fn(r, out) != 0 or tuple(out) != KW.k28_plan(r)]
    if differ:
        fail(f"candidate_fit_plan differs from kernel_work.k28_plan: {differ[:4]}")
    log("candidate_fit: the kernel's plan equals kernel_work.k28_plan")


def k27_plan_check() -> None:
    """K27's plan in csrc/preempt.cu (``priority_prefix_plan``) equal to the
    copy in ``kernel_work.k27_plan`` that the CPU mirror walks."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("preempt").priority_prefix_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    differ = []
    for r, k in itertools.product(range(17), (0, 1, 16, 17, 128, 256)):
        if fn(r, k, out) != 0 or tuple(out) != KW.k27_plan(r, k):
            differ.append((r, k, tuple(out), KW.k27_plan(r, k)))
    if differ:
        fail(f"priority_prefix_plan differs from kernel_work.k27_plan: {differ[:4]}")
    log("priority_prefix: the kernel's plan equals kernel_work.k27_plan")


DENSE_POD = ("pod_valid", "pod_node", "pod_priority", "pod_request")
DENSE_SIDE = ("priority", "request", "allocatable", "requested", "static_bits")
DENSE_CASES = ("skewed node, rounding sums", "every pod invalid", "every pod unbound",
               "empty nodes, B = 37, N = 1000", "R = 8", "R = 12", "R = 16",
               "misaligned tier, P = 3001")


def dense_equal(what: str, case: dict, dev) -> float:
    """K29 on ``case`` (CPU tensors, copied to the card as they are)
    against its plain version on the CPU copies, bit for bit, in one
    launch."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import preempt as KP

    g = {k: case[k].to(dev) for k in DENSE_POD + DENSE_SIDE}
    if "pod_node_offset" in case:  # the tier's node column 4 bytes past a boundary
        flat = torch.empty(case["pod_node"].numel() + 1, dtype=torch.int32, device=dev)
        flat[1:] = g["pod_node"]
        g["pod_node"] = flat[1:]
    before = kernels.LAUNCHES["candidate_dense"]
    got = KP.candidate_dense(*(g[k] for k in DENSE_POD), *(g[k] for k in DENSE_SIDE), 0b1111)
    if kernels.LAUNCHES["candidate_dense"] - before != 1:
        fail(f"candidate_dense ({what}): not one launch")
    want = KP.candidate_dense_plain(*(case[k] for k in DENSE_POD),
                                    *(case[k] for k in DENSE_SIDE), 0b1111)
    torch.cuda.synchronize()
    return require_equal(f"candidate_dense ({what})", [("mask", got.cpu(), want)])


def dense_cases(gen) -> dict:
    """K29's edge cases (CPU tensors, more than 128 priorities each): a
    skewed tier whose node 7 holds 6000 pods (more than a 4096-row chunk
    and a 1024-entry round) at odd-KiB requests whose sums pass 2^24, with
    batch rows asking exactly for that node's float32 fit value and one ulp
    more; every pod invalid; every pod unbound; pods on the even nodes of
    the first half only, at B = 37 and N = 1000 (neither a multiple of a
    block's tile); R = 8 (the path's), 12 and 16; a tier of 3001 rows whose
    node column starts off a 16-byte boundary."""
    import numpy as np
    import torch

    out = {}
    n, p, b, r = 2000, 20000, 70, 4
    c = preempt_case(gen, n=n, p=p, b=b, r=r, n_prio=300, dead=40)
    node = c["pod_node"]
    node[:6000] = 7
    node[6000:] = torch.randint(0, n // 2, (p - 6000,), generator=gen, dtype=torch.int32)
    c["pod_valid"][:6000] = True
    c["pod_request"][:6000, 1] = torch.randint(100_000, 150_000, (6000,), generator=gen,
                                               dtype=torch.int32) * 2 + 1
    c["static_bits"][:, 7] = 0b1111
    prio_b, req_b = c["priority"], c["request"]
    for j, thr in enumerate((-1, 200, 500, 900)):
        lower = (c["pod_valid"] & (node == 7) & (c["pod_priority"] < thr)).numpy()
        freed = np.cumsum(c["pod_request"][:, 1].numpy()[lower].astype(np.float32),
                          dtype=np.float32)[-1] if lower.any() else np.float32(0)
        base = np.float32(c["allocatable"][7, 1]) - np.float32(c["requested"][7, 1])
        v = np.float32(base + freed)
        for k, val in enumerate((int(v), int(v) + max(1, int(np.spacing(v))))):
            row = 2 * j + k
            prio_b[row], req_b[row] = thr, 0
            req_b[row, 1] = val
    out[DENSE_CASES[0]] = c
    c = preempt_case(gen, n=600, p=4000, b=40, n_prio=300)
    c["pod_valid"][:] = False
    out[DENSE_CASES[1]] = c
    c = preempt_case(gen, n=600, p=4000, b=40, n_prio=300)
    c["pod_node"][:] = -1
    out[DENSE_CASES[2]] = c
    c = preempt_case(gen, n=1000, p=6000, b=37, n_prio=300, dead=10)
    c["pod_node"][:] = torch.randint(0, 250, (6000,), generator=gen, dtype=torch.int32) * 2
    out[DENSE_CASES[3]] = c
    for name, rr in zip(DENSE_CASES[4:7], (8, 12, 16)):
        out[name] = preempt_case(gen, n=1000, p=5000, b=45, r=rr, n_prio=300, dead=10)
    c = preempt_case(gen, n=700, p=3001, b=33, n_prio=300, dead=5)
    c["pod_node_offset"] = True
    out[DENSE_CASES[7]] = c
    if list(out) != list(DENSE_CASES):
        fail("candidate_dense cases: names out of order")
    return out


def dense_single_launch(g: dict) -> None:
    """K29 calls captured in a graph: one launch a call, no device activity
    but K29's own; and under the profiler no sort, searchsorted or other
    torch op than an empty output on the host."""
    from kubernetes_tpu_torch.kernels import preempt as KP

    host = one_device_activity(
        "candidate_dense",
        lambda: KP.candidate_dense(*(g[k] for k in DENSE_POD), *(g[k] for k in DENSE_SIDE),
                                   0b1111),
        "candidate_dense_kernel", "candidate_dense", host_ops=True)
    if [k_ for k_ in host if not k_.startswith("aten::empty")]:
        fail(f"candidate_dense: torch ops beside the kernel on the host: {host}")


def preempt_cluster(dev_name: str, size: str, scale: float = 1.0, clock=None, **kw):
    """PreemptionBasic's cluster from the port's workload (node_default
    nodes, pod_low_priority pods scheduled first, pod_high_priority pods
    created): → (store, synchronous scheduler, workload, measured pods)."""
    from kubernetes_tpu_torch.perf.workloads import build_workload
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    w = build_workload("PreemptionBasic", size, scale=scale)
    (_, n, nt), (_, p, pt), (_, mp, mt) = ((op.opcode, op.count,
                                           op.node_template or op.pod_template)
                                          for op in w.ops)
    store = ObjectStore()
    if clock is not None:
        kw.update(clock=clock, batch_wait=0)
    sched = TorchScheduler(store, batch_size=w.batch_size, device=dev_name, **kw)
    sched.presize(n, p + mp)
    for i in range(n):
        nd = nt(i)
        nd.metadata.creation_timestamp = 0.0
        store.create("Node", nd)
    for i in range(p):
        pod = pt(i)
        pod.metadata.creation_timestamp = float(i)
        store.create("Pod", pod)
    sched.run_until_idle(backoff_wait=0)
    measured = []
    for i in range(p, p + mp):
        pod = mt(i)
        pod.metadata.creation_timestamp = float(i)
        measured.append(pod)
    return store, sched, w, measured


def preempt_checks(what: str, store, n_nodes: int, n_low: int, n_high: int) -> dict:
    """Every pod bound, no node over allocatable, exactly 3 · nodes victims
    and every one of them a low pod, every node holding one high and one
    low pod; → the counts."""
    pods = check_bound_and_fit(what, store)
    names = {p.metadata.name for p in pods}
    victims = {f"low-{i:06d}" for i in range(n_low)} - names
    highs = [p for p in pods if p.metadata.name.startswith("high-")]
    if len(highs) != n_high:
        fail(f"{what}: {len(highs)} of {n_high} high pods present")
    if len(victims) != 3 * n_nodes or len(pods) != n_low + n_high - len(victims):
        fail(f"{what}: {len(victims)} victims, expected {3 * n_nodes} low pods")
    per_node = {}
    for p in pods:
        per_node.setdefault(p.spec.node_name, []).append(p.metadata.name[:3])
    bad = [k for k, v in per_node.items() if sorted(v) != ["hig", "low"]]
    if bad or len(per_node) != n_nodes:
        fail(f"{what}: {len(bad)} nodes not holding one high and one low pod, "
             f"e.g. {[(k, per_node[k]) for k in bad[:3]]}")
    return {"victims": len(victims), "nodes": len(per_node)}


def preemption_basic_sync(kargs: KernelArgs, out_dir: Path, dev_name: str = "cuda") -> dict:
    """PreemptionBasic/5000Nodes (5000 nodes of 4 cpu / 32Gi, 20000 low pods
    of 900m / 500Mi at priority 0 scheduled first, then 5000 high pods of
    3000m / 500Mi at priority 10; B = 512) through TorchScheduler
    synchronously, launch counts zeroed just before the high pods and read
    just after: every high pod bound, exactly 15000 victims (all low pods),
    every node holding one high and one low pod, no node over allocatable,
    K1 and K27 + K28 launched, the C++ sweep run; pods/s, attempt p50 / p99,
    preemption attempts, victims, fast binds, phase walls; then one
    profiled failing cycle of 512 priority-20 pods that each preempt."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.testutil import make_pod
    from kubernetes_tpu_torch.whatif import dryrun

    fresh_heap()
    t0 = time.perf_counter()
    store, sched, w, measured = preempt_cluster(dev_name, "5000Nodes")
    setup_s = time.perf_counter() - t0
    for pod in measured:
        store.create("Pod", pod)
    att0, pa0, cyc0 = len(sched.attempt_seconds), sched.preemption_attempts, sched.cycles
    phase0 = dict(sched.phase_wall)
    native0 = dryrun.NATIVE_CALLS[0]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw, kargs:
        stats = sched.run_until_idle(backoff_wait=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    got = preempt_checks("PreemptionBasic", store, 5000, 20000, 5000)
    for k in ("filter_score_planes", "priority_prefix", "candidate_fit"):
        if launches[k] <= 0:
            fail(f"PreemptionBasic: kernel {k} never launched on the main path")
    if dryrun.NATIVE_CALLS[0] == native0:
        fail("PreemptionBasic: the C++ reprieve sweep never ran")
    samples = sorted(sched.attempt_seconds[att0:])
    rec = {"nodes": 5000, "low_pods": 20000, "pods": 5000, "batch_size": w.batch_size,
           "setup_s": setup_s, "wall_s": wall, "pods_per_s": stats.scheduled / wall,
           "attempt_p50_ms": samples[len(samples) // 2] * 1e3,
           "attempt_p99_ms": samples[min(len(samples) - 1, int(0.99 * len(samples)))] * 1e3,
           "preemption_attempts": sched.preemption_attempts - pa0,
           "victims": got["victims"], "fast_binds": sched.fast_binds,
           "post_filter_errors": sched.post_filter_errors, "cycles": sched.cycles - cyc0,
           "native_sweeps": dryrun.NATIVE_CALLS[0] - native0,
           "phase_wall_s": {k: v - phase0[k] for k, v in sched.phase_wall.items()},
           "launches": launches, "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds}
    log(f"PreemptionBasic/5000Nodes synchronous (B = {w.batch_size}): {stats.scheduled} high "
        f"pods bound in {wall:.3f} s = {rec['pods_per_s']:.1f} pods/s; attempt p50 "
        f"{rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms; "
        f"{rec['preemption_attempts']} preemption attempts, {got['victims']} victims, "
        f"{sched.fast_binds} fast binds, {rec['native_sweeps']} C++ sweeps; phase wall "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["phase_wall_s"].items() if v)
        + "; launches " + ", ".join(f"{k} {launches[k]}" for k in
                                    ("filter_score_planes", "priority_prefix",
                                     "candidate_fit", "candidate_dense",
                                     "prev_delta_apply")))
    # the profiled failing cycle: 512 pods of 900m at priority 20, each
    # evicting the low pod of a node (100m free + 900m freed)

    def hungry(i):
        return (make_pod().name(f"prof-{i:06d}").uid(f"prof-{i:06d}").namespace("default")
                .req({"cpu": "900m", "memory": "500Mi"}).priority(20).obj())

    rec["profile"] = profile_cycle(sched, out_dir, "PreemptionBasic failing",
                                   hungry, "profile_preempt_cycle.txt")
    return {"record": rec, "sched": sched}


def preemption_basic_harness(dev_name: str = "cuda") -> dict:
    """PreemptionBasic/5000Nodes through the port's perf harness
    (``run_workload``: pipelined, depth 3, B = 512): the same checks as the
    synchronous run, K27 + K28 launched inside the measured window and by
    the failure warm before it, no kernel built in the window; pods/s and
    attempt p50 / p99."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    seen = {}

    def inspect(store, sched, _ctrl):
        torch.cuda.synchronize()
        seen["launches"] = dict(kernels.LAUNCHES)
        seen["checks"] = preempt_checks("PreemptionBasic harness", store, 5000, 20000, 5000)
        seen["fast_binds"] = sched.fast_binds
        seen["attempts"] = sched.preemption_attempts

    fresh_heap()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    w = build_workload("PreemptionBasic", "5000Nodes")
    items = run_workload(w, device=dev_name, inspect=inspect)
    wall = time.perf_counter() - t
    by = {it.labels["Metric"]: it.data for it in items}
    win = by["KernelLaunchesInWindow"]
    for k in ("filter_score_planes", "priority_prefix", "candidate_fit"):
        if win[k] <= 0:
            fail(f"PreemptionBasic harness: kernel {k} never launched in the measured window")
        if seen["launches"][k] <= win[k]:
            fail(f"PreemptionBasic harness: kernel {k} did not launch before the window")
    if by["KernelBuildsInWindow"]["Count"] != 0:
        fail("PreemptionBasic harness: a kernel was built inside the measured window")
    att = by["scheduler_scheduling_attempt_duration_seconds"]
    rec = {"items": json.loads(data_items_to_json(items)), "wall_s": wall,
           "batch_size": w.batch_size, "pods_per_s": by["SchedulingThroughput"]["Average"],
           "attempt_p50_ms": att["Perc50"] * 1e3, "attempt_p99_ms": att["Perc99"] * 1e3,
           "window_launches": win, "window_phase_wall_s": by["PhaseWallBreakdown"],
           "launches": seen["launches"], "fast_binds": seen["fast_binds"],
           "preemption_attempts": seen["attempts"], **seen["checks"]}
    log(f"PreemptionBasic/5000Nodes via perf.harness.run_workload (pipelined, B = "
        f"{w.batch_size}): {rec['pods_per_s']:.1f} pods/s; attempt p50 "
        f"{rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms; "
        f"{rec['victims']} victims, {rec['fast_binds']} fast binds; window phase wall "
        + ", ".join(f"{k} {v:.3f}" for k, v in by["PhaseWallBreakdown"].items() if v)
        + "; window launches " + ", ".join(f"{k} {win[k]:.0f}" for k in
                                           ("filter_score_planes", "priority_prefix",
                                            "candidate_fit")))
    return rec


def dense_preempt_cluster(dev_name: str, clock):
    """200 nodes of 4 cpu / 32Gi, each holding four 900m pods at distinct
    priorities 0–799 (more than 128 levels: the dense form, K29), then 100
    pods of 3000m at priority 1000."""
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=128, device=dev_name, clock=clock,
                           batch_wait=0)
    for i in range(200):
        nd = (make_node().name(f"node-{i:06d}")
              .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
        nd.metadata.creation_timestamp = 0.0
        store.create("Node", nd)
    for i in range(800):
        store.create("Pod", make_pod().name(f"low-{i:06d}").uid(f"low-{i:06d}")
                     .namespace("default").req({"cpu": "900m", "memory": "500Mi"})
                     .priority((i * 37) % 800).creation_timestamp(float(i)).obj())
    sched.run_until_idle(backoff_wait=0)
    measured = [make_pod().name(f"high-{i:06d}").uid(f"high-{i:06d}").namespace("default")
                .req({"cpu": "3000m", "memory": "500Mi"}).priority(1000)
                .creation_timestamp(1000.0 + i).obj() for i in range(100)]
    return store, sched, measured


def preempt_bindings(device: str, kind: str):
    """One preemption run → (bindings, victims, nominations after each
    step, outcomes, launches): "basic" is PreemptionBasic/500Nodes (500
    nodes, 2000 low, 500 high; fast binds), "requeue" the same with
    ``nominated_fast_bind=False`` (every preemptor nominated, requeued and
    bound on a later cycle: K13's nominated bundle with live rows), "dense"
    the 200-node cluster whose running pods carry 800 priorities (K29)."""
    import torch

    from kubernetes_tpu_torch import kernels

    clock = _FixedClock()
    if kind == "dense":
        store, sched, measured = dense_preempt_cluster(device, clock)
    else:
        store, sched, _w, measured = preempt_cluster(
            device, "500Nodes", clock=clock, nominated_fast_bind=kind != "requeue")
    before = {p.metadata.name for p in store.list("Pod")[0]}
    for pod in measured:
        store.create("Pod", pod)
    kernels.reset_launches()
    noms = []
    for _ in range(6):
        sched.run_until_idle(backoff_wait=0)
        noms.append(sorted((u, v[0]) for u, v in sched._nominated.items()))
        clock.t += 11.0
    if device == "cuda":
        torch.cuda.synchronize()
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    outcomes = {"attempts": sched.preemption_attempts, "fast_binds": sched.fast_binds,
                "victims_per_preemption": list(sched.preemption_victims),
                "errors": sched.post_filter_errors}
    return pods, sorted(before - set(pods)), noms, outcomes, dict(kernels.LAUNCHES)


def time_nominated_bundle(dev) -> dict:
    """K13 with the nominated bundle alone, as a synchronous PreemptionBasic
    cycle gives it (B2 ``reserve_nominated``): N = 8192, R = 8, the sticky
    cap of 2 · 512 rows with 512 live, no nz rows; held against its plain
    version, timed as in 6 and by queued events, beside ``index_add_`` of
    the live rows' requests timed by the same methods; one device activity
    a call."""
    import torch

    from kubernetes_tpu_torch.kernels.prev_delta import prev_delta_apply, \
        prev_delta_apply_plain

    gen = torch.Generator().manual_seed(SEED + 13)
    n, r, k = 8192, 8, 1024
    req = torch.randint(0, 1 << 20, (n, r), generator=gen, dtype=torch.int32).to(dev)
    nz = torch.randint(0, 1 << 20, (n, 2), generator=gen, dtype=torch.int32).to(dev)
    rows = torch.full((k,), -1, dtype=torch.int32)
    rows[:512] = torch.randperm(n, generator=gen)[:512].to(torch.int32)
    nreq = torch.zeros((k, r), dtype=torch.int32)
    nreq[:512, 0] = 3000
    nreq[:512, 1] = 512000
    nreq[:512, 3] = 1
    bundle = [(rows.to(dev), nreq.to(dev), None)]  # no nz rows
    got = prev_delta_apply(req, nz, bundle)
    want = prev_delta_apply_plain(req, nz, bundle)
    torch.cuda.synchronize()
    err = require_equal("prev_delta_apply (nominated bundle alone)",
                        [("requested", got[0], want[0]), ("non_zero", got[1], want[1])])
    lib = req.clone()

    def library_add():
        # reserve_nominated's adds from the bundle as given: the dead rows
        # (−1) masked inside the timed call
        at, add = bundle[0][0], bundle[0][1]
        live = (at >= 0)[:, None]
        return lib.index_add_(0, at.long().clamp(0, n - 1), torch.where(live, add, 0))
    # what reserve_nominated needs: each bundle row's node row and requests
    # read once, the touched requested rows read and written (the wrapper's
    # copies of the arrays and the bundle's zero nz rows are not the function)
    n_bytes = k * (4 + 4 * r) + 2 * 512 * r * 4
    least, bound_by = bound_ms(n_bytes, 512 * r)
    ms, (lib_ms,), source = ms_one_method(lambda: prev_delta_apply(req, nz, bundle),
                                          "prev_delta_kernel", library_add)
    one_device_activity("prev_delta_apply (nominated bundle alone)",
                        lambda: prev_delta_apply(req, nz, bundle), "prev_delta_kernel",
                        "prev_delta_apply")
    rec = {"max_abs_err": err, "ms": ms, "ms_source": source,
           "queued_ms": queued_device_ms(lambda: prev_delta_apply(req, nz, bundle)),
           "library_queued_ms": queued_device_ms(library_add),
           "call_ms": time_ms(lambda: prev_delta_apply(req, nz, bundle)),
           "plain_ms": time_ms(lambda: prev_delta_apply_plain(req, nz, bundle), reps=5,
                               warmup=1),
           "bound_ms": least, "bound_by": bound_by, "library_ms": lib_ms,
           "shape": {"N": n, "R": r, "rows": k, "live": 512}}
    log(f"  prev_delta_apply, the nominated bundle alone: {rec['ms']:.5f} ms device "
        f"({rec['ms_source']}), bound {least:.7f} ms ({bound_by}), plain "
        f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.5f} ms; queued "
        f"{rec['queued_ms']:.5f} against {rec['library_queued_ms']:.5f}")
    return rec


def time_preempt_kernels(last_calls: dict, dense_calls: dict, err: dict, dev) -> list:
    """K27 and K28 timed on the arguments of their latest call on the
    PreemptionBasic/5000Nodes synchronous run, K29 on those of its latest
    call on the dense preemption run (``preempt_bindings("cuda", "dense")``)
    and, beside it under ``check_case``, on the dense check's inputs (B = 64,
    N = 8192, P = 32768, 300 priorities); each held once more, exactly,
    against its plain version (on CPU copies); the bound from the bytes
    those inputs need.  Library: index_put_(accumulate=True) + cumsum for
    K27, the dense einsum for K29."""
    import torch

    from kubernetes_tpu_torch.kernels import preempt as KP

    rows_out = []

    def last(name):
        got = last_calls.get(name)
        if got is None:
            fail(f"kernel timing: no recorded path call of {name}")
        return got[0]

    def cpu(args):
        return [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]

    def measure(name, fn, plain_fn, n_bytes, n_ops, shape, library_fn=None):
        least, bound_by = bound_ms(n_bytes, n_ops)
        # K27 and K29: the whole call's device time (their one kernel; a
        # design that prepared indices before it is timed with them)
        ms, libs, source = ms_one_method(
            fn, None if name in ("candidate_dense", "priority_prefix") else PREEMPT_SYMBOLS[name],
            *([library_fn] if library_fn else []))
        return {"ms": ms, "ms_source": source,
                "call_ms": time_ms(fn), "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
                "bound_ms": least, "bound_by": bound_by,
                "library_ms": libs[0] if libs else None,
                "bytes": n_bytes, "ops": n_ops, "shape": shape}

    def row(name, *args, **kw):
        rows_out.append({"name": name, "route": "cuda", "source": PREEMPT_SOURCE,
                         "replaces": PREEMPT_REPLACES[name], "launches": None,
                         "max_abs_err": err[name], **measure(name, *args, **kw)})

    # K27: kernel_work.k27_work (the tier it needs, the levels, the
    # [K+1, N, R+1] output written once)
    a27 = last("priority_prefix")
    valid, node, prio, req, levels, n = a27
    got = KP.priority_prefix(*a27)
    want = KP.priority_prefix_plain(*cpu(a27))
    err["priority_prefix"] = max(err["priority_prefix"], require_equal(
        "priority_prefix (path shapes)", [("prefix", got[0].cpu(), want[0]),
                                          ("prefix_cnt", got[1].cpu(), want[1])]))
    p, r = req.shape
    k = levels.shape[0]
    bound = valid & (node >= 0)
    bucket = torch.searchsorted(levels, prio)
    kk = torch.where(bound, bucket, k).long()
    nrow = node.long().clamp(0, n - 1)
    contrib = torch.cat([req.float(), torch.ones((p, 1), device=req.device)], 1) \
        * bound[:, None].float()
    table = torch.zeros((k + 1, n, r + 1), device=req.device)
    row("priority_prefix", lambda: KP.priority_prefix(*a27),
        lambda: KP.priority_prefix_plain(*a27), *KW.k27_work(*a27),
        {"P": p, "N": n, "R": r, "K": k, "live_levels": int((levels < 2 ** 31 - 1).sum()),
         "bound_pods": int(bound.sum())},
        library_fn=lambda: table.zero_().index_put_((kk, nrow), contrib,
                                                     accumulate=True).cumsum(0))

    # K28: kernel_work.k28_work (the static bits read, the mask written, the
    # threshold rows of the prefix read once each, the node and batch rows
    # once)
    a28 = last("candidate_fit")
    got = KP.candidate_fit(*a28)
    want = KP.candidate_fit_plain(*cpu(a28))
    err["candidate_fit"] = max(err["candidate_fit"], require_equal(
        "candidate_fit (path shapes)", [("mask", got.cpu(), want)]))
    prefix, cnt, lv, bprio, breq, alloc, used, bits, mask = a28
    b = bprio.shape[0]
    n2, r2 = alloc.shape
    tbs = int(torch.unique(torch.searchsorted(lv, bprio)).numel())
    row("candidate_fit", lambda: KP.candidate_fit(*a28),
        lambda: KP.candidate_fit_plain(*a28), *KW.k28_work(*a28),
        {"B": b, "N": n2, "R": r2, "threshold_rows": tbs})

    # K29: each (pod, node) adds the requests of its node's pods below the
    # batch pod, R float32 adds a pod; bytes: the static bits read and the
    # mask written, the pod tier, the node rows and the batch rows read once
    def dense(a29, what):
        got = KP.candidate_dense(*a29)
        want = KP.candidate_dense_plain(*cpu(a29))
        e = require_equal(f"candidate_dense ({what})", [("mask", got.cpu(), want)])
        pv, pn, pp, pr, bp, br, al, us, bt, _m = a29
        b3, n3 = bt.shape
        p3, r3 = pr.shape
        bnd = pv & (pn >= 0)
        below = int(((pp[None, bnd] < bp[:, None]) & (bt.sum(1) > 0)[:, None]).sum())
        # the dense form as the reference writes it, the [B, P] × [P, R]
        # factor formed outside the timed call: one einsum over the pod axis
        lower = (pv[None, :] & (pp[None, :] < bp[:, None])).float()
        onehot = ((pn.long()[:, None] == torch.arange(n3, device=dev)[None, :])
                  & (pn >= 0)[:, None]).float()
        lw = lower[:, :, None] * pr.float()[None]
        return e, (lambda: KP.candidate_dense(*a29),
                   lambda: KP.candidate_dense_plain(*a29),
                   5 * b3 * n3 + p3 * (1 + 4 + 4 + 4 * r3) + 8 * n3 * r3 + b3 * (r3 + 1) * 4,
                   below * r3,
                   {"B": b3, "N": n3, "P": p3, "R": r3, "pairs_below": below,
                    "priorities": int(torch.unique(pp[bnd]).numel())}), \
            (lambda: torch.einsum("bpr,pn->bnr", lw, onehot))

    got = dense_calls.get("candidate_dense")
    if got is None:
        fail("kernel timing: no recorded call of candidate_dense on the dense preemption run")
    e_path, m_path, lib_path = dense(list(got[0]), "dense preemption run's arguments")
    gen = torch.Generator().manual_seed(SEED + 29)
    d = preempt_case(gen, b=64, n_prio=300)
    g = {k_: v.to(dev) for k_, v in d.items()}
    a29 = [g[k_] for k_ in ("pod_valid", "pod_node", "pod_priority", "pod_request",
                            "priority", "request", "allocatable", "requested",
                            "static_bits")] + [0b1111]
    e_case, m_case, lib_case = dense(a29, "timing inputs")
    err["candidate_dense"] = max(err["candidate_dense"], e_path, e_case)
    row("candidate_dense", *m_path, library_fn=lib_path)
    rows_out[-1]["check_case"] = measure("candidate_dense", *m_case, library_fn=lib_case)
    for rr in rows_out + [dict(rows_out[-1]["check_case"], name="candidate_dense (check case)")]:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms"
            + (f", library {rr['library_ms']:.5f} ms" if rr["library_ms"] is not None else "")
            + f"; {rr['shape']}")
    return rows_out


# --- phases 4f / 6f: counterfactuals (the whatif fork and engine, the descheduler,
# the cluster autoscaler) ---------------------------------------------------------------

FORK_KERNELS = ("fork_masks", "fork_add_rows")
FORK_SOURCE = "kubernetes_tpu_torch/csrc/fork.cu"
FORK_REPLACES = {"fork_masks": "kubernetes_tpu/whatif/fork.py:92",
                 "fork_add_rows": "kubernetes_tpu/whatif/fork.py:82"}
FORK_SYMBOLS = {"fork_masks": "fork_masks_kernel", "fork_add_rows": "fork_add_rows_kernel"}
WHATIF_FORK = "kubernetes_tpu_torch.whatif.fork"
FORK_TARGETS = {k: (WHATIF_FORK, k, None) for k in FORK_KERNELS}


def fork_case(gen, *, k=4, n=8192, p=16384, r=8, g=8, d=8, v=8, a=8, dd=8, chips=True):
    """K30's inputs on the CPU: the live node / pod / affinity arrays and K
    payloads — victims with a duplicate, −1 pads in every group, affinity
    contributions (one repeated), claim-holding victims, node removes."""
    import torch

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    live = {"node_valid": torch.rand(n, generator=gen) < 0.97,
            "requested": ri(0, 1 << 20, n, r), "non_zero": ri(0, 1 << 20, n, 2),
            "claim_allocated": ri(0, 5, n), "pod_valid": torch.rand(p, generator=gen) < 0.9,
            "pod_request": ri(0, 5000, p, r), "pod_non_zero": ri(0, 5000, p, 2),
            "aff_counts": ri(0, 50, g, d).float()}
    vic_p = torch.full((k, v), -1, dtype=torch.int32)
    vic_n = torch.zeros((k, v), dtype=torch.int32)
    aff_r = torch.full((k, a), -1, dtype=torch.int32)
    aff_v = torch.zeros((k, a), dtype=torch.int32)
    del_r = torch.full((k, dd), -1, dtype=torch.int32)
    vic_c = torch.zeros((k, v), dtype=torch.int32)
    for f in range(k):
        nv = v - 1 - f  # a pad in every fork
        vic_p[f, :nv] = ri(0, p, nv)
        vic_p[f, 1] = vic_p[f, 0]  # a duplicate victim
        vic_n[f, :nv] = ri(0, n, nv)
        vic_c[f, :nv] = ri(0, 5, nv)
        na = a - 1 - f
        aff_r[f, :na] = ri(0, g, na)
        aff_v[f, :na] = ri(0, d, na)
        aff_r[f, 1], aff_v[f, 1] = aff_r[f, 0], aff_v[f, 0]
        del_r[f, : f + 1] = ri(0, n, f + 1)
    payload = {"vic_pod_rows": vic_p, "vic_node_rows": vic_n, "aff_rows": aff_r,
               "aff_vals": aff_v, "del_rows": del_r,
               "vic_claim_chips": vic_c if chips else None}
    return live, payload


def fork_edge_case(gen, *, chips=True):
    """K30's tile edges on the CPU: N = 8190, P = 16383 and G × D = 7 × 5
    (none a whole number of tiles, and node_valid, claim_allocated,
    pod_valid and aff_counts not 16-byte vectors), K = 4 forks of V = A =
    D_rows = 512 entries: victims, removes and affinity cells on either side
    of a tile boundary and on the last row, rows past the end (clipped) and
    below 0 (a victim's node: row 0), duplicates, −1 pads; fork 3 puts 512
    victims on node 5 (pods 0–511), 512 removes on node 130 and 512
    contributions on one cell, more than a warp's staging slots hold (the
    tile walks the payload in global memory)."""
    import torch

    live, payload = fork_case(gen, k=4, n=8190, p=16383, g=7, d=5, v=512, a=512, dd=512,
                              chips=chips)
    vp, vn, vc = payload["vic_pod_rows"], payload["vic_node_rows"], payload["vic_claim_chips"]
    ar, av, dr = payload["aff_rows"], payload["aff_vals"], payload["del_rows"]
    edge_p = [4095, 4096, 16382, 20000, 4095, 0]
    edge_n = [127, 128, 8189, 9000, 127, -3]
    for f in range(3):
        vp[f, :6] = torch.tensor(edge_p, dtype=torch.int32)
        vn[f, :6] = torch.tensor(edge_n, dtype=torch.int32)
        dr[f, :5] = torch.tensor([127, 128, 8189, 9999, 128], dtype=torch.int32)
        ar[f, :5] = torch.tensor([6, 9, 0, 6, 3], dtype=torch.int32)
        av[f, :5] = torch.tensor([4, 0, -1, 4, 7], dtype=torch.int32)
    vp[3] = torch.arange(512, dtype=torch.int32)
    vn[3] = 5
    dr[3] = 130
    ar[3], av[3] = 2, 3
    if vc is not None:
        vc[3] = 1
    return live, payload


def add_case(gen, *, k=4, n=8192, m=4096, real=(3072, 1536, 768, 1)):
    """K31's inputs on the CPU: the twenty live node arrays (synthetic_snapshot's
    rows) and K forks of template rows — fork f holds ``real[f]`` real adds on
    distinct rows, then pads at row 0 (ok = False); the last fork's one real
    add sits at row 0 with pads behind it."""
    import torch

    from kubernetes_tpu_torch.state.encoding import NODE_ARRAYS

    snap = synthetic_snapshot(n, gen, "cpu")
    arrays = [getattr(snap, name) for name in NODE_ARRAYS]
    rows = torch.zeros((k, m), dtype=torch.int32)
    ok = torch.zeros((k, m), dtype=torch.bool)
    for f in range(k):
        nr = real[f % len(real)]
        pick = torch.randperm(n - 1, generator=gen)[:nr].to(torch.int32) + 1
        if f == k - 1:
            pick[0] = 0  # a real add at row 0, pads behind it
        rows[f, :nr] = pick
        ok[f, :nr] = True
    vals = []
    for a in arrays:
        shape = (k, m) + tuple(a.shape[1:])
        if a.dtype == torch.bool:
            vals.append(torch.rand(shape, generator=gen) < 0.5)
        elif a.dtype == torch.int32:
            vals.append(torch.randint(0, 9000, shape, generator=gen, dtype=torch.int32))
        else:
            vals.append(torch.rand(shape, generator=gen) * 100)
    return arrays, rows, ok, vals


def _masks_args(live, payload, node=None):
    """fork_masks' positional arguments (node arrays from ``node`` when K31
    gave them per fork) and its keyword."""
    node = node or {}
    args = [node.get("node_valid", live["node_valid"]),
            node.get("requested", live["requested"]),
            node.get("non_zero_requested", live["non_zero"]),
            node.get("claim_allocated", live["claim_allocated"]),
            live["pod_valid"], live["pod_request"], live["pod_non_zero"], live["aff_counts"],
            payload["vic_pod_rows"], payload["vic_node_rows"], payload["aff_rows"],
            payload["aff_vals"], payload["del_rows"]]
    return args, {"vic_claim_chips": payload["vic_claim_chips"]}


def _to(x, dev):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k_: _to(v, dev) for k_, v in x.items()}
    return x


def _masks_pairs(got, want):
    names = ("node_valid", "pod_valid", "requested", "non_zero", "aff_counts",
             "claim_allocated")
    return [(nm, a.cpu(), b) for nm, a, b in zip(names, got, want) if b is not None]


def check_fork_kernels(dev) -> dict:
    """K30 and K31 against their plain versions, exactly (the plain versions
    on CPU copies of the same inputs): K30 at Defrag's shapes (N = 8192, P =
    16384, R = 8, K = 4 forks of 8 victims, 8 affinity contributions and up
    to 4 removes) with a duplicate victim, −1 pads in every group, a
    repeated affinity cell and claim-holding victims, and without the claim
    plane; K31 at AutoscaleGang's shapes (K = 4, M = 4096 rows a fork, up to
    3072 real adds) with pads at row 0 and a real add at row 0 with pads
    behind it, then K30 on K31's per-fork node arrays; K = 4 stacked equal
    to four K = 1 launches, for both kernels."""
    import torch

    from kubernetes_tpu_torch.kernels import fork as KF
    from kubernetes_tpu_torch.state.encoding import NODE_ARRAYS

    gen = torch.Generator().manual_seed(SEED + 30)
    err = {k_: 0.0 for k_ in FORK_KERNELS}
    for chips in (True, False):
        live, payload = fork_case(gen, chips=chips)
        args, kw = _masks_args(live, payload)
        got = KF.fork_masks(*_to(args, dev), **_to(kw, dev))
        want = KF.fork_masks_plain(*args, **kw)
        torch.cuda.synchronize()
        err["fork_masks"] = max(err["fork_masks"], require_equal(
            f"fork_masks (Defrag shapes, claims {chips})", _masks_pairs(got, want)))
        # stacked == one launch a fork
        for f in range(4):
            one = {k_: (v[f:f + 1] if v is not None else None) for k_, v in payload.items()}
            a1, kw1 = _masks_args(live, one)
            g1 = KF.fork_masks(*_to(a1, dev), **_to(kw1, dev))
            torch.cuda.synchronize()
            require_equal(f"fork_masks K = 4 vs K = 1 (fork {f})",
                          [(nm, a[0], b[f].cpu()) for nm, a, b in _masks_pairs(g1, got)])
    arrays, rows, ok, vals = add_case(gen)
    got = KF.fork_add_rows(_to(arrays, dev), rows.to(dev), ok.to(dev), _to(vals, dev))
    want = KF.fork_add_rows_plain(arrays, rows, ok, vals)
    torch.cuda.synchronize()
    err["fork_add_rows"] = require_equal(
        "fork_add_rows (AutoscaleGang shapes)",
        [(nm, a.cpu(), b) for nm, a, b in zip(NODE_ARRAYS, got, want)])
    # the row-0 add wins over the pads behind it
    last = rows.shape[0] - 1
    j0 = int((rows[last] == 0).nonzero()[0])
    for nm, a, v in zip(NODE_ARRAYS, got, vals):
        if not _equal(a[last, 0].cpu(), v[last, j0]):
            fail(f"fork_add_rows: the row-0 add of the last fork lost to a pad in {nm}")
    for f in range(rows.shape[0]):
        g1 = KF.fork_add_rows(_to(arrays, dev), rows[f:f + 1].to(dev), ok[f:f + 1].to(dev),
                              [v[f:f + 1].to(dev) for v in vals])
        torch.cuda.synchronize()
        require_equal(f"fork_add_rows K = 4 vs K = 1 (fork {f})",
                      [(nm, a[0].cpu(), b[f].cpu()) for nm, a, b in zip(NODE_ARRAYS, g1, got)])
    # K30 on K31's per-fork node arrays (a fork set that adds nodes)
    live, payload = fork_case(gen)
    args, kw = _masks_args(live, payload, dict(zip(NODE_ARRAYS, want)))
    args_dev, _ = _masks_args(_to(live, dev), _to(payload, dev), dict(zip(NODE_ARRAYS, got)))
    auto_args = (args_dev, _to(kw, dev))
    got2 = KF.fork_masks(*args_dev, **_to(kw, dev))
    want2 = KF.fork_masks_plain(*args, **kw)
    torch.cuda.synchronize()
    err["fork_masks"] = max(err["fork_masks"], require_equal(
        "fork_masks on fork_add_rows' per-fork node arrays", _masks_pairs(got2, want2)))
    # K30 at its tile edges and past its staging slots, with and without claims
    for chips in (True, False):
        live, payload = fork_edge_case(gen, chips=chips)
        args, kw = _masks_args(live, payload)
        got = KF.fork_masks(*_to(args, dev), **_to(kw, dev))
        want = KF.fork_masks_plain(*args, **kw)
        torch.cuda.synchronize()
        err["fork_masks"] = max(err["fork_masks"], require_equal(
            f"fork_masks (tile edges, claims {chips})", _masks_pairs(got, want)))
    # one launch a call: K30 on Defrag's shapes and on K31's per-fork node
    # arrays (AutoscaleGang's)
    live, payload = fork_case(gen)
    args, kw = _masks_args(_to(live, dev), _to(payload, dev))
    one_device_activity("fork_masks (Defrag shapes)", lambda: KF.fork_masks(*args, **kw),
                        FORK_SYMBOLS["fork_masks"], "fork_masks")
    one_device_activity("fork_masks (AutoscaleGang, per-fork node arrays)",
                        lambda: KF.fork_masks(*auto_args[0], **auto_args[1]),
                        FORK_SYMBOLS["fork_masks"], "fork_masks")
    log("fork kernels vs plain: all equal (K30 at Defrag's shapes with duplicates, pads, "
        "affinity cells and claim chips, K = 4 == 4 × K = 1, at its tile edges and past its "
        "staging slots; K31 at AutoscaleGang's shapes, the row-0 add kept, K = 4 == 4 × K = "
        "1; K30 on K31's output)")
    return err


def fork_key(name, args):
    """The latest call of each fork kernel at each fork count K."""
    return name, int(args[8].shape[0] if name == "fork_masks" else args[1].shape[0])


def _run_controlled(suite: str, size: str, dev_name: str, clock=None, max_steps: int = 400):
    """``suite`` at ``size`` driven synchronously with its controller (the
    harness's cycle → sync_once loop, on a clock the caller moves 1 s a
    step when given): → (store, sched, ctrl, measured pod names)."""
    from kubernetes_tpu_torch.perf.workloads import build_workload
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    w = build_workload(suite, size)
    store = ObjectStore()
    kw = {"clock": clock} if clock is not None else {}
    sched = TorchScheduler(store, batch_size=w.batch_size, device=dev_name, batch_wait=0, **kw)
    ctrl = w.make_descheduler(store, sched)
    node_idx = pod_idx = 0
    measured = []
    for op in w.ops:
        if op.opcode == "createNodes":
            for _ in range(op.count):
                store.create("Node", op.node_template(node_idx))
                node_idx += 1
        elif op.opcode == "createObjects":
            for j in range(op.count):
                store.create(*op.object_template(j))
        else:
            for _ in range(op.count):
                p = op.pod_template(pod_idx)
                store.create("Pod", p)
                pod_idx += 1
                if op.collect_metrics:
                    measured.append(p.metadata.name)
            if not op.collect_metrics:
                sched.run_until_idle(backoff_wait=0)
    for _ in range(max_steps):
        sched.schedule_cycle()
        ctrl.sync_once()
        if clock is not None:
            clock.t += 1.0
        if all(store.get("Pod", "default", n).spec.node_name for n in measured):
            break
    return store, sched, ctrl, measured


def _straggler_forks(store, engine_mod, n_slices: int = 4):
    """Fork specs evicting the stragglers of the first ``n_slices`` slices
    that still hold some, and a fresh gang of 8 to place."""
    from kubernetes_tpu_torch.testutil import make_pod

    by_slice = {}
    slice_of = {n.metadata.name: n.metadata.labels.get(SLICE_LABEL)
                for n in store.list("Node")[0]}
    for p in store.list("Pod")[0]:
        if p.metadata.labels.get("strag") == "1" and p.spec.node_name:
            by_slice.setdefault(slice_of[p.spec.node_name], []).append(p)
    picks = sorted(by_slice)[:n_slices]
    forks = [engine_mod.ForkSpec(victims=by_slice[s], note=s) for s in picks]
    pending = [make_pod().name(f"probe-{i}").uid(f"probe-{i}").namespace("default")
               .label(POD_GROUP_LABEL, "probe").req({"cpu": "3000m", "memory": "500Mi"}).obj()
               for i in range(8)]
    return pending, forks


def defrag_checks(what: str, store, ctrl, gang_size: int = 8) -> dict:
    """Every gang bound whole inside one slice, no gang member evicted, 8
    evictions per freed slice."""
    slice_of = {n.metadata.name: n.metadata.labels.get(SLICE_LABEL)
                for n in store.list("Node")[0]}
    pods = {p.metadata.name: p for p in store.list("Pod")[0]}
    gangs = {}
    strag_left = {}
    for name, p in pods.items():
        g = p.metadata.labels.get(POD_GROUP_LABEL)
        if g:
            if not p.spec.node_name:
                fail(f"{what}: gang pod {name} unbound")
            gangs.setdefault(g, set()).add(slice_of[p.spec.node_name])
        elif p.metadata.labels.get("strag") == "1":
            strag_left[slice_of[p.spec.node_name]] = strag_left.get(
                slice_of[p.spec.node_name], 0) + 1
    split = sum(1 for s in gangs.values() if len(s) != 1)
    members = sum(1 for p in pods.values() if POD_GROUP_LABEL in p.metadata.labels)
    n_strag = sum(1 for n in slice_of if n.startswith("node-"))
    evicted = n_strag - sum(strag_left.values())
    freed = len({s for s in slice_of.values()}) - len(strag_left)
    gate = sum(v for (_p, r), v in ctrl.evictions.results.items() if r == "evicted")
    if split or members != gang_size * len(gangs):
        fail(f"{what}: {split} gangs over more than one slice, {members} members for "
             f"{len(gangs)} gangs")
    if evicted != gang_size * freed or evicted != gate:
        fail(f"{what}: {evicted} stragglers evicted for {freed} freed slices "
             f"({gate} through the gate)")
    return {"gangs": len(gangs), "evicted": evicted, "freed_slices": freed,
            "gangs_split_over_slices": split}


def profile_evaluate(engine, pending, forks, out_dir: Path, fname: str) -> dict:
    """One K-fork evaluate under torch.profiler: its wall, the device time by
    kernel, the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch import kernels

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    engine.evaluate(pending, forks)  # warm the batch shape
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        preds = engine.evaluate(pending, forks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    launched = {k_: v - before.get(k_, 0) for k_, v in kernels.LAUNCHES.items()
                if v != before.get(k_, 0)}
    if preds is None:
        fail("profiled evaluate: the engine refused")

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in events), reverse=True)
    lines = [f"one evaluate of {len(forks)} forks, {len(pending)} pending pods, under "
             f"torch.profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms",
             f"{'device ms':>10} {'count':>6}  name"]
    lines += [f"{ms:10.4f} {cnt:6d}  {name}" for ms, cnt, name in top]
    (out_dir / fname).write_text("\n".join(lines) + "\n")
    rec = {"forks": len(forks), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "launches": launched,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "placed": [p.placed for p in preds], "top": [[ms, c, n] for ms, c, n in top[:12]]}
    log(f"profiled evaluate ({len(forks)} forks): wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.3f} ms" + (f" (idle share {rec['device_idle_share']:.4f})" if busy_ms
                               else " (the profiler recorded no device time: not measured)"))
    return rec


# kernels already redesigned for Hopper in the port's step 2 (every row of
# theirs, at every shape and mode, or the one row a full name names): K2,
# K3, K4, K29, K19, K7, K13, K1, K11, K12, K17 (keyless and keyed), K6,
# K18, K32, K30, K8, K16, K27, K10, K33's step row, K23, K28 and K25
REDESIGNED = ("normalize_combine", "topk_rows", "auction_resolve_commit", "candidate_dense",
              "ipa_update_row", "spread_score_combine", "prev_delta_apply",
              "filter_score_planes", "ipa_score_combine", "ipa_update_classes",
              "scan_select_assume", "spread_filter_bits", "spread_update_row",
              "selector_spread_score", "fork_masks", "spread_update_classes", "scatter_rows",
              "priority_prefix", "ipa_filter_bits", "tie_noise (step row)", "selector_match",
              "candidate_fit", "dra_score_into")


def step2_order(rows: list) -> dict:
    """The port's order for redesigning kernels, over the rows of kernels
    not yet redesigned (``REDESIGNED``'s rows, by kernel or by full name,
    are named as skipped) and not left alone — a row that reaches half its
    bound or more and is no slower than its library call is named as left
    alone: first those slower than the one PyTorch call that computes the
    same function (largest factor first), then the rest by launches ×
    (time − bound) on the path that carries them."""
    skipped = [r["name"] for r in rows
               if r["name"] in REDESIGNED or r["name"].split(" (")[0] in REDESIGNED]
    rows = [r for r in rows if r["name"] not in skipped]
    alone = [r["name"] for r in rows if r["bound_ms"] >= 0.5 * r["ms"]
             and (r["library_ms"] is None or r["ms"] <= r["library_ms"])]
    rows = [r for r in rows if r["name"] not in alone]
    slower = sorted((r for r in rows if r["library_ms"] and r["ms"] > r["library_ms"]),
                    key=lambda r: r["ms"] / r["library_ms"], reverse=True)
    rest = sorted((r for r in rows if r not in slower),
                  key=lambda r: (r["launches"] or 0) * (r["ms"] - r["bound_ms"]), reverse=True)
    out = [{"name": r["name"], "ms": r["ms"], "library_ms": r["library_ms"],
            "factor": r["ms"] / r["library_ms"]} for r in slower]
    out += [{"name": r["name"], "ms": r["ms"], "bound_ms": r["bound_ms"],
             "launches": r["launches"],
             "loss_ms": (r["launches"] or 0) * (r["ms"] - r["bound_ms"])} for r in rest]
    log(f"step-2 order (skipped, redesigned: {', '.join(skipped)}; left alone, at half "
        f"their bound or more: {', '.join(alone) or 'none'}): " + "; ".join(
            f"{o['name']} " + (f"{o['factor']:.2f}x its library call" if "factor" in o
                               else f"{o['loss_ms']:.3f} ms lost ({o['launches']} launches)")
            for o in out[:6]))
    return {"skipped": skipped, "left_alone": alone, "order": out}


def kfork_bound(evaluate: dict, rows: list, row_bounds: dict) -> dict:
    """The profiled K-fork evaluate's bound: the sum over its launches of
    each kernel's least time a launch — K1 and K2 on one pod's row (the scan's
    step, ``row_bounds``), every other kernel at its timing row's shape."""
    per = {r["name"]: r["bound_ms"] / 1.0 for r in rows}
    per.update({k_: v["bound_ms"] for k_, v in row_bounds.items()})
    terms = {k_: n * per[k_] for k_, n in evaluate["launches"].items() if k_ in per}
    missing = sorted(k_ for k_ in evaluate["launches"] if k_ not in per)
    out = {"bound_ms": sum(terms.values()), "terms_ms": terms, "launches":
           evaluate["launches"], "no_row": missing, "device_busy_ms": evaluate["device_busy_ms"]}
    log(f"K-fork evaluate ({evaluate['forks']} forks): bound {out['bound_ms']:.5f} ms, the sum "
        f"of its launches' bounds ({evaluate['launches']}); on the card "
        f"{evaluate['device_busy_ms']:.3f} ms" + (f"; no bound for {missing}" if missing else ""))
    return out


def _controller_harness(suite: str, out_dir: Path, dev_name: str, inspect_more,
                        created=None) -> tuple:
    """``suite``/5000Nodes through ``perf.harness.run_workload`` with launch
    counts zeroed just before and read in ``inspect``; → (items by metric,
    record).  ``created``, when given, collects the nodes each scale-up
    apply created (the autoscaler's decisions of every sync)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import data_items_to_json, run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    seen = {}

    def inspect(store, sched, ctrl):
        torch.cuda.synchronize()
        seen["launches"] = dict(kernels.LAUNCHES)
        seen["phase_wall_s"] = dict(sched.phase_wall)
        seen.update(inspect_more(store, sched, ctrl))

    fresh_heap()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.perf_counter()
    w = build_workload(suite, "5000Nodes")
    if created is not None:
        make = w.make_descheduler

        def make_logged(store, sched):
            ctrl = make(store, sched)
            sync = ctrl.sync_once

            def sync_once():
                ctrl.last_decisions = []
                changed = sync()
                created.extend(d.count for d in ctrl.last_decisions if d.direction == "up"
                               and d.result in ("applied", "error"))
                return changed

            ctrl.sync_once = sync_once
            return ctrl

        w.make_descheduler = make_logged
    items = run_workload(w, device=dev_name, inspect=inspect)
    wall = time.perf_counter() - t
    by = {it.labels["Metric"]: it.data for it in items}
    win = by["KernelLaunchesInWindow"]
    if by["KernelBuildsInWindow"]["Count"] != 0:
        fail(f"{suite} harness: a kernel was built inside the measured window")
    tfs = by["TimeToFullSlice"]
    rec = {"items": json.loads(data_items_to_json(items)), "wall_s": wall,
           "batch_size": w.batch_size, "pods_per_s": by["SchedulingThroughput"]["Average"],
           "gangs_per_s": by["GangThroughput"]["Average"],
           "gangs": by["GangThroughput"]["Gangs"],
           "time_to_full_slice_p50_s": tfs["Perc50"], "time_to_full_slice_p99_s": tfs["Perc99"],
           "whatif_forks": by["WhatIfForks"]["Count"],
           "whatif_forks_per_s": by["WhatIfForks"]["PerSecond"],
           "window_launches": win, "window_phase_wall_s": by["PhaseWallBreakdown"],
           **seen}
    return by, rec


def defrag_harness(out_dir: Path, dev_name: str = "cuda") -> dict:
    """Defrag/5000Nodes through ``run_workload`` (5000 hosts in 8-host
    slices, each fragmented by a pre-bound straggler; 312 gangs of 8; B =
    512; the descheduler driven once per measured cycle): every gang bound
    whole inside one slice, no gang member evicted, 8 evictions per freed
    slice, K30 launched inside the window; pods/s, time to full slice,
    evictions and forks per second, and one profiled evaluate of 4 forks."""

    def more(store, sched, ctrl):
        out = {"checks": defrag_checks("Defrag harness", store, ctrl),
               "planner_solves": len(ctrl.planner.durations),
               "planner_s": sum(ctrl.planner.durations),
               "plans": {f"{a}/{b}": v for (a, b), v in ctrl.plans.items()}}
        from kubernetes_tpu_torch import whatif

        pending, forks = _straggler_forks(store, whatif)
        out["profile_evaluate"] = profile_evaluate(ctrl.planner.engine, pending, forks,
                                                   out_dir, "profile_evaluate.txt")
        return out

    by, rec = _controller_harness("Defrag", out_dir, dev_name, more)
    win = rec["window_launches"]
    for k_ in PATH_KERNELS[:4] + ("gang_all_or_nothing", "fork_masks"):
        if win[k_] <= 0:
            fail(f"Defrag harness: kernel {k_} never launched in the measured window")
    if rec["gangs"] != 312 or rec["checks"]["gangs"] != 312:
        fail(f"Defrag harness: {rec['gangs']:.0f} of 312 gangs whole in the window")
    ev = by["DeschedulerEvictions"]
    rec.update(evictions=ev["Count"], evictions_per_s=ev["PerSecond"])
    log(f"Defrag/5000Nodes via perf.harness.run_workload (pipelined, B = {rec['batch_size']}):"
        f" {rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} gangs/s; time to full "
        f"slice p50 {rec['time_to_full_slice_p50_s']:.3f} s, p99 "
        f"{rec['time_to_full_slice_p99_s']:.3f} s; {ev['Count']:.0f} evictions "
        f"({ev['PerSecond']:.2f}/s) freeing {rec['checks']['freed_slices']} slices; "
        f"{rec['whatif_forks']:.0f} what-if forks ({rec['whatif_forks_per_s']:.2f}/s) over "
        f"{rec['planner_solves']} planner solves ({rec['planner_s']:.2f} s); window launches "
        + ", ".join(f"{k_} {win[k_]:.0f}" for k_ in ("fork_masks", "auction_resolve_commit",
                                                      "gang_all_or_nothing")))
    return rec


def autoscale_harness(out_dir: Path, dev_name: str = "cuda") -> dict:
    """AutoscaleGang/5000Nodes through ``run_workload`` (1200 initial hosts,
    600 gangs of 8, B = 512; the cluster autoscaler driven once per
    measured cycle, adding whole slices from a NodeGroup): every gang bound
    whole, the added nodes those of the applied scale-ups, K30 and K31
    launched inside the window; pods/s, scale-ups, forks per second, time
    to full slice."""

    def more(store, sched, ctrl):
        from kubernetes_tpu_torch.autoscaler import NODE_GROUP_LABEL

        pods = store.list("Pod")[0]
        gangs = {}
        for p in pods:
            g = p.metadata.labels.get(POD_GROUP_LABEL)
            if g:
                if not p.spec.node_name:
                    fail(f"AutoscaleGang harness: gang pod {p.metadata.name} unbound")
                gangs[g] = gangs.get(g, 0) + 1
        added = sum(1 for n in store.list("Node")[0]
                    if n.metadata.labels.get(NODE_GROUP_LABEL) == "asg")
        return {"gangs_whole": sum(1 for c in gangs.values() if c == 8),
                "nodes_added": added, "node_tier": int(sched.encoder.node_valid.shape[0]),
                "decisions": {f"{a}/{b}": v for (a, b), v in ctrl.decisions.items()}}

    created = []
    by, rec = _controller_harness("AutoscaleGang", out_dir, dev_name, more, created)
    # the group's nodes: every node the scale-ups created, less those a
    # scale-down removed once the demand was met
    downs = rec["decisions"].get("down/applied", 0)
    if rec["nodes_added"] != sum(created) - downs:
        fail(f"AutoscaleGang harness: {rec['nodes_added']} group nodes, the scale-ups "
             f"created {sum(created)} and {downs} scale-downs removed nodes")
    rec["scale_up_counts"] = created
    win = rec["window_launches"]
    for k_ in PATH_KERNELS[:4] + ("gang_all_or_nothing", "fork_masks", "fork_add_rows"):
        if win[k_] <= 0:
            fail(f"AutoscaleGang harness: kernel {k_} never launched in the measured window")
    if rec["gangs"] != 600 or rec["gangs_whole"] != 600:
        fail(f"AutoscaleGang harness: {rec['gangs']:.0f} of 600 gangs whole in the window")
    ups = by["AutoscalerScaleUps"]["Count"]
    rec["scale_ups"] = ups
    log(f"AutoscaleGang/5000Nodes via perf.harness.run_workload (pipelined, B = "
        f"{rec['batch_size']}): {rec['pods_per_s']:.1f} pods/s, {rec['gangs_per_s']:.2f} "
        f"gangs/s; time to full slice p50 {rec['time_to_full_slice_p50_s']:.3f} s, p99 "
        f"{rec['time_to_full_slice_p99_s']:.3f} s; {ups:.0f} scale-ups adding "
        f"{rec['nodes_added']} nodes (node tier {rec['node_tier']}); "
        f"{rec['whatif_forks']:.0f} what-if forks ({rec['whatif_forks_per_s']:.2f}/s); "
        f"window launches " + ", ".join(f"{k_} {win[k_]:.0f}" for k_ in FORK_KERNELS))
    return rec


def whatif_bindings(device: str, suite: str):
    """``suite``/500Nodes driven synchronously with its controller on a clock
    the script moves → (bindings, evicted pods, decisions, forks, launches,
    the stacked-vs-one-by-one predictions of 4 forks on the final cluster)."""
    import torch

    from kubernetes_tpu_torch import kernels, whatif
    from kubernetes_tpu_torch.api.objects import ObjectMeta
    from kubernetes_tpu_torch.autoscaler import NodeGroup, materialize_nodes

    kernels.reset_launches()
    store, sched, ctrl, measured = _run_controlled(suite, "500Nodes", device, _FixedClock())
    if device == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    pods = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
    engine = ctrl.planner.engine if hasattr(ctrl, "planner") else ctrl.engine
    if suite == "Defrag":
        decisions = {f"{a}/{b}": v for (a, b), v in ctrl.plans.items()}
        pending, forks = _straggler_forks(store, whatif, 2)
    else:
        decisions = {f"{a}/{b}": v for (a, b), v in ctrl.decisions.items()}
        pending, forks = _straggler_forks(store, whatif, 0)
    forks = forks + [
        whatif.ForkSpec(add_nodes=materialize_nodes(
            NodeGroup(metadata=ObjectMeta(name="probe-ng", namespace="default"), max_size=64,
                      capacity={"cpu": "4", "memory": "32Gi", "pods": "110"}, slice_size=8),
            8, 0, 0, SLICE_LABEL)),
        whatif.ForkSpec(remove_nodes=[n.metadata.name for n in store.list("Node")[0]][:16])]
    vm = [p.placements for p in engine.evaluate(pending, forks, vmapped=True)]
    seq = [p.placements for p in engine.evaluate(pending, forks, vmapped=False)]
    if vm != seq:
        fail(f"{suite}/500Nodes on {device}: the stacked evaluate differs from the one-by-one")
    forks_n = engine.forks
    evicted = sorted({f"strag-{i:06d}" for i in range(512)} - set(pods)) \
        if suite == "Defrag" else []
    unbound = [n for n in measured if not pods.get(n)]
    if unbound:
        fail(f"{suite}/500Nodes on {device}: {len(unbound)} measured pods unbound")
    return pods, evicted, decisions, forks_n, vm, launches


def time_fork_kernels(masks_calls: dict, add_calls: dict, err: dict) -> list:
    """K30 on the arguments of its latest call at the largest fork count on
    the Defrag/5000Nodes harness run, K31 on those of its latest call at the
    largest fork count on the AutoscaleGang/5000Nodes run; each held once
    more, exactly, against its plain version (on CPU copies), timed as in 6;
    the bound from the bytes those inputs need.  No one PyTorch call
    computes either function."""
    import torch

    from kubernetes_tpu_torch.kernels import fork as KF
    from kubernetes_tpu_torch.state.encoding import NODE_ARRAYS

    def latest(calls, name):
        keys = [k_ for k_ in calls if k_[0] == name]
        if not keys:
            fail(f"kernel timing: no recorded path call of {name}")
        return calls[max(keys, key=lambda k_: k_[1])]

    def cpu(x):
        return _to(x, "cpu")

    rows_out = []

    def row(name, fn, plain_fn, n_bytes, n_ops, shape):
        least, bound_by = bound_ms(n_bytes, n_ops)
        rows_out.append({"name": name, "route": "cuda", "source": FORK_SOURCE,
                         "replaces": FORK_REPLACES[name], "launches": None,
                         "max_abs_err": err[name],
                         "ms": device_ms(fn, FORK_SYMBOLS[name]), "ms_source": MS_SOURCE[0],
                         "call_ms": time_ms(fn), "plain_ms": time_ms(plain_fn, reps=5, warmup=1),
                         "bound_ms": least, "bound_by": bound_by, "library_ms": None,
                         "bytes": n_bytes, "ops": n_ops, "shape": shape})

    args, kw = latest(masks_calls, "fork_masks")
    got = KF.fork_masks(*args, **kw)
    want = KF.fork_masks_plain(*cpu(list(args)), **cpu(kw))
    torch.cuda.synchronize()
    err["fork_masks"] = max(err["fork_masks"], require_equal(
        "fork_masks (path shapes)", _masks_pairs(got, want)))
    (nv, req, nz, claim, pv, preq, pnz, aff, vp, vn, ar, av, dr) = args
    chips = kw.get("vic_claim_chips")
    k = vp.shape[0]
    n, r = req.shape[-2:]
    p = pv.shape[0]
    g, d = aff.shape
    per_fork = req.dim() == 3
    live_v = int((vp >= 0).sum())
    n_bytes, n_ops = KW.k30_work(args, kw)
    row("fork_masks", lambda: KF.fork_masks(*args, **kw),
        lambda: KF.fork_masks_plain(*args, **kw), n_bytes, n_ops,
        {"K": k, "N": n, "P": p, "R": r, "G": g, "D": d, "V": vp.shape[1],
         "A": ar.shape[1], "D_rows": dr.shape[1], "live_victims": live_v,
         "claim_plane": chips is not None, "node_arrays_per_fork": per_fork})

    args, kw = latest(add_calls, "fork_add_rows")
    arrays, rows, ok, vals = args
    got = KF.fork_add_rows(*args, **kw)
    want = KF.fork_add_rows_plain(cpu(list(arrays)), rows.cpu(), ok.cpu(), cpu(list(vals)))
    torch.cuda.synchronize()
    err["fork_add_rows"] = max(err["fork_add_rows"], require_equal(
        "fork_add_rows (path shapes)",
        [(nm, a.cpu(), b) for nm, a, b in zip(NODE_ARRAYS, got, want)]))
    k, m = rows.shape
    n = arrays[0].shape[0]
    row_bytes = sum(a[0].numel() * a.element_size() for a in arrays)
    # the base read once, the K copies written once, each real add's payload
    # row read once (K31 never reads a pad's row), and rows / ok read for
    # every slot
    n_bytes = n * row_bytes + k * n * row_bytes + int(ok.sum()) * row_bytes + k * m * 5
    row("fork_add_rows", lambda: KF.fork_add_rows(*args, **kw),
        lambda: KF.fork_add_rows_plain(*args, **kw), n_bytes, 0,
        {"K": k, "N": n, "M": m, "real_adds": int(ok.sum()), "row_bytes": row_bytes})
    for rr in rows_out:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['ms_source']}; {rr['call_ms']:.4f} "
            f"ms a call), bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain "
            f"{rr['plain_ms']:.4f} ms; {rr['shape']}")
    return rows_out


# --- phase 7: where one cycle's device time goes ----------------------------------------


# --- K32, Fit's strategies in K1, and the profiles path ----------------------------

K1_SOURCE = "kubernetes_tpu_torch/csrc/filter_score.cu"
K32_SOURCE = "kubernetes_tpu_torch/csrc/selectorspread.cu"
K32_REPLACES = "kubernetes_tpu/plugins/selectorspread.py:109"
FIT_REPLACES = "kubernetes_tpu/plugins/noderesources.py:82"
PROFILE_NAMES = ("default-scheduler", "bin-packing", "rtcr")
FIT_STRATEGIES = {"bin-packing": "MostAllocated", "rtcr": "RequestedToCapacityRatio"}
PROFILE_TARGETS = {
    "selector_spread_score": ("kubernetes_tpu_torch.plugins.selectorspread",
                              "selector_spread_score", None),
    "filter_score_planes": (RT, "filter_score_planes", None),
}


def profile_key(name, args):
    """K32's latest call on [C, N] rows and on one row; K1's latest call under
    each Fit strategy (on rows and on one row)."""
    one_row = args[0].shape[0] == 1 if name == "selector_spread_score" \
        else args[0].valid.shape[0] == 1
    if name == "filter_score_planes":
        return (name, args[-1].strategy, one_row)
    return (name, one_row)


def fit_plan(fs_plan, strategy: str, shape=None):
    """``fs_plan`` with a Fit plugin of ``strategy`` (and shape points)."""
    import dataclasses

    from kubernetes_tpu_torch.plugins.noderesources import FitPlugin

    return dataclasses.replace(fs_plan, fit=FitPlugin(strategy, shape=shape))


def k32_case(gen, c: int, n: int, *, maxima=None, kind=None):
    """K32's inputs: bits (a 0.7 mask of ``full`` = 7), count and zone-count
    planes with row maxima up to 399 (or the given per-row ``maxima`` over
    every count 0..max), has_zone with holes; an all-masked row and rows
    without zone counts.  ``kind``: "all" every entry in the mask, "none"
    no entry in it, "zero counts" every count 0 (max 0: each score 100),
    "zero zones" every zone count 0."""
    import torch

    if maxima is not None:
        c, n = len(maxima), max(maxima) + 1
        counts = torch.zeros((c, n))
        zone = torch.zeros((c, n))
        mask = torch.zeros((c, n), dtype=torch.bool)
        for i, m in enumerate(maxima):
            counts[i, : m + 1] = torch.arange(m + 1).float()
            zone[i, : m + 1] = torch.round(torch.linspace(0, 3 * m, m + 1))
            mask[i, : min(i + 2, m + 1)] = True
    else:
        mx = torch.randint(1, 400, (c, 1), generator=gen).float()
        counts = torch.floor(torch.rand((c, n), generator=gen) * (mx + 1))
        zone = torch.floor(torch.rand((c, n), generator=gen) * (3 * mx + 1))
        mask = torch.rand((c, n), generator=gen) < 0.7
        if c > 8:
            zone[:4] = 0
            mask[5] = False
        if kind == "all":
            mask[:] = True
        elif kind == "none":
            mask[:] = False
        elif kind == "zero counts":
            counts.zero_()
        elif kind == "zero zones":
            zone.zero_()
    has_zone = torch.rand(n, generator=gen) < 0.8
    bits = torch.where(mask, 7, 3).to(torch.int32)
    total = torch.where(mask, torch.randint(0, 600, (c, n), generator=gen).float(),
                        float("-inf"))
    return bits, 7, total, counts, zone, has_zone


def k32_plan_check() -> None:
    """K32's split plan in csrc/selectorspread.cu (``selector_spread_split_plan``)
    equal to the copy in ``kernel_work.k32_plan`` that the CPU mirror takes
    its slices from."""
    import ctypes

    from kubernetes_tpu_torch.kernels.build import load

    fn = load("selectorspread").selector_spread_split_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    differ = []
    for n in (1, 4, 31, 500, 1000, 1024, 1025, 4097, 5000, 8190, 8191, 8192, 100000):
        for vec in (1, 4):
            fn(n, vec, out)
            if tuple(out) != KW.k32_plan(n, vec):
                differ.append((n, vec, tuple(out), KW.k32_plan(n, vec)))
    if differ:
        fail(f"selector_spread_split_plan differs from kernel_work.k32_plan: {differ}")
    else:
        log("selector_spread_score: the kernel's plan equals kernel_work.k32_plan")


# K32's exact checks: label → k32_case's arguments (the split form at C <= 16:
# vectors with a scalar tail at N = 8190 and C = 1, the scalar form where C >
# 1 rows do not start on 16-byte boundaries, one block at N = 1000, more than
# a vector a thread at N = 100000; one block a row at C = 17 and 512)
K32_CHECKS = {"C=512": {"c": 512, "n": 8192}, "C=1": {"c": 1, "n": 8192},
              "maxima 1-399": {"c": 0, "n": 0, "maxima": list(range(1, 400))},
              "C=1 N=8190 (tail)": {"c": 1, "n": 8190},
              "C=4 N=8190 (scalar form)": {"c": 4, "n": 8190},
              "C=16": {"c": 16, "n": 8192}, "C=17": {"c": 17, "n": 8192},
              "C=1 N=1000": {"c": 1, "n": 1000}, "C=1 N=100000": {"c": 1, "n": 100000},
              "C=1 all masked": {"c": 1, "n": 8192, "kind": "all"},
              "C=1 none masked": {"c": 1, "n": 8192, "kind": "none"},
              "C=1 counts 0": {"c": 1, "n": 8192, "kind": "zero counts"},
              "C=1 zone counts 0": {"c": 1, "n": 8192, "kind": "zero zones"}}


def check_profile_kernels(dev) -> dict:
    """K32 (``K32_CHECKS``: C = 512, 17, 16, 4 and 1, every row maximum
    1–399, N = 8190, 1000 and 100000, all / no entries masked, zero counts
    and zone counts; weights 1 and 2; its split plan; one launch a call at C
    = 1 and C = 512) and K1 under MostAllocated and RequestedToCapacityRatio
    (the default shape, a descending one, one with a flat segment) at C = 512
    and C = 1 over N = 8192, against their plain versions on the same CUDA
    tensors."""
    import torch

    from kubernetes_tpu_torch.framework.interface import DynamicState
    from kubernetes_tpu_torch.kernels import selectorspread as KSS
    from kubernetes_tpu_torch.kernels.filter_score import (
        filter_score_planes,
        filter_score_planes_plain,
    )
    from kubernetes_tpu_torch.plugins.trivial import image_scaled_by_id

    gen = torch.Generator().manual_seed(SEED + 32)
    err = {"selector_spread_score": 0.0, "filter_score_planes": 0.0}
    cases = {"selector_spread_score": 0, "filter_score_planes": 0}
    k32_plan_check()
    for what, kw in K32_CHECKS.items():
        case = [t.to(dev) if isinstance(t, torch.Tensor) else t for t in k32_case(gen, **kw)]
        bits, full, total, counts, zone, has_zone = case
        for weight in (1.0, 2.0):
            got = KSS.selector_spread_score(bits, full, total.clone(), counts, zone, has_zone,
                                            weight)
            want = KSS.selector_spread_score_into_plain(bits, full, total.clone(), counts, zone,
                                                        has_zone, weight)
            torch.cuda.synchronize()
            err["selector_spread_score"] = max(err["selector_spread_score"], require_equal(
                f"selector_spread_score {what} w={weight}", [("total", got, want)]))
            cases["selector_spread_score"] += 1
            if kw.get("kind") == "none" and not torch.equal(got, total):
                fail("selector_spread_score with no entry masked changed the total")
    # one launch a call: the split form on the scan's row, one block a row at C = 512
    for what, c, symbol in (("C = 1", 1, "selector_spread_score_split_kernel"),
                            ("C = 512", 512, "selector_spread_score_rows_kernel")):
        bits, full, total, counts, zone, has_zone = [
            t.to(dev) if isinstance(t, torch.Tensor) else t for t in k32_case(gen, c, 8192)]
        one_device_activity(f"selector_spread_score ({what})",
                            lambda a=(bits, full, total, counts, zone, has_zone):
                            KSS.selector_spread_score(*a, 1.0),
                            symbol, "selector_spread_score")
    fw, (fs_plan, _comb) = framework_plans()
    snap = synthetic_snapshot(8192, gen, dev)
    dyn = DynamicState(requested=snap.requested, non_zero=snap.non_zero_requested)
    img = image_scaled_by_id(snap)
    for c in (512, 1):
        rep, na_mask, na_pref = synthetic_classes(max(c, 4), 8192, gen, dev)
        if c == 1:
            rep = SimpleNamespace(**{k: v[:1] for k, v in vars(rep).items()})
            na_mask, na_pref = na_mask[:1], na_pref[:1]
        for strategy, shape in (("MostAllocated", None), ("RequestedToCapacityRatio", None),
                                ("RequestedToCapacityRatio", [(0, 10), (100, 0)]),
                                ("RequestedToCapacityRatio",
                                 [(0, 0), (30, 7), (30, 2), (70, 9), (100, 3)])):
            plan = fit_plan(fs_plan, strategy, shape)
            kb, kr = filter_score_planes(rep, snap, dyn, na_mask, na_pref, img, plan)
            pb, pr = filter_score_planes_plain(rep, snap, dyn, na_mask, na_pref, img, plan)
            torch.cuda.synchronize()
            err["filter_score_planes"] = max(err["filter_score_planes"], require_equal(
                f"filter_score_planes {strategy} {shape} C={c}",
                [("bits", kb, pb), ("raw", kr, pr)]))
            cases["filter_score_planes"] += 1
            if c > 1 and len(torch.unique(kr[2])) < 10:
                fail(f"filter_score_planes {strategy}: the Fit plane is nearly flat")
    log(f"profile kernels vs plain: all equal ({json.dumps(cases)})")
    return {"selector_spread_score": err["selector_spread_score"],
            "filter_score_planes (strategies)": err["filter_score_planes"]}


def profile_factories(store):
    """schedulerName → plugins factory: the default set plus SelectorSpread at
    weight 1 with the store (upstream v1beta2's default), Fit under
    MostAllocated (the upstream "Resource Bin Packing" configuration) and
    Fit under RequestedToCapacityRatio at the default shape — the last two
    built from a KubeSchedulerConfiguration."""
    from kubernetes_tpu_torch import config
    from kubernetes_tpu_torch import plugins as P
    from kubernetes_tpu_torch.framework.interface import PluginWithWeight
    from kubernetes_tpu_torch.scheduler import default_plugins

    cfg = config.load_config({
        "apiVersion": "kubescheduler.config.k8s.io/v1beta3",
        "profiles": [{"schedulerName": name, "pluginConfig": [{
            "name": "NodeResourcesFit", "args": {"scoringStrategy": {
                "type": strat, "resources": [{"name": "cpu", "weight": 1},
                                             {"name": "memory", "weight": 1}]}}}]}
            for name, strat in FIT_STRATEGIES.items()]})
    out = {"default-scheduler": lambda d: default_plugins(d) + [
        PluginWithWeight(P.SelectorSpreadPlugin(store), 1)]}
    for name in FIT_STRATEGIES:
        out[name] = lambda d, _p=cfg.profile(name): config.build_plugins_for_profile(
            _p, domain_cap=d)
    return out


def profile_pod(prof: str, i: int, n_apps: int = 64):
    """The profiles path's pending pods: a replica of app web-(i mod 64) for
    the default profile (100m / 200Mi); hetero_pod-shaped pods of 128
    request sizes (cpu 100m + (i mod 128)m, 500Mi) for the Fit profiles."""
    from kubernetes_tpu_torch.testutil import make_pod

    if prof == "default-scheduler":
        p = (make_pod().name(f"web-{i:06d}").uid(f"web-{i:06d}").namespace("default")
             .creation_timestamp(2e6 + i).label("app", f"web-{i % n_apps}")
             .req({"cpu": "100m", "memory": "200Mi"}).obj())
    else:
        p = hetero_pod(400 * (i // 128) + i % 128, prefix=prof[:3], ts0=3e6)
    p.spec.scheduler_name = prof
    return p


def profiles_cluster(dev_name: str, n_nodes: int, n_bound: int, pipeline: bool = False,
                     n_apps: int = 64):
    """node_zoned(ZONES3) nodes, 64 Services and 64 ReplicaSets selecting
    app=web-i, ``n_bound`` replicas pre-bound unevenly (a geometric spread
    over the nodes), and 8 pods naming an unknown scheduler; a
    TorchScheduler with the three profiles (B = 512) → (store, sched)."""
    import numpy as np

    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_pod

    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=512, device=dev_name, pipeline=pipeline,
                           profiles=profile_factories(store))
    sched.presize(n_nodes, n_bound + 6000)
    for i in range(n_nodes):
        store.create("Node", zoned_node(i))
    for i in range(n_apps):
        meta = v1.ObjectMeta(name=f"web-{i}", namespace="default")
        store.create("Service", v1.Service(metadata=meta, selector={"app": f"web-{i}"}))
        store.create("ReplicaSet", v1.ReplicaSet(
            metadata=v1.ObjectMeta(name=f"web-{i}", namespace="default"),
            selector=v1.LabelSelector(match_labels={"app": f"web-{i}"})))
    rng = np.random.default_rng(SEED)
    for k in range(n_bound):
        node = min(int(rng.geometric(8.0 / n_nodes)), n_nodes) - 1
        store.create("Pod", make_pod().name(f"rep-{k:06d}").uid(f"rep-{k:06d}")
                     .namespace("default").label("app", f"web-{k % n_apps}")
                     .req({"cpu": "100m", "memory": "200Mi"})
                     .node(f"node-{node:06d}").obj())
    for i in range(8):
        p = default_pod(i, "nobody")
        p.spec.scheduler_name = "someone-else"
        store.create("Pod", p)
    return store, sched


SCAN_WAVE = "default-scheduler (scan)"


def run_profile_waves(store, sched, sizes, scan: int) -> dict:
    """Each profile's pods created and scheduled to idle in turn, then
    ``scan`` more default-scheduler replicas under ``assign_mode="scan"``
    (the route a coupled default-scheduler batch takes; K32 at C = 1 in
    every step) → per wave: pods, wall, pods/s, the engine route of each
    dispatch, the kernels' launches in it, its host_prepare wall, the
    nodes its pods landed on."""
    import torch

    from kubernetes_tpu_torch import kernels

    routes = route_counter(sched)
    out = {}
    waves = [(prof, prof, count, 0) for prof, count in zip(PROFILE_NAMES, sizes)]
    waves.append((SCAN_WAVE, "default-scheduler", scan, 50000))
    for wave, prof, count, start in waves:
        before, r0 = dict(kernels.LAUNCHES), len(routes)
        hp0 = sched.phase_wall["host_prepare"]
        pods = [profile_pod(prof, start + i) for i in range(count)]
        mode0 = sched.assign_mode
        if wave == SCAN_WAVE:
            sched.assign_mode = "scan"
        t0 = time.perf_counter()
        for p in pods:
            store.create("Pod", p)
        try:
            sched.run_until_idle()
        finally:
            sched.assign_mode = mode0
        if sched.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {p.metadata.name: store.get("Pod", "default", p.metadata.name).spec.node_name
               for p in pods}
        out[wave] = {"pods": count, "bound": sum(1 for v in got.values() if v),
                     "wall_s": wall, "pods_per_s": count / wall if wall > 0 else 0.0,
                     "routes": routes[r0:], "bindings": got,
                     "nodes_used": len(set(got.values()) - {""}),
                     "host_prepare_s": sched.phase_wall["host_prepare"] - hp0,
                     "launches": {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}}
    return out


def profiles_checks(what: str, store, waves) -> None:
    """Every profile's pods bound by its own profile (and no node past its
    capacity), the unknown scheduler's pods pending, SelectorSpread's
    batches on the full auction, bin-packing's on the dedup engine."""
    pods, _ = store.list("Pod")
    unknown = [p for p in pods if p.spec.scheduler_name == "someone-else"]
    if len(unknown) != 8 or any(p.spec.node_name for p in unknown):
        fail(f"{what}: the 8 pods naming an unknown scheduler did not stay pending")
    for prof, w in waves.items():
        if w["bound"] != w["pods"]:
            fail(f"{what}: {prof} bound {w['bound']} of {w['pods']} pods")
    for p in [p for p in pods if p.spec.scheduler_name != "someone-else"]:
        if not p.spec.node_name:
            fail(f"{what}: pod {p.metadata.name} unbound")
    check_bound_and_fit(what, _Bound(store))
    if set(waves["default-scheduler"]["routes"]) != {"full"}:
        fail(f"{what}: SelectorSpread batches took {waves['default-scheduler']['routes']}, "
             "not the full auction")
    if "dedup" not in waves["bin-packing"]["routes"]:
        fail(f"{what}: bin-packing batches took {waves['bin-packing']['routes']}, no dedup")
    if set(waves[SCAN_WAVE]["routes"]) != {"scan"}:
        fail(f"{what}: the scan wave took {waves[SCAN_WAVE]['routes']}")


class _Bound:
    """A store view of the bound pods only (check_bound_and_fit's input)."""

    def __init__(self, store):
        self._store = store

    def list(self, kind):
        objs, rv = self._store.list(kind)
        return [o for o in objs if o.spec.node_name], rv


def profiles_path(dev_name: str = "cuda", pipeline: bool = False, out_dir: Path = None) -> dict:
    """The profiles path at full width: 5000 node_zoned(ZONES3) nodes, 1000
    pre-bound replicas, then 2048 replicas under default-scheduler (+
    SelectorSpread), 2048 under bin-packing, 1024 under rtcr, B = 512, and
    512 more default-scheduler replicas through the exact scan; the launch
    counts zeroed just before and read just after.  With
    ``out_dir``, one more default-scheduler cycle of 512 replicas under
    torch.profiler (its device idle share)."""
    from kubernetes_tpu_torch import kernels

    store, sched = profiles_cluster(dev_name, 5000, 1000, pipeline=pipeline)
    phase0 = dict(sched.phase_wall)
    kernels.reset_launches()
    waves = run_profile_waves(store, sched, (2048, 2048, 1024), scan=512)
    launches = dict(kernels.LAUNCHES)
    what = "profiles path" + (" (pipelined)" if pipeline else "")
    profiles_checks(what, store, waves)
    need = {"default-scheduler": ("filter_score_planes", "selector_spread_score",
                                  "normalize_combine", "topk_rows", "auction_resolve_commit"),
            "bin-packing": ("filter_score_planes", "normalize_combine"),
            "rtcr": ("filter_score_planes", "normalize_combine"),
            SCAN_WAVE: ("filter_score_planes", "selector_spread_score", "scan_select_assume")}
    for prof, ks in need.items():
        for k in ks:
            if waves[prof]["launches"][k] <= 0:
                fail(f"{what}: kernel {k} never launched in the {prof} wave")
    for prof in FIT_STRATEGIES:
        if waves[prof]["launches"]["selector_spread_score"]:
            fail(f"{what}: K32 launched in the {prof} wave (no SelectorSpread there)")
    hp = sched.phase_wall["host_prepare"] - phase0["host_prepare"]
    rec = {"launches": launches, "host_prepare_s": hp,
           "phase_wall_s": {k: sched.phase_wall[k] - phase0[k] for k in sched.phase_wall},
           "waves": {p: {k: v for k, v in w.items() if k != "bindings"}
                     for p, w in waves.items()}}
    for prof, w in waves.items():
        log(f"{what}, {prof}: {w['pods']} pods in {w['wall_s']:.2f} s = "
            f"{w['pods_per_s']:.1f} pods/s on {w['nodes_used']} nodes; routes {w['routes']}; "
            f"K1 {w['launches']['filter_score_planes']}, K32 "
            f"{w['launches']['selector_spread_score']}")
    log(f"{what}: host_prepare {hp:.3f} s (by wave: "
        + ", ".join(f"{p} {w['host_prepare_s']:.3f}" for p, w in waves.items())
        + f"); the 8 unknown-scheduler pods pending; launches K1 "
        f"{launches['filter_score_planes']}, K32 {launches['selector_spread_score']}")
    if out_dir is not None:
        rec["profile"] = profile_cycle(
            sched, out_dir, "profiles path default-scheduler (SelectorSpread)",
            lambda i: profile_pod("default-scheduler", 100000 + i), "profile_profiles_cycle.txt")
    sched.close()
    return {"record": rec, "waves": waves}


def profiles_bindings(device: str):
    """The profiles path cut to 1000 nodes (200 pre-bound, 512 + 512 + 256
    pods, 256 through the scan) → (bindings by wave, routes by wave,
    launches)."""
    from kubernetes_tpu_torch import kernels

    store, sched = profiles_cluster(device, 1000, 200)
    kernels.reset_launches()
    waves = run_profile_waves(store, sched, (512, 512, 256), scan=256)
    profiles_checks(f"profiles cut to 1000 nodes ({device})", store, waves)
    sched.close()
    return ({p: w["bindings"] for p, w in waves.items()},
            {p: w["routes"] for p, w in waves.items()}, dict(kernels.LAUNCHES))


def mixed_churn_harness(dev_name: str, size: str):
    """SchedulingWithMixedChurn/``size`` through ``perf.harness.run_workload``
    (the churn hook before every measured cycle) → (summary, bindings,
    launches in the run)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    w = build_workload("SchedulingWithMixedChurn", size)
    seen = {}

    def inspect(store, _sched, _ctrl):
        seen["pods"] = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}

    kernels.reset_launches()
    items = run_workload(w, device=dev_name, inspect=inspect)
    launches = dict(kernels.LAUNCHES)
    measured = [w.ops[-1].pod_template(i).metadata.name for i in range(w.ops[-1].count)]
    unbound = [n for n in measured if not seen["pods"].get(n)]
    if unbound:
        fail(f"SchedulingWithMixedChurn/{size} on {dev_name}: {len(unbound)} measured pods "
             f"unbound")
    churn = {n: v for n, v in seen["pods"].items() if n.startswith("churn-pod")}
    if not churn or not any(churn.values()):
        fail(f"SchedulingWithMixedChurn/{size} on {dev_name}: no churn pod bound")
    return harness_summary(items), seen["pods"], launches


def time_profile_kernels(last_calls: dict, waves: dict, err: dict) -> list:
    """K32 on the arguments of its latest [C, N] call and its latest
    one-row (scan step) call on the profiles path's synchronous run, and
    K1 on those of its latest call under MostAllocated and under
    RequestedToCapacityRatio there (and, beside each, the same call under
    LeastAllocated), timed as in 6 and held once more against their plain
    versions; the bounds from those inputs."""
    import torch

    from kubernetes_tpu_torch.kernels import selectorspread as KSS
    from kubernetes_tpu_torch.kernels.filter_score import (
        filter_score_planes,
        filter_score_planes_plain,
    )
    from kubernetes_tpu_torch.plugins.noderesources import STRATEGY_CODE

    rows_out = []

    def last(key):
        got = last_calls.get(key)
        if got is None:
            fail(f"kernel timing: no recorded profiles-path call of {key}")
        return got[0]

    def row(name, err_key, src, replaces, symbol, fn, plain_fn, n_bytes, n_ops, shape,
            launches):
        least, bound_by = bound_ms(n_bytes, n_ops)
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err[err_key],
            "ms": device_ms(fn, symbol), "ms_source": MS_SOURCE[0], "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1), "bound_ms": least,
            "bound_by": bound_by, "library_ms": None, "bytes": n_bytes, "ops": n_ops,
            "shape": shape})

    # K32: the bound from kernel_work.k32_work; the scan's row runs the split
    # form, the full auction's rows one block a row
    for one_row, wave in ((False, "default-scheduler"), (True, SCAN_WAVE)):
        bits, full, total, counts, zone, has_zone, weight = last(
            ("selector_spread_score", one_row))
        base = total.clone()
        got = KSS.selector_spread_score(bits, full, base.clone(), counts, zone, has_zone, weight)
        want = KSS.selector_spread_score_into_plain(bits, full, base.clone(), counts, zone,
                                                    has_zone, weight)
        err["selector_spread_score"] = max(err["selector_spread_score"], require_equal(
            f"selector_spread_score (path shapes, {wave})", [("total", got, want)]))
        c, n = bits.shape
        masked = int((bits == full).sum())
        work = base.clone()
        n_bytes, n_ops = KW.k32_work(bits, full, has_zone)
        row("selector_spread_score" + (" (scan row)" if one_row else ""),
            "selector_spread_score", K32_SOURCE, K32_REPLACES,
            "selector_spread_score_split_kernel" if c <= 16
            else "selector_spread_score_rows_kernel",
            lambda a=(bits, full, work, counts, zone, has_zone, weight):
                KSS.selector_spread_score(*a),
            lambda a=(bits, full, base, counts, zone, has_zone, weight):
                KSS.selector_spread_score_into_plain(*a[:2], a[2].clone(), *a[3:]),
            n_bytes, n_ops, {"C": c, "N": n, "masked": masked, "wave": wave},
            waves[wave]["launches"]["selector_spread_score"])
    for prof, strategy in FIT_STRATEGIES.items():
        args = last(("filter_score_planes", STRATEGY_CODE[strategy], False))
        bits1, raw1 = filter_score_planes(*args)
        pb, pr = filter_score_planes_plain(*args)
        err["filter_score_planes (strategies)"] = max(
            err["filter_score_planes (strategies)"], require_equal(
                f"filter_score_planes {strategy} (path shapes)",
                [("bits", bits1, pb), ("raw", raw1, pr)]))
        n_bytes, n_ops = k1_work(*args[:6], bits1, raw1)
        plan = args[-1]
        s_pts = plan.fit.shape_x.shape[0]
        cc, nn = bits1.shape
        if strategy == "RequestedToCapacityRatio":
            # per (row, node, resource) the interpolation's binary search
            # (a compare and an index step a level) and its 6 float steps
            levels = int(s_pts).bit_length()
            n_ops += cc * nn * args[1].allocatable.shape[1] * (2 * levels + 6)
        row(f"filter_score_planes ({strategy})", "filter_score_planes (strategies)",
            K1_SOURCE, FIT_REPLACES, "filter_score_kernel", lambda a=args: filter_score_planes(*a),
            lambda a=args: filter_score_planes_plain(*a), n_bytes, n_ops,
            {"C": cc, "N": nn, "strategy": strategy, "profile": prof},
            waves[prof]["launches"]["filter_score_planes"])
        # the same call under LeastAllocated: what the strategy switch costs
        least = (*args[:-1], fit_plan(plan, "LeastAllocated"))
        rows_out[-1]["least_allocated_ms"] = device_ms(
            lambda a=least: filter_score_planes(*a), "filter_score_kernel")
    for rr in rows_out:
        least = (f", LeastAllocated on the same call {rr['least_allocated_ms']:.5f} ms"
                 if "least_allocated_ms" in rr else "")
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms"
            f"{least}; {rr['shape']}; launches {rr['launches']}")
    return rows_out


ROUND_SYMBOLS = {"topk_rows": "topk_select_kernel", "auction_resolve_commit": "auction_kernel"}


def round_kernel_share(top, busy_ms: float) -> dict:
    """K3's and K4's device ms, launches and share of the busy time in a
    profiled window (``top``: (ms, count, name) by activity)."""
    out = {}
    for k_, sym in ROUND_SYMBOLS.items():
        hits = [(ms, cnt) for ms, cnt, name in top if kernel_hit(name, sym)]
        ms = sum(m for m, _ in hits)
        out[k_] = {"ms": ms, "count": sum(c_ for _, c_ in hits),
                   "share": ms / busy_ms if busy_ms else None}
    return out


def profile_cycle(sched, out_dir: Path, what: str, make_pod, fname: str,
                  n_pods: int = 512) -> dict:
    """One more cycle of ``n_pods`` pods from ``make_pod(i)`` on ``sched``'s
    cluster under torch.profiler: the cycle's wall, the device time by
    kernel name, and the device's idle share of the cycle.  A pipelined
    scheduler runs until idle under the profiler (its cycle dispatches the
    batch; a later one binds it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(n_pods):
        sched.store.create("Pod", make_pod(i))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's one-off start-up cost
        (torch.ones(8, device="cuda") + 1).sum().item()
    torch.cuda.synchronize()
    r0 = sched.rounds_total
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        stats = sched.run_until_idle() if sched.pipeline else sched.schedule_cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    if stats.scheduled != n_pods:
        fail(f"profiled {what} cycle scheduled {stats.scheduled} of {n_pods}")

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(((dev_us(e) / 1e3, e.count, e.key) for e in events), reverse=True)
    rounds = sched.rounds_total - r0
    lines = [f"one {what} cycle ({rounds} rounds) under torch.profiler: wall "
             f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms",
             f"{'device ms':>10} {'count':>6}  name"]
    lines += [f"{ms:10.4f} {cnt:6d}  {name}" for ms, cnt, name in top]
    (out_dir / fname).write_text("\n".join(lines) + "\n")
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "rounds": rounds,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "top": [[ms, cnt, name] for ms, cnt, name in top[:12]],
           "round_kernels": round_kernel_share(top, busy_ms)}
    if busy_ms:
        log(f"profiled {what} cycle ({rounds} rounds): wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.3f} ms (idle share {rec['device_idle_share']:.4f}); top: "
            + "; ".join(f"{name[:40]} {ms:.3f} ms" for ms, _, name in top[:6])
            + "; K3 / K4: " + ", ".join(
                f"{k_} {v['ms']:.4f} ms x {v['count']} ({v['share']:.3f} of busy)"
                for k_, v in rec["round_kernels"].items()))
    else:
        log(f"profiled {what} cycle: the profiler recorded no device time (not measured)")
    return rec


# --- phase 4b: the full auction and the exact scan at full width -----------------------

# K1/K2 and the engine's own kernels on each engine's path
SCAN_PATH_KERNELS = ("filter_score_planes", "normalize_combine", "scan_select_assume")
FULL_PATH_KERNELS = ("filter_score_planes", "normalize_combine", "topk_rows",
                     "auction_resolve_commit")


def dual_node(i: int):
    """A 4-cpu / 32Gi / 110-pod node in one of three zones, with its own hostname."""
    from kubernetes_tpu_torch.testutil import make_node

    return (make_node().name(f"node-{i:06d}")
            .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"})
            .label(ZONE_KEY, ZONES3[i % len(ZONES3)]).label(HOST_KEY, f"node-{i:06d}").obj())


def hetero_pod(i: int, prefix: str = "het", ts0: float = 0.0):
    """The heterogeneous backlog's pod: cpu 100m + (i mod 400)m, 500Mi — a
    512-pod batch holds 400 identity classes."""
    from kubernetes_tpu_torch.testutil import make_pod

    return (make_pod().name(f"{prefix}-{i:06d}").uid(f"{prefix}-{i:06d}")
            .namespace("default").creation_timestamp(ts0 + i)
            .req({"cpu": f"{100 + i % 400}m", "memory": "500Mi"}).obj())


def hetero_cluster(dev_name: str, n_nodes: int, n_first: int, clock=None,
                   pipeline: bool = False, **sched_kw):
    """n_nodes 4-cpu / 32Gi / 110-pod nodes and no pod scheduled first —
    → the scheduler."""
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    store = ObjectStore()
    for i in range(n_nodes):
        store.create("Node", host_node(i))
    kw = {} if clock is None else {"clock": clock, "batch_wait": 0}
    sched = TorchScheduler(store, batch_size=512, device=dev_name, pipeline=pipeline, **kw,
                           **sched_kw)
    sched.presize(n_nodes, n_first + 2560)
    return sched


# name → (cluster maker (device, nodes, first pods, clock, pipeline), scheduler
# kwargs, measured pod maker, (nodes, first pods, measured pods) at full width and
# cut for the cuda-vs-cpu check, the engine every measured batch takes, the
# kernels the path must launch, the constraint checked)
ENGINE_PATHS = {
    "TopologySpreading scan": (
        spread_cluster, {"assign_mode": "scan"}, lambda i, t="": spread_pod(i, "sc" + t),
        (5000, 5000, 2000), (1000, 200, 512), "scan",
        SCAN_PATH_KERNELS + ("spread_filter_bits", "spread_score_combine",
                             "spread_update_row"), "zones"),
    "TopologySpreading priority 10": (
        spread_cluster, {}, lambda i, t="": spread_pod(i, "p10" + t, priority=10),
        (5000, 5000, 2000), (1000, 200, 512), "scan",
        SCAN_PATH_KERNELS + ("spread_filter_bits", "spread_score_combine",
                             "spread_update_row"), "zones"),
    "TopologySpreading priority 10, full auction": (
        spread_cluster, {"assign_mode": "batch"},
        lambda i, t="": spread_pod(i, "pb" + t, priority=10),
        (5000, 5000, 512), (1000, 200, 128), "full",
        FULL_PATH_KERNELS + ("spread_filter_bits", "spread_score_combine",
                             "spread_update_classes"), "zones"),
    "SchedulingPodAntiAffinity priority 10": (
        lambda dev, n, f, clock=None, pipeline=False, **kw: affinity_cluster(
            dev, "SchedulingPodAntiAffinity", n, f, clock=clock, pipeline=pipeline, **kw),
        {}, lambda i, t="": affinity_pod("anti", i, "sched-1", ts0=1e6, tag=t, priority=10),
        (5000, 1000, 1000), (1000, 200, 512), "full",
        FULL_PATH_KERNELS + ("ipa_filter_bits", "ipa_score_combine", "ipa_update_classes"),
        "anti"),
    "SchedulingPreferredPodAffinity scan": (
        lambda dev, n, f, clock=None, pipeline=False, **kw: affinity_cluster(
            dev, "SchedulingPreferredPodAffinity", n, f, clock=clock, pipeline=pipeline, **kw),
        {"assign_mode": "scan"},
        lambda i, t="": affinity_pod("preferred", i, "sched-1", ts0=1e6, tag=t),
        (5000, 5000, 1000), (1000, 200, 512), "scan",
        SCAN_PATH_KERNELS + ("ipa_filter_bits", "ipa_score_combine", "ipa_update_row"), None),
    "SchedulingPodAffinity scan": (
        lambda dev, n, f, clock=None, pipeline=False, **kw: affinity_cluster(
            dev, "SchedulingPodAffinity", n, f, clock=clock, pipeline=pipeline, **kw),
        {"assign_mode": "scan"},
        lambda i, t="": affinity_pod("affinity", i, "sched-1", ts0=1e6, tag=t),
        (5000, 5000, 1000), (1000, 200, 512), "scan",
        SCAN_PATH_KERNELS + ("ipa_filter_bits", "ipa_update_row"), "zone1"),
    "heterogeneous backlog": (
        hetero_cluster, {}, lambda i, t="": hetero_pod(i, "het" + t),
        (5000, 0, 2048), (1000, 0, 512), "full", FULL_PATH_KERNELS, None),
}


def route_counter(sched) -> list:
    """Record each dispatch's engine ("scan", "full" or "dedup") on this
    scheduler instance."""
    routes = []
    orig = sched._fused_cycle

    def fused_cycle(batch, mode, classes, *a, **kw):
        routes.append("scan" if mode == "scan" else ("dedup" if classes is not None else "full"))
        return orig(batch, mode, classes, *a, **kw)

    sched._fused_cycle = fused_cycle
    return routes


def check_constraint(what: str, check, sched, pods) -> str:
    if check == "zones":
        zc = zone_counts(pods, ENGINE_PREFIX[what])
        if max(zc) - min(zc) > 5:
            fail(f"{what}: zone skew {zc} exceeds maxSkew 5")
        return f"zone counts {zc} within maxSkew 5"
    placed = [p.spec.node_name for p in pods]
    if check == "anti":
        green = [p.spec.node_name for p in pods if p.metadata.labels.get("color") == "green"]
        if len(set(green)) != len(green):
            fail(f"{what}: two green pods share a host")
        return f"{len(green)} green pods on {len(set(green))} hosts"
    if check == "zone1":
        zone = {n.metadata.name: n.metadata.labels.get(ZONE_KEY)
                for n in sched.store.list("Node")[0]}
        if any(zone[name] != "zone1" for name in placed):
            fail(f"{what}: a blue pod landed outside zone1")
        return "every blue pod in zone1"
    return "every pod bound within its node's capacity"


ENGINE_PREFIX = {"TopologySpreading scan": "sc-", "TopologySpreading priority 10": "p10-",
                 "TopologySpreading priority 10, full auction": "pb-"}


def engine_path(dev_name: str, what: str, out_dir: Path, pipeline: bool = False,
                recorder=None) -> dict:
    """One engine path at full width: the cluster, its first pods through
    the path, then the measured pods with the launch counts zeroed just
    before them (and the recorder, when given, keeping the latest kernel
    arguments); every measured pod bound, no node oversubscribed, the
    path's constraint held, every measured batch through the expected
    engine, its kernels launched; then one profiled cycle."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels

    build_cluster, kw, make_pod, (n_nodes, n_first, n_pods), _cut, engine, need, check = \
        ENGINE_PATHS[what]
    label = what + (" (pipelined)" if pipeline else "")
    fresh_heap()
    t0 = time.perf_counter()
    sched = build_cluster(dev_name, n_nodes, n_first, pipeline=pipeline, **kw)
    for i in range(n_pods):
        sched.store.create("Pod", make_pod(i))
    setup_s = time.perf_counter() - t0
    c0, r0, rr0 = sched.cycles, sched.rounds_total, sched.round_read_s
    pw0 = dict(sched.phase_wall)
    att0 = len(sched.attempt_seconds)
    carried0 = sched.carried_pods
    routes = route_counter(sched)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    with GcWatch() as gcw:
        if recorder is not None:
            with recorder:
                stats = sched.run_until_idle()
        else:
            stats = sched.run_until_idle()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    del sched._fused_cycle  # the instance wrapper: the profiled cycle runs unwrapped

    pods = check_bound_and_fit(label, sched.store)
    if stats.scheduled != n_pods:
        fail(f"{label}: scheduled {stats.scheduled} of {n_pods}")
    held = check_constraint(what, check, sched, pods)
    if set(routes) != {engine}:
        fail(f"{label}: the measured batches took {sorted(set(routes))}, not {engine}")
    for k in need + (("prev_delta_apply",) if pipeline else ()):
        if launches[k] <= 0:
            fail(f"{label}: kernel {k} never launched on the main path")
    if engine == "scan" and launches["scan_select_assume"] != n_pods:
        fail(f"{label}: {launches['scan_select_assume']} scan steps for {n_pods} pods")
    if engine == "full" and launches["scan_select_assume"]:
        fail(f"{label}: the full auction ran scan steps")
    carried = sched.carried_pods - carried0
    if pipeline and carried <= 0:
        fail(f"{label}: no placed pod reached a later dispatch as a carry")
    cycles = sched.cycles - c0
    rounds = sched.rounds_total - r0
    phase = {k: sched.phase_wall[k] - pw0[k] for k in pw0}
    att = np.asarray(sched.attempt_seconds[att0:])
    unit = "steps" if engine == "scan" else "rounds"
    rec = {
        "nodes": n_nodes, "first_pods": n_first, "pods": n_pods, "batch_size": 512,
        "engine": engine, "assign_mode": kw.get("assign_mode", "auto"), "pipeline": pipeline,
        "setup_s": setup_s, "wall_s": wall, "pods_per_s": n_pods / wall, "cycles": cycles,
        unit: rounds, f"{unit}_per_cycle": rounds / max(cycles, 1),
        f"device_ms_per_{unit[:-1]}": phase["device"] / max(rounds, 1) * 1e3,
        "host_read_s": sched.round_read_s - rr0, "phase_wall_s": phase, "constraint": held,
        "launches": launches, "routes": routes, "carried_pods": carried,
        "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
        "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
        "gc_full_collections": gcw.count, "gc_full_s": gcw.seconds,
        "node_tier": sched.encoder._n,
    }
    log(f"{label}/5000Nodes ({engine}): {n_pods} pods bound in {wall:.3f} s = "
        f"{rec['pods_per_s']:.1f} pods/s; {cycles} cycles, "
        f"{rec[f'{unit}_per_cycle']:.1f} {unit}/cycle, device half "
        f"{rec[f'device_ms_per_{unit[:-1]}']:.4f} ms per {unit[:-1]}; {held}; attempt p50 "
        f"{rec['attempt_p50_ms']:.1f} ms, p99 {rec['attempt_p99_ms']:.1f} ms; phase wall (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase.items())
        + f"; setup {setup_s:.1f} s; launches {launches}")
    fname = "profile_" + what.lower().replace(",", "").replace(" ", "_") \
        + ("_pipelined" if pipeline else "") + ".txt"
    rec["profile"] = profile_cycle(sched, out_dir, label, lambda i: make_pod(i, "prof"), fname)
    return {"record": rec, "sched": sched}


def engine_bindings(device: str, what: str):
    """A path's cluster cut for the CPU half (1000 nodes, 200 first pods,
    512 measured) — → (bindings, launches, routes)."""
    from kubernetes_tpu_torch import kernels

    build_cluster, kw, make_pod, _full, (n_nodes, n_first, n_pods), _e, _k, _c = \
        ENGINE_PATHS[what]
    t = [0.0]

    def clock():
        t[0] += 1e-6
        return t[0]

    sched = build_cluster(device, n_nodes, n_first, clock=clock, **kw)
    for i in range(n_pods):
        sched.store.create("Pod", make_pod(i))
    routes = route_counter(sched)
    kernels.reset_launches()
    while sched.schedule_cycle().attempted:
        pass
    pods, _ = sched.store.list("Pod")
    return ({p.metadata.name: p.spec.node_name for p in pods}, dict(kernels.LAUNCHES),
            routes)


def mixed_engine_bindings(device: str):
    """1000 zoned nodes with hostnames and one queue whose batches take
    every engine: zone-spread pods at priority 10 (the scan), hostname
    anti-affinity pods at priority 10 (the full auction), pod_default pods
    (the dedup engine) and the heterogeneous backlog's pods (the full
    auction) — → (bindings, launches, routes)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore

    t = [0.0]

    def clock():
        t[0] += 1e-6
        return t[0]

    store = ObjectStore()
    for i in range(1000):
        store.create("Node", dual_node(i))
    sched = TorchScheduler(store, batch_size=512, device=device, clock=clock, batch_wait=0)
    sched.presize(1000, 2560)
    for i in range(512):
        store.create("Pod", spread_pod(i, "mxs", priority=10, ts0=float(i)))
    for i in range(512):
        store.create("Pod", affinity_pod("anti", i, "sched-1", ts0=1e3, tag="mx",
                                         priority=10))
    for i in range(512):
        store.create("Pod", default_pod(i, "mxd"))
    for i in range(512):
        store.create("Pod", hetero_pod(i, "mxh", ts0=1e4))
    routes = route_counter(sched)
    kernels.reset_launches()
    while sched.schedule_cycle().attempted:
        pass
    pods, _ = store.list("Pod")
    return ({p.metadata.name: p.spec.node_name for p in pods}, dict(kernels.LAUNCHES),
            routes)


# the engine runs, in order: (path, pipelined)
ENGINE_RUNS = (
    ("TopologySpreading scan", False), ("TopologySpreading scan", True),
    ("TopologySpreading priority 10", False),
    ("TopologySpreading priority 10, full auction", False),
    ("SchedulingPodAntiAffinity priority 10", False),
    ("SchedulingPodAntiAffinity priority 10", True),
    ("SchedulingPreferredPodAffinity scan", False), ("SchedulingPodAffinity scan", False),
    ("heterogeneous backlog", False),
)
# each engine timing row → the run whose launches it reports
ENGINE_CARRIER = {
    "scan_select_assume": "TopologySpreading scan",
    "spread_update_row": "TopologySpreading scan",
    "ipa_update_row (planes)": "SchedulingPreferredPodAffinity scan",
    "ipa_update_row (tables)": "SchedulingPodAffinity scan",
    "filter_score_planes (C = 512)": "heterogeneous backlog",
    "normalize_combine (C = 512)": "heterogeneous backlog",
    "filter_score_planes (C = 1)": "TopologySpreading scan",
    "normalize_combine (C = 1)": "TopologySpreading scan",
    "spread_score_combine (C = 1)": "TopologySpreading scan",
    "spread_filter_bits (C = 1)": "TopologySpreading scan",
    "spread_filter_bits (C = 512)": "TopologySpreading priority 10, full auction",
    "topk_rows (C = 512)": "heterogeneous backlog",
    "auction_resolve_commit (C = 512)": "heterogeneous backlog",
    "ipa_update_classes (C = 512)": "SchedulingPodAntiAffinity priority 10",
    "spread_update_classes (C = 512)": "TopologySpreading priority 10, full auction",
    "ipa_score_combine (C = 1)": "SchedulingPreferredPodAffinity scan",
    "ipa_score_combine (C = 512)": "SchedulingPodAntiAffinity priority 10",
}


def rows512(args):
    return args[0].shape[0] == 512 if hasattr(args[0], "shape") \
        else args[0].valid.shape[0] == 512


def scan_recorder():
    """K17–K19's latest calls, and the latest one-row calls of K1, K2, K6,
    K7, K10 and K11 (the scan's step, for their bounds at one row)."""
    def one_batch_row(a):
        return a[0].valid.shape[0] == 1

    def one_row(a):
        return a[0].shape[0] == 1

    def one_plugin_row(a):
        return a[1].shape[0] == 1

    return KernelArgs({"scan_select_assume": (RT, "scan_select_assume", None),
                       "spread_update_row": (SPREAD_PLUGIN, "spread_update_row", None),
                       "ipa_update_row": (IPA_PLUGIN, "ipa_update_row", None),
                       "filter_score_planes": (RT, "filter_score_planes", one_batch_row),
                       "normalize_combine": (RT, "normalize_combine", one_row),
                       "spread_filter_bits": (SPREAD_PLUGIN, "spread_filter_bits",
                                              one_plugin_row),
                       "spread_score_combine": (SPREAD_PLUGIN, "spread_score_combine",
                                                one_plugin_row),
                       "ipa_filter_bits": (IPA_PLUGIN, "ipa_filter_bits", one_plugin_row),
                       "ipa_score_combine": (IPA_PLUGIN, "ipa_score_combine",
                                             one_plugin_row)},
                      seeded=("spread_filter_bits", "ipa_filter_bits"))


def b9_row_bounds(spread_calls: dict, ipa_calls: dict) -> dict:
    """The least time of K1, K2, K6 and K7 (their latest one-row calls on the
    TopologySpreading scan) and K10 and K11 (on the
    SchedulingPreferredPodAffinity scan) on one pod's row — the exact scan's
    step (B9) — by the formulas of time_kernels, time_spread_kernels and
    time_ipa_kernels at C = 1: name → {bytes, ops, bound_ms, bound_by}."""
    from kubernetes_tpu_torch.kernels.filter_score import filter_score_planes
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine

    def last(calls, name):
        got = calls.get(name)
        if got is None:
            fail(f"B9 row bounds: no recorded one-row call of {name}")
        return got[0]

    work = {}
    a1 = last(spread_calls, "filter_score_planes")
    rep, snap, dyn, na_mask, na_pref, img, _plan = a1
    bits, raw = filter_score_planes(*a1)
    work["filter_score_planes"] = k1_work(rep, snap, dyn, na_mask, na_pref, img, bits, raw)
    bits2, full2, raw2, plan2 = last(spread_calls, "normalize_combine")
    total, feas = normalize_combine(bits2, full2, raw2, plan2)
    n_feas = int(feas.sum())
    work["normalize_combine"] = (nbytes(bits2, total, feas) + 4 * raw2.shape[0] * n_feas,
                                 n_feas * raw2.shape[0] * 4)
    aux6, bits6, bit6 = last(spread_calls, "spread_filter_bits")[:3]
    n = bits6.shape[1]
    work["spread_filter_bits"] = KW.k6_work(aux6, bits6, bit6)
    work["spread_score_combine"] = k7_work(*last(spread_calls, "spread_score_combine")[:3])
    work["ipa_filter_bits"] = KW.k10_work(*last(ipa_calls, "ipa_filter_bits")[:3])
    work["ipa_score_combine"] = KW.k11_work(*last(ipa_calls, "ipa_score_combine")[:3])
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        least, bound_by = bound_ms(n_bytes, n_ops)
        out[name] = {"bytes": n_bytes, "ops": n_ops, "bound_ms": least, "bound_by": bound_by}
    log("B9 rows (one pod's row on the scans, N = "
        f"{n}): " + ", ".join(f"{k_} {v['bound_ms']:.7f} ms ({v['bound_by']})"
                              for k_, v in out.items()))
    return out


def full_recorder():
    return KernelArgs({"filter_score_planes": (RT, "filter_score_planes", rows512),
                       "normalize_combine": (RT, "normalize_combine", rows512),
                       "topk_rows": (RT, "topk_rows", rows512),
                       "auction_resolve_commit": (RT, "auction_resolve_commit", rows512),
                       "ipa_update_classes": (IPA_PLUGIN, "ipa_update_classes",
                                              lambda a: a[0].exist_anti_block.shape[0]
                                              == 512),
                       "ipa_score_combine": (IPA_PLUGIN, "ipa_score_combine",
                                             lambda a: a[1].shape[0] == 512),
                       "spread_update_classes": (SPREAD_PLUGIN, "spread_update_classes",
                                                 lambda a: a[0].match_pending.shape[0]
                                                 == 512),
                       "spread_filter_bits": (SPREAD_PLUGIN, "spread_filter_bits",
                                              lambda a: a[1].shape[0] == 512)},
                      seeded=("spread_filter_bits",))


SCAN_REPLACES = {
    "scan_select_assume": "kubernetes_tpu/framework/runtime.py:358",
    "spread_update_row": "kubernetes_tpu/plugins/podtopologyspread.py:287",
    "ipa_update_row": "kubernetes_tpu/plugins/interpodaffinity.py:447",
}
SCAN_SOURCES = {
    "scan_select_assume": "kubernetes_tpu_torch/csrc/scan.cu",
    "spread_update_row": "kubernetes_tpu_torch/csrc/spread.cu",
    "ipa_update_row": "kubernetes_tpu_torch/csrc/interpodaffinity.cu",
}


def time_engine_kernels(scan_args: dict, full_args: dict, err: dict, reuse_err: dict,
                        dev) -> list:
    """K17–K19 on the arguments of their latest call on the scan paths (K19
    in both count forms), K1, K2, K7 and K11 on the scans' one row, and
    K1–K4, K8, K11 and K12 at C = B = 512 class rows — K1–K4 on the
    heterogeneous backlog's latest full-auction round, K11 and K12 on
    SchedulingPodAntiAffinity's, K8 on TopologySpreading's at priority 10
    through the full auction: device time, the plain version's wall and the
    least time the card could take, from what these inputs need."""
    import torch

    from kubernetes_tpu_torch.kernels import interpodaffinity as KI
    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import spread as KSp
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
    from kubernetes_tpu_torch.plugins.interpodaffinity import InterPodAffinityPlugin
    from kubernetes_tpu_torch.plugins.podtopologyspread import PodTopologySpreadPlugin

    rows = []
    iplug = InterPodAffinityPlugin()

    def row(name, label, src, replaces, symbol, fn, plain_fn, n_bytes, n_ops, shape,
            max_err, library_fn=None, device_fn=None, less=None):
        # device_fn: what the device time is taken on, when not fn; less: the
        # call it begins with, taken off when the queued-events fallback
        # timed the two together
        least, bound_by = bound_ms(n_bytes, n_ops)
        ms, libs, source = ms_one_method(device_fn or fn, symbol,
                                         *([library_fn] if library_fn else []))
        if less is not None and source != "profiler":
            ms -= queued_device_ms(less)
        rows.append({
            "name": label, "kernel": name, "symbol": symbol, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": ms, "ms_source": source, "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1), "bound_ms": least,
            "bound_by": bound_by,
            "library_ms": libs[0] if libs else None,
            "bytes": n_bytes, "ops": n_ops, "shape": shape})

    # K17: kernel_work.k17_work (the bit row read once, the total on
    # feasible nodes, the step's own rows, the assume's node rows when placed)
    # the path's calls carry a 13th argument, the keyed mode's noise (None)
    (bits, full, total, i, nominated, valid, request, pod_nz, requested, node_nz, node_row,
     feas) = scan_args["scan_select_assume"][0][:12]
    n, r = requested.shape
    out = [requested.clone(), node_nz.clone(), node_row.clone(), feas.clone()]
    a17 = (bits, full, total, i, nominated, valid, request, pod_nz)
    k17 = (lambda: KS.scan_select_assume(*a17, *out))
    row("scan_select_assume", "scan_select_assume", SCAN_SOURCES["scan_select_assume"],
        SCAN_REPLACES["scan_select_assume"], "scan_select_kernel", k17,
        lambda: KS.scan_select_assume_plain(*a17, *[o.clone() for o in out]),
        *KW.k17_work(bits, full, total, i, nominated, valid, request), {"N": n, "R": r},
        err["scan_select_assume"])
    rows[-1]["host_us"] = host_issue_us(k17)
    log(f"  scan_select_assume: the host issues a call in {rows[-1]['host_us']:.2f} us "
        f"(1000 queued calls)")
    one_device_activity("scan_select_assume", k17, "scan_select_kernel", "scan_select_assume")

    # K18 (kernel_work.k18_work: pod i's match column and, per matching
    # row, the node's domain and counted bits; a read and a write per table
    # add), one device activity a call
    (aux, i, at), _ = scan_args["spread_update_row"]
    plug = PodTopologySpreadPlugin()
    work = plug.engine_copy(aux)
    b, cc, _bp = aux.match_pending.shape
    k18 = (lambda: KSp.spread_update_row(work, i, at))
    row("spread_update_row", "spread_update_row", SCAN_SOURCES["spread_update_row"],
        SCAN_REPLACES["spread_update_row"], "spread_update_row_kernel", k18,
        lambda: KSp.spread_update_row_plain(plug.engine_copy(aux), i, at),
        *KW.k18_work(aux, i, at),
        {"B": b, "Cc": cc, "N": aux.dom_val.shape[-1], "D+1": aux.hard_counts.shape[-1],
         "node": int(at.reshape(-1)[0])},
        err["spread_update_row"])
    rows[-1]["host_us"] = host_issue_us(k18)
    one_device_activity("spread_update_row", k18, "spread_update_row_kernel",
                        "spread_update_row")

    # K19, per count form: per pending row (j, t) pod i matches, the domain
    # at the node, and for planes the row's dom and count read and the
    # count written (tables: one count); pod i's own term rows read once;
    # for each pod j one of pod i's terms matches, score_dyn (and block_dyn
    # for anti-affinity) read and written on the term's domain
    for form, key in (("planes", "ipa_update_row"), ("tables", "ipa_update_row tables")):
        (aux, i, at), _ = scan_args[key]
        cnts = [getattr(aux, KI.GROUP_FIELDS[g][1]) for g in aux.present]
        if any((c_.shape[-1] == aux.exist_anti_block.shape[1]) != (form == "planes")
               for c_ in cnts):
            fail(f"ipa_update_row timing: the {key} arguments are not in the {form} form")
        node = max(int(at.reshape(-1)[0]), 0)
        n_ = aux.exist_anti_block.shape[1]
        d = aux.depth
        nbytes_, nops = 4, 0
        for g in aux.present:
            dom_f, cnt_f = KI.GROUP_FIELDS[g]
            dom, cnt = getattr(aux, dom_f), getattr(aux, cnt_f)
            cross = {"req_affinity": aux.aff_term_cross,
                     "req_anti_affinity": aux.anti_cross,
                     "pref_affinity": aux.paff_cross,
                     "pref_anti_affinity": aux.panti_cross}[g]
            col = (aux.aff_cross_all[:, i:i + 1] & aux.req_aff_valid) \
                if g == "req_affinity" else cross[:, :, i]
            dat = dom[:, :, node]
            inc = col & (dat < d)
            n_inc = int(inc.sum())
            nbytes_ += col.numel() + 4 * int(col.sum())
            if cnt.shape[-1] == n_:  # planes: the row's domains read, its domain's counts written
                n_same = int(((dom == dat[:, :, None]) & inc[:, :, None]).sum())
                nbytes_ += n_inc * 4 * n_ + 8 * n_same
                nops += n_inc * n_
            else:  # tables: one count read and written
                nbytes_ += n_inc * 8
                nops += n_inc
            same = (dom[i] == dom[i, :, node][:, None]) & (dom[i] < d)  # [T, N]
            own = cross[i]  # [T, B]: pod i's term t matches pod j
            n_cells = int(((own.t().float() @ same.float()) > 0).sum())
            nbytes_ += 4 * dom.shape[1] * n_ + own.numel() \
                + n_cells * (8 + (2 if g == "req_anti_affinity" else 0))
            nops += n_cells * dom.shape[1]
        work = iplug.engine_copy(aux)
        row("ipa_update_row", f"ipa_update_row ({form})", SCAN_SOURCES["ipa_update_row"],
            SCAN_REPLACES["ipa_update_row"], "ipa_update_row_kernel",
            lambda: KI.ipa_update_row(work, i, at),
            lambda: KI.ipa_update_row_plain(iplug.engine_copy(aux), i, at),
            nbytes_, nops,
            {"B": aux.exist_anti_block.shape[0], "N": n_, "D": d, "present": list(aux.present),
             "planes": form == "planes"}, err["ipa_update_row"])
        one_device_activity(f"ipa_update_row ({form})",
                            lambda: KI.ipa_update_row(work, i, at), "ipa_update_row_kernel",
                            "ipa_update_row")

    # the reused kernels at C = B = 512 on the heterogeneous backlog's latest
    # full-auction round (the formulas of time_kernels)
    args1, _ = full_args["filter_score_planes"]
    rep, snap, dyn, na_mask, na_pref, img, fs_plan = args1
    bits, raw = filter_score_planes(*args1)
    c, n = bits.shape
    k1_bytes, k1_ops = k1_work(rep, snap, dyn, na_mask, na_pref, img, bits, raw)
    shape = {"C": c, "N": n, "B": 512}
    row("filter_score_planes", "filter_score_planes (C = 512)",
        "kubernetes_tpu_torch/csrc/filter_score.cu", "kubernetes_tpu/framework/runtime.py:550",
        "filter_score_kernel", lambda: filter_score_planes(*args1),
        lambda: filter_score_planes_plain(*args1), k1_bytes, k1_ops, shape,
        reuse_err["filter_score_planes"])
    # K2 reads the raw planes only on feasible nodes
    (bits2, full2, raw2, plan2), _ = full_args["normalize_combine"]
    total, feas = normalize_combine(bits2, full2, raw2, plan2)
    n_feas = int(feas.sum())
    row("normalize_combine", "normalize_combine (C = 512)",
        "kubernetes_tpu_torch/csrc/normalize_combine.cu",
        "kubernetes_tpu/framework/runtime.py:550", "normalize_combine_kernel",
        lambda: normalize_combine(bits2, full2, raw2, plan2),
        lambda: normalize_combine_plain(bits2, full2, raw2, plan2),
        nbytes(bits2, total, feas) + 4 * raw2.shape[0] * n_feas,
        n_feas * raw2.shape[0] * 4, dict(shape, feasible=n_feas),
        reuse_err["normalize_combine"])
    ROUND_CALLS["normalize_combine (C = 512)"] = (
        lambda: normalize_combine(bits2, full2, raw2, plan2), "normalize_combine_kernel", {})
    # K1 on one pod's row, as the exact scan launches it every step (the
    # TopologySpreading scan's latest step)
    a1_1, _ = scan_args["filter_score_planes"]
    kb1, kr1 = filter_score_planes(*a1_1)
    pb1, pr1 = filter_score_planes_plain(*a1_1)
    err1_1 = require_equal("filter_score_planes (C = 1, path shapes)",
                           [("bits", kb1, pb1), ("raw", kr1, pr1)])
    row("filter_score_planes", "filter_score_planes (C = 1)",
        "kubernetes_tpu_torch/csrc/filter_score.cu", "kubernetes_tpu/framework/runtime.py:361",
        "filter_score_kernel", lambda: filter_score_planes(*a1_1),
        lambda: filter_score_planes_plain(*a1_1), *k1_work(*a1_1[:6], kb1, kr1),
        {"C": 1, "N": kb1.shape[1]}, max(err["filter_score_planes"], err1_1))
    one_device_activity("filter_score_planes (C = 1)", lambda: filter_score_planes(*a1_1),
                        "filter_score_kernel", "filter_score_planes")
    # K2 on one pod's row, as the exact scan launches it every step (the
    # TopologySpreading scan's latest step)
    (bits1, full1, raw1, plan1), _ = scan_args["normalize_combine"]
    total1, feas1 = normalize_combine(bits1, full1, raw1, plan1)
    pt1, pf1 = normalize_combine_plain(bits1, full1, raw1, plan1)
    err1 = require_equal("normalize_combine (C = 1, path shapes)",
                         [("total", total1, pt1), ("feasible", feas1, pf1)])
    n_feas1 = int(feas1.sum())
    row("normalize_combine", "normalize_combine (C = 1)",
        "kubernetes_tpu_torch/csrc/normalize_combine.cu",
        "kubernetes_tpu/framework/runtime.py:364", "normalize_combine_kernel",
        lambda: normalize_combine(bits1, full1, raw1, plan1),
        lambda: normalize_combine_plain(bits1, full1, raw1, plan1),
        nbytes(bits1, total1, feas1) + 4 * raw1.shape[0] * n_feas1,
        n_feas1 * raw1.shape[0] * 4, {"C": 1, "N": bits1.shape[1], "feasible": n_feas1},
        max(err["normalize_combine"], err1))
    ROUND_CALLS["normalize_combine (C = 1)"] = (
        lambda: normalize_combine(bits1, full1, raw1, plan1), "normalize_combine_kernel", {})
    # K7 on one pod's row, as the exact scan launches it every step (the
    # TopologySpreading scan's latest step)
    (aux7, bits7, full7, total7, weight7), _ = scan_args["spread_score_combine"]
    kt7, pt7 = total7.clone(), total7.clone()
    KSp.spread_score_combine(aux7, bits7, full7, kt7, weight7)
    KSp.spread_score_combine_plain(aux7, bits7, full7, pt7, weight7)
    err7 = require_equal("spread_score_combine (C = 1, path shapes)", [("total", kt7, pt7)])
    work7 = total7.clone()
    row("spread_score_combine", "spread_score_combine (C = 1)",
        "kubernetes_tpu_torch/csrc/spread.cu",
        "kubernetes_tpu/plugins/podtopologyspread.py:186", "spread_score_kernel",
        lambda: KSp.spread_score_combine(aux7, bits7, full7, work7, weight7),
        lambda: KSp.spread_score_combine_plain(aux7, bits7, full7, work7.clone(), weight7),
        *k7_work(aux7, bits7, full7),
        {"C": 1, "Cc": aux7.dom_val.shape[1], "N": bits7.shape[1],
         "soft": int(aux7.soft_valid.sum())},
        max(reuse_err["spread_score_combine"], err7))
    one_device_activity("spread_score_combine (C = 1)",
                        lambda: KSp.spread_score_combine(aux7, bits7, full7, work7, weight7),
                        "spread_score_kernel", "spread_score_combine")
    # K6 on one pod's row (the TopologySpreading scan's latest step) and at
    # C = 512 (the spread full auction's latest round), on the plane as the
    # path handed it over (the recorder's copy from before the call): each
    # timed call copies it in first and only the kernel's device time
    # counts; k6_work on that plane; ms_filtered on a plane K6 already
    # filtered (no word changes); cleared, the bits the filter took off
    for label, key, args6 in (
            ("spread_filter_bits (C = 1)", "spread_filter_bits", scan_args["spread_filter_bits"]),
            ("spread_filter_bits (C = 512)", "spread_filter_bits",
             full_args["spread_filter_bits"])):
        (aux6, bits6, bit6, md6), _ = args6
        kb6, pb6 = bits6.clone(), bits6.clone()
        KSp.spread_filter_bits(aux6, kb6, bit6, md6)
        KSp.spread_filter_bits_plain(aux6, pb6, bit6, md6)
        err6 = require_equal(f"{label}, path shapes", [("bits", kb6, pb6)])
        cleared = int((kb6 != bits6).sum())
        work6 = bits6.clone()

        def reseed(w_=work6, s_=bits6):
            w_.copy_(s_)

        def seeded6(a_=aux6, w_=work6, b_=bit6, m_=md6, r_=reseed):
            r_()
            KSp.spread_filter_bits(a_, w_, b_, m_)

        call6 = (lambda a_=aux6, w_=work6, b_=bit6, m_=md6: KSp.spread_filter_bits(a_, w_, b_, m_))
        row(key, label, "kubernetes_tpu_torch/csrc/spread.cu",
            "kubernetes_tpu/plugins/podtopologyspread.py:166", "spread_filter_kernel", call6,
            lambda a_=aux6, s_=bits6, b_=bit6, m_=md6:
            KSp.spread_filter_bits_plain(a_, s_.clone(), b_, m_),
            *KW.k6_work(aux6, bits6, bit6),
            {"C": bits6.shape[0], "Cc": aux6.dom_val.shape[1], "N": bits6.shape[1],
             "D+1": aux6.hard_counts.shape[-1], "cleared": cleared},
            max(reuse_err["spread_filter_bits"], err6), device_fn=seeded6, less=reseed)
        rows[-1]["ms_filtered"] = device_ms(call6, "spread_filter_kernel")
        rows[-1]["host_us"] = host_issue_us(call6)
        one_device_activity(label, call6, "spread_filter_kernel", "spread_filter_bits")
    # K11 on one pod's row (the SchedulingPreferredPodAffinity scan's latest
    # step) and at C = 512 (SchedulingPodAntiAffinity priority 10's latest
    # full-auction round)
    for label, args11 in (("ipa_score_combine (C = 1)", scan_args["ipa_score_combine"]),
                          ("ipa_score_combine (C = 512)", full_args["ipa_score_combine"])):
        (aux11, bits11, full11, total11, weight11), _ = args11
        kt11, pt11 = total11.clone(), total11.clone()
        KI.ipa_score_combine(aux11, bits11, full11, kt11, weight11)
        KI.ipa_score_combine_plain(aux11, bits11, full11, pt11, weight11)
        err11 = require_equal(f"{label}, path shapes", [("total", kt11, pt11)])
        work11 = total11.clone()
        row("ipa_score_combine", label, "kubernetes_tpu_torch/csrc/interpodaffinity.cu",
            "kubernetes_tpu/plugins/interpodaffinity.py:368", "ipa_score_kernel",
            lambda a_=aux11, b_=bits11, f_=full11, w_=work11, g_=weight11:
            KI.ipa_score_combine(a_, b_, f_, w_, g_),
            lambda a_=aux11, b_=bits11, f_=full11, w_=work11, g_=weight11:
            KI.ipa_score_combine_plain(a_, b_, f_, w_.clone(), g_),
            *KW.k11_work(aux11, bits11, full11),
            {"C": bits11.shape[0], "N": bits11.shape[1], "present": list(aux11.present)},
            max(reuse_err["ipa_score_combine"], err11))
    (eff, k), _ = full_args["topk_rows"]
    row("topk_rows", "topk_rows (C = 512)", "kubernetes_tpu_torch/csrc/topk_rows.cu",
        "kubernetes_tpu/framework/runtime.py:571", "topk_select_kernel",
        lambda: topk_rows(eff, k), lambda: topk_rows_plain(eff, k),
        nbytes(eff) + c * k * 8, c * n, dict(shape, K=k), reuse_err["topk_rows"],
        library_fn=lambda: torch.topk(eff, k, dim=1))
    ROUND_CALLS["topk_rows (C = 512)"] = (
        lambda: topk_rows(eff, k), "topk_select_kernel",
        {"library_ms": lambda: torch.topk(eff, k, dim=1),
         "library_sort_ms": lambda: torch.sort(eff, dim=1, descending=True, stable=True)})
    a4, _ = full_args["auction_resolve_commit"]
    kreq, knz = a4[9].clone(), a4[10].clone()
    kc, _kch = auction_resolve_commit(*a4[:9], kreq, knz)
    commits = int(kc.sum())
    cv, ci, class_t, pos_of, unres, nom, nom_ok, req_b, nz_b = a4[:9]
    rr = req_b.shape[1]
    k4_bytes = (nbytes(cv, unres, nom_ok, req_b, nz_b)
                + 4 * (ci.numel() + class_t.numel() + pos_of.numel() + nom.numel())
                + 512 * 8 + commits * (rr + 2) * 4 * 2)
    row("auction_resolve_commit", "auction_resolve_commit (C = 512)",
        "kubernetes_tpu_torch/csrc/auction.cu", "kubernetes_tpu/framework/runtime.py:603",
        "auction_kernel",
        lambda: auction_resolve_commit(*a4[:9], a4[9].clone(), a4[10].clone()),
        lambda: auction_resolve_commit_plain(*a4[:9], a4[9].clone(), a4[10].clone()),
        k4_bytes, commits * (rr + 4), dict(shape, commits=commits),
        reuse_err["auction_resolve_commit"])
    rows[-1].update(auction_iterations(a4[:9], a4[9], a4[10]))
    w_req, w_nz = a4[9].clone(), a4[10].clone()
    ROUND_CALLS["auction_resolve_commit (C = 512)"] = (
        lambda: auction_resolve_commit(*a4[:9], w_req, w_nz), "auction_kernel", {})

    # K12 at C = 512 on SchedulingPodAntiAffinity's latest full-auction round
    (aux, commit, choice, class_t), _ = full_args["ipa_update_classes"]
    work = iplug.engine_copy(aux)
    committed = torch.nonzero(commit, as_tuple=True)[0]
    c, n = aux.exist_anti_block.shape
    d = aux.depth
    k12_bytes, k12_ops = KW.k12_work(aux, commit, choice, class_t)
    row("ipa_update_classes", "ipa_update_classes (C = 512)",
        "kubernetes_tpu_torch/csrc/interpodaffinity.cu",
        "kubernetes_tpu/plugins/interpodaffinity.py:766", "ipa_update_kernel",
        lambda: KI.ipa_update_classes(work, commit, choice, class_t),
        lambda: KI.ipa_update_classes_plain(iplug.engine_copy(aux), commit, choice, class_t),
        k12_bytes, k12_ops, {"C": c, "N": n, "D": d, "commits": len(committed),
                             "present": list(aux.present)},
        reuse_err["ipa_update_classes"])

    # K8 at C = 512 on the spread full auction's latest round (k8_work), with
    # the auction's own int64 class_of; one kernel node a call through the
    # plugin's hook
    (aux8, commit, choice, class_t), _ = full_args["spread_update_classes"]
    splug = PodTopologySpreadPlugin()
    work8 = splug.engine_copy(aux8)
    c, cc, _cp = aux8.match_pending.shape
    n = aux8.dom_val.shape[-1]
    if class_t.dtype != torch.int64:
        fail(f"spread_update_classes (C = 512): the auction handed over {class_t.dtype}, "
             f"not int64")
    row("spread_update_classes", "spread_update_classes (C = 512)",
        "kubernetes_tpu_torch/csrc/spread.cu", "kubernetes_tpu/plugins/podtopologyspread.py:366",
        "spread_update_kernel",
        lambda: KSp.spread_update_classes(work8, commit, choice, class_t),
        lambda: KSp.spread_update_classes_plain(splug.engine_copy(aux8), commit, choice,
                                                class_t),
        *KW.k8_work(aux8, commit, choice, class_t),
        {"C": c, "Cc": cc, "N": n, "D+1": aux8.hard_counts.shape[-1],
         "commits": int(commit.sum())}, reuse_err["spread_update_classes"])
    one_device_activity("spread_update_classes (C = 512, identity classes, int64 class_of)",
                        lambda: splug.update_batch_classes(work8, commit, choice, class_t),
                        "spread_update_kernel", "spread_update_classes")
    return rows


# --- extenders and the keyed tie noise (K33, K17's keyed mode, K2's packed mode) ---

K33_SOURCE = "kubernetes_tpu_torch/csrc/tie_noise.cu"
K33_REPLACES = "kubernetes_tpu/framework/runtime.py:546"
K17_SOURCE = "kubernetes_tpu_torch/csrc/scan.cu"
K17_KEYED_REPLACES = "kubernetes_tpu/framework/runtime.py:299"
K2_SOURCE = "kubernetes_tpu_torch/csrc/normalize_combine.cu"
K2_PACKED_REPLACES = "kubernetes_tpu/framework/runtime.py:225"
# jax.random at jax 0.9.0 (threefry2x32, jax_threefry_partitionable=True):
# split(PRNGKey(7), 3) and the float32 words of uniform(PRNGKey(7), (8,)),
# written here so the plain version is pinned without JAX on the card's host
JAX_SPLIT_KEY7 = ((3625411723, 1954958720), (195045567, 4062205631), (966301609, 1948237315))
JAX_UNIFORM_KEY7 = (1059885352, 1064927358, 1050349136, 1055084168, 1060838242, 1059161242,
                    1055238244, 1053994408)
TIE_KEYS = ((0, 0), (0, 7), (0xFFFFFFFF, 0xFFFFFFFF))
RNG_KEY = (0, 7)  # the reference's jax.random.PRNGKey(7)
EXT_KERNELS = ("filter_score_planes", "normalize_combine_packed", "prev_delta_apply")
KEYED_TARGETS = {
    "tie_plane": (RT, "tie_plane", None),
    "tie_split": (RT, "tie_split", None),
    "scan_select_keyed": (RT, "scan_select_assume", lambda a: len(a) > 12 and a[12] is not None),
}
PACKED_TARGETS = {"normalize_combine_packed": (RT, "normalize_combine", None)}


def check_extender_kernels(dev) -> dict:
    """K33 on the keys (0, 0), (0, 7) and (2³² − 1, 2³² − 1): the split of 512
    keys, a (512, 8192) noised plane and 512 step rows, bit for bit against
    the plain version (ops/prng.py) on the same CUDA tensors, and the plain
    version against jax.random's words for PRNGKey(7) (literals); K17's
    keyed mode under the step keys of PRNGKey(7) (its draws made in the
    kernel; the chosen rows held against K33's step rows) on all-tie rows,
    an all −inf row, a feasible and an infeasible nominated row and a tie
    at the last node, and ``k17_split_cases`` keyed (equal draws across
    slices); K2's packed mode at C = 512 and C = 1 over N = 8192."""
    import torch

    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import tie_noise as KT
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine, normalize_combine_plain
    from kubernetes_tpu_torch.ops import prng

    gen = torch.Generator().manual_seed(SEED + 33)
    err = {"tie_noise": 0.0, "scan_select_keyed": 0.0, "normalize_combine_packed": 0.0}
    # the plain version against the literal jax.random words
    words = (prng.uniform((0, 7), (8,)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    if words.tolist() != list(JAX_UNIFORM_KEY7):
        fail(f"prng.uniform(PRNGKey(7), (8,)): {words.tolist()} != jax.random's")
    if [tuple(r) for r in prng.split((0, 7), 3).tolist()] != list(JAX_SPLIT_KEY7):
        fail("prng.split(PRNGKey(7), 3) differs from jax.random's")
    row7 = KT.tie_row(KT.key_rows((0, 7), dev), 0, 8)
    torch.cuda.synchronize()
    if (row7.cpu().view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist() != \
            list(JAX_UNIFORM_KEY7):
        fail("tie_row (K33) under PRNGKey(7) differs from jax.random's words")
    b, n = 512, 8192
    full = 7
    for key in TIE_KEYS:
        keys = KT.tie_split(key, b, dev)
        want = KT.tie_split_plain(key, b, device=dev)
        torch.cuda.synchronize()
        err["tie_noise"] = max(err["tie_noise"], require_equal(
            f"tie_split {key}", [("keys", keys, want)]))
        bits = torch.where(torch.rand((b, n), generator=gen) < 0.8, full, 3).to(torch.int32)
        total = torch.where(bits == full, torch.randint(0, 700, (b, n), generator=gen).float(),
                            float("-inf"))
        bits, total = bits.to(dev), total.to(dev)
        got = KT.tie_plane(key, bits, full, total.clone())
        plain = KT.tie_plane_plain(key, bits, full, total.clone())
        torch.cuda.synchronize()
        err["tie_noise"] = max(err["tie_noise"], require_equal(
            f"tie_plane {key}", [("total", got, plain)]))
        # the float32 add rounds to the total's ulp, so a draw just below
        # 0.5 may land on total + 0.5 exactly, never beyond
        noise = got - total
        on = bits == full
        if bool(((noise[on] < 0) | (noise[on] > 0.5)).any()) or \
                bool(torch.isfinite(got[~on]).any()):
            fail(f"tie_plane {key}: noise outside [0, 0.5] or written off the mask")
        for k in (0, 1, b // 2, b - 1):
            r_k = KT.tie_row(keys, k, n)
            r_p = KT.tie_row_plain(keys, k, n)
            torch.cuda.synchronize()
            err["tie_noise"] = max(err["tie_noise"], require_equal(
                f"tie_row {key} step {k}", [("row", r_k, r_p)]))
    # K17 keyed
    r = 8
    valid = torch.ones(b, dtype=torch.bool, device=dev)
    request = torch.randint(0, 3000, (b, r), generator=gen, dtype=torch.int32).to(dev)
    pod_nz = torch.randint(0, 3000, (b, 2), generator=gen, dtype=torch.int32).to(dev)
    keys = KT.tie_split((0, 7), b, dev)
    fullk = (1 << 16) - 1
    kinds = ("all ties", "ties with holes", "all -inf", "nominated feasible",
             "nominated infeasible", "tie at the last node")
    for k, kind in enumerate(kinds):
        bits = torch.where(torch.rand(n, generator=gen) < 0.7, fullk, fullk & ~4).to(torch.int32)
        total = torch.full((n,), 250.0)
        nom = -1
        if kind == "all ties":
            bits[:] = fullk
        elif kind == "all -inf":
            bits[:] = 0
        elif kind == "nominated feasible":
            bits[4000], nom = fullk, 4000
        elif kind == "nominated infeasible":
            bits[77], nom = 0, 77
        elif kind == "tie at the last node":
            total = torch.randint(0, 100, (n,), generator=gen).float()
            bits[n - 1], total[n - 1] = fullk, 999.0
            bits[5], total[5] = fullk, 999.0
        total = torch.where(bits == fullk, total, float("-inf"))
        bits, total = bits[None].to(dev), total[None].to(dev)
        noise = KT.tie_row(keys, k, n)  # the step's draws, as K17 makes them
        nominated = torch.full((b,), -1, dtype=torch.int32, device=dev)
        nominated[k] = nom
        outs_k = [torch.randint(0, 4000, (n, r), generator=gen, dtype=torch.int32).to(dev),
                  torch.randint(0, 4000, (n, 2), generator=gen, dtype=torch.int32).to(dev),
                  torch.full((b,), -7, dtype=torch.int32, device=dev),
                  torch.full((b,), -7, dtype=torch.int32, device=dev)]
        outs_p = [t.clone() for t in outs_k]
        args = (bits, fullk, total, k, nominated, valid, request, pod_nz)
        KS.scan_select_assume(*args, *outs_k, keys, k)
        KS.scan_select_assume_plain(*args, *outs_p, keys, k)
        torch.cuda.synchronize()
        err["scan_select_keyed"] = max(err["scan_select_keyed"], require_equal(
            f"scan_select_assume keyed ({kind})",
            [(f, a, c) for f, a, c in zip(("requested", "non_zero", "node_row",
                                           "feasible_count"), outs_k, outs_p)]))
        row = int(outs_k[2][k])
        if kind == "all -inf" and row != -1:
            fail("scan_select_assume keyed: placed a pod on an infeasible row")
        if kind == "nominated feasible" and row != 4000:
            fail("scan_select_assume keyed: the feasible nominated row was not taken")
        if kind == "tie at the last node" and row not in (5, n - 1):
            fail(f"scan_select_assume keyed: {row} is not one of the tied maxima")
        if kind == "all ties":
            want = int(torch.argmax(noise))
            if row != want:
                fail(f"scan_select_assume keyed: all ties went to {row}, not {want}")
        if kind == "tie at the last node":
            want = (5, n - 1)[int(noise[n - 1] > noise[5])]
            if row != want:
                fail(f"scan_select_assume keyed: the tie at the last node went to {row}, "
                     f"not {want}")
    err["scan_select_keyed"] = max(err["scan_select_keyed"],
                                   k17_split_cases(dev, gen, keyed=True))
    # K2 packed at C = 512 and C = 1
    fw, (_fs_plan, comb_plan) = framework_plans()
    fullf = (1 << len(fw.filter_names)) - 1
    for c in (512, 1):
        bits = torch.where(torch.rand((c, n), generator=gen) < 0.6, fullf,
                           fullf & ~(1 << 3)).to(torch.int32).to(dev)
        raw = (torch.rand((5, c, n), generator=gen) * 100).floor().to(dev)
        got = normalize_combine(bits, fullf, raw, comb_plan, packed=True)
        want, _feas = normalize_combine_plain(bits, fullf, raw, comb_plan)
        torch.cuda.synchronize()
        err["normalize_combine_packed"] = max(err["normalize_combine_packed"], require_equal(
            f"normalize_combine packed C={c}", [("packed", got, want)]))
        if not torch.equal(torch.isinf(got), bits != fullf):
            fail(f"normalize_combine packed C={c}: -inf not exactly off the mask")
    log("extender / tie-noise kernels vs plain: all equal (K33 on 3 keys, K17 keyed on "
        f"{len(kinds)} rows, K2 packed at C = 512 and 1); the plain version equals "
        "jax.random's PRNGKey(7) words")
    return err


def extender_score_fn(pod_dict, names):
    """The chip run's extender: rejects every node whose index is 3 mod 7,
    scores (index · 37) mod 11 (non-uniform, so the merge decides ties)."""
    idx = {n: int(n.rsplit("-", 1)[1]) for n in names}
    return ([n for n in names if idx[n] % 7 != 3],
            {n: (idx[n] * 37) % 11 for n in names})


def start_extender_server():
    """extender_score_fn behind a TPUScoreExtenderServer in a spawn
    subprocess → (url, stop)."""
    import multiprocessing as mp
    from functools import partial

    from kubernetes_tpu_torch.extender import run_subprocess_score_server

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=partial(run_subprocess_score_server, extender_score_fn),
                       args=(child,), daemon=True)
    proc.start()
    if not parent.poll(60):
        proc.terminate()
        fail("the extender subprocess did not start")
    port = parent.recv()

    def stop():
        proc.terminate()
        proc.join(timeout=5)

    return f"http://127.0.0.1:{port}", stop


def extender_run(dev_name: str, url: str, n_nodes: int, n_pre: int, n_pods: int,
                 n_spread: int, async_: bool) -> dict:
    """``n_nodes`` zoned nodes, ``n_pre`` pre-bound pod_default pods, then
    ``n_pods`` pod_default pods and ``n_spread`` DoNotSchedule spread pods
    (one coupled component: a batch of them needs a round each) through
    TorchScheduler(batch_size=512, extenders=[one HTTPExtender]), synchronous
    or with the async walk (pipelined); the launch counts zeroed just before
    and read just after.  Checks: every pod bound, only on a node the
    extender approves, no node past capacity, the spread held."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.extender import ExtenderConfig, HTTPExtender
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_pod

    what = f"extender path {n_nodes} nodes ({'async' if async_ else 'sync'}, {dev_name})"
    fresh_heap()
    store = ObjectStore()
    for i in range(n_nodes):
        store.create("Node", zoned_node(i))
    for i in range(n_pre):
        store.create("Pod", make_pod().name(f"pre-{i:06d}").uid(f"pre-{i:06d}")
                     .namespace("default").req({"cpu": "100m", "memory": "500Mi"})
                     .node(f"node-{i % n_nodes:06d}").obj())
    ext = HTTPExtender(ExtenderConfig(url_prefix=url, filter_verb="filter",
                                      prioritize_verb="prioritize", weight=1,
                                      node_cache_capable=True))
    sched = TorchScheduler(store, batch_size=512, device=dev_name, pipeline=async_,
                           async_extenders=async_, extenders=[ext])
    sched.presize(n_nodes, n_pre + n_pods + n_spread)
    for i in range(n_pods):
        store.create("Pod", default_pod(i, "ext"))
    for i in range(n_spread):
        store.create("Pod", spread_pod(i, "extspread", ts0=1e7))
    pw0 = dict(sched.phase_wall)
    if dev_name == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    stats = sched.run_until_idle()
    if dev_name == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    pods = check_bound_and_fit(what, store)
    measured = [p for p in pods if p.metadata.name.startswith("ext")]
    if stats.scheduled != n_pods + n_spread or len(measured) != n_pods + n_spread:
        fail(f"{what}: scheduled {stats.scheduled} of {n_pods + n_spread}")
    bad = [p.metadata.name for p in measured if int(p.spec.node_name[5:]) % 7 == 3]
    if bad:
        fail(f"{what}: {len(bad)} pods on nodes the extender rejects, e.g. {bad[:3]}")
    zc = zone_counts(pods, "extspread-")
    if n_spread and max(zc) - min(zc) > 5:
        fail(f"{what}: zone skew {zc} exceeds maxSkew 5")
    att = np.asarray(sched.attempt_seconds[-(n_pods + n_spread):])
    phase = {k: sched.phase_wall[k] - pw0[k] for k in pw0}
    rec = {"nodes": n_nodes, "pre_bound": n_pre, "pods": n_pods, "spread_pods": n_spread,
           "batch_size": 512, "async": async_, "wall_s": wall,
           "pods_per_s": (n_pods + n_spread) / wall, "cycles": sched.cycles,
           "rounds": sched.rounds_total,
           "rounds_per_batch": sched.rounds_total / max(sched.cycles, 1),
           "extender_wait_s": phase["extender_wait"], "phase_wall_s": phase,
           "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
           "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
           "callouts": dict(ext.callouts), "zone_counts": zc, "launches": launches}
    bindings = {p.metadata.name: p.spec.node_name for p in measured}
    sched.close()
    ext.close()
    return {"record": rec, "bindings": bindings}


def extender_path(url: str, async_: bool) -> dict:
    """The extender path at full width: 5000 zoned nodes, 2000 pre-bound
    pods, 4096 pod_default pods and 32 spread pods (k_cap 500)."""
    out = extender_run("cuda", url, 5000, 2000, 4096, 32, async_)
    rec = out["record"]
    for k in EXT_KERNELS:
        if rec["launches"][k] <= 0:
            fail(f"extender path ({'async' if async_ else 'sync'}): kernel {k} never launched")
    if rec["launches"]["tie_noise"]:
        fail("extender path: K33 launched without a key")
    log(f"extender path 5000 nodes ({'async' if async_ else 'sync'}): {rec['pods'] + 32} pods "
        f"in {rec['wall_s']:.2f} s = {rec['pods_per_s']:.1f} pods/s, "
        f"{rec['rounds_per_batch']:.2f} rounds/batch ({rec['rounds']} rounds, "
        f"{rec['cycles']} batches), extender_wait {rec['extender_wait_s']:.3f} s, attempt "
        f"p50 {rec['attempt_p50_ms']:.1f} / p99 {rec['attempt_p99_ms']:.1f} ms; callouts "
        f"{rec['callouts']}; zones {rec['zone_counts']}; launches K1 "
        f"{rec['launches']['filter_score_planes']}, K2 packed "
        f"{rec['launches']['normalize_combine_packed']}, K13 "
        f"{rec['launches']['prev_delta_apply']}; phase wall (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["phase_wall_s"].items()))
    return out


def extender_harness() -> dict:
    """SchedulingExtender/500Nodes through ``perf.harness.run_workload`` (its
    subprocess extender, B = 384): every measured pod bound, no kernel
    built in the window."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.perf.harness import run_workload
    from kubernetes_tpu_torch.perf.workloads import build_workload

    w = build_workload("SchedulingExtender", "500Nodes")
    seen = {}

    def inspect(store, sched, _ctrl):
        seen["pods"] = {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}
        seen["rounds"], seen["cycles"] = sched.rounds_total, sched.cycles

    kernels.reset_launches()
    items = run_workload(w, device="cuda", inspect=inspect)
    launches = dict(kernels.LAUNCHES)
    by = {it.labels["Metric"]: it.data for it in items}
    first = sum(op.count for op in w.ops[:-1] if op.opcode == "createPods")
    measured = [w.ops[-1].pod_template(i).metadata.name
                for i in range(first, first + w.ops[-1].count)]
    unbound = [n for n in measured if not seen["pods"].get(n)]
    if unbound:
        fail(f"SchedulingExtender/500Nodes: {len(unbound)} measured pods unbound")
    if by["KernelBuildsInWindow"]["Count"]:
        fail("SchedulingExtender/500Nodes: a kernel was built in the measured window")
    if by["KernelLaunchesInWindow"]["normalize_combine_packed"] <= 0:
        fail("SchedulingExtender/500Nodes: K2's packed mode not launched in the window")
    rec = {**harness_summary(items), "extender_wait_s": by["PhaseWallBreakdown"]["extender_wait"],
           "window_launches": by["KernelLaunchesInWindow"], "launches": launches,
           "rounds": seen["rounds"], "cycles": seen["cycles"]}
    log(f"SchedulingExtender/500Nodes through run_workload: {rec['pods_per_s']} pods/s, "
        f"attempt p50 {rec['attempt_p50_ms']:.1f} / p99 {rec['attempt_p99_ms']:.1f} ms, "
        f"extender_wait {rec['extender_wait_s']:.3f} s, every measured pod bound, no "
        f"kernel built in the window")
    return rec


def dedup_reasons(sched) -> list:
    """Record the dedup gate's fallback reason of every batch dispatch."""
    reasons = []
    orig = sched._dedup_classes

    def gate(*a, **kw):
        out = orig(*a, **kw)
        reasons.append(out[2])
        return out

    sched._dedup_classes = gate
    return reasons


def keyed_run(dev_name: str, kind: str, key, mode: str = "auto", n_nodes: int = 5000,
              n_pre: int = 2000, n_pods: int = 4096) -> dict:
    """A keyed (or keyless) run, the launch counts zeroed just before and read
    just after → record and bindings.  "northstar": node_default nodes,
    ``n_pre`` pre-bound pods, ``n_pods`` pod_default pods; "spread":
    TopologySpreading's cluster (``n_pre`` pod_default pods scheduled
    first), then ``n_pods`` DoNotSchedule spread pods."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.scheduler import TorchScheduler
    from kubernetes_tpu_torch.sim.store import ObjectStore
    from kubernetes_tpu_torch.testutil import make_node, make_pod

    tag = "keyed" if key is not None else "keyless"
    what = f"{kind} {n_nodes} nodes, {tag}, {mode} ({dev_name})"
    fresh_heap()
    kw = {} if key is None else {"rng_key": key}
    if kind == "northstar":
        store = ObjectStore()
        for i in range(n_nodes):
            store.create("Node", make_node().name(f"node-{i:06d}")
                         .capacity({"cpu": "4", "memory": "32Gi", "pods": "110"}).obj())
        for i in range(n_pre):
            store.create("Pod", make_pod().name(f"pre-{i:06d}").uid(f"pre-{i:06d}")
                         .namespace("default").req({"cpu": "100m", "memory": "500Mi"})
                         .node(f"node-{i % n_nodes:06d}").obj())
        sched = TorchScheduler(store, batch_size=512, device=dev_name, assign_mode=mode, **kw)
        sched.presize(n_nodes, n_pre + n_pods)
        make = lambda i: default_pod(i, "kp")  # noqa: E731
    else:
        sched = spread_cluster(dev_name, n_nodes, n_pre, assign_mode=mode, **kw)
        store = sched.store
        make = lambda i: spread_pod(i, "ks", ts0=2e7)  # noqa: E731
    routes = route_counter(sched)
    reasons = dedup_reasons(sched)
    for i in range(n_pods):
        store.create("Pod", make(i))
    if dev_name == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    stats = sched.run_until_idle()
    if dev_name == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    pods = check_bound_and_fit(what, store)
    if stats.scheduled != n_pods:
        fail(f"{what}: scheduled {stats.scheduled} of {n_pods}")
    zc = zone_counts(pods, "ks-") if kind == "spread" else None
    if zc is not None and max(zc) - min(zc) > 5:
        fail(f"{what}: zone skew {zc} exceeds maxSkew 5")
    att = np.asarray(sched.attempt_seconds[-n_pods:])
    rec = {"nodes": n_nodes, "first_pods": n_pre, "pods": n_pods, "mode": mode, "key": key,
           "wall_s": wall, "pods_per_s": n_pods / wall, "routes": sorted(set(routes)),
           "dispatches": {r_: routes.count(r_) for r_ in sorted(set(routes))},
           "dedup_fallbacks": sorted({r for r in reasons if r}),
           "attempt_p50_ms": float(np.percentile(att, 50) * 1e3),
           "attempt_p99_ms": float(np.percentile(att, 99) * 1e3),
           "nodes_used": len({p.spec.node_name for p in pods
                              if p.metadata.name.startswith(("kp", "ks"))}),
           "zone_counts": zc, "launches": launches}
    bindings = {p.metadata.name: p.spec.node_name for p in pods}
    sched.close()
    return {"record": rec, "bindings": bindings}


KEYED_RUNS = (
    # (label, kind, mode, pods, engine the batches must take)
    ("NorthStar keyed", "northstar", "auto", 4096, "full"),
    ("NorthStar keyed scan", "northstar", "scan", 512, "scan"),
    ("TopologySpreading keyed", "spread", "auto", 1024, "scan"),
    ("TopologySpreading keyed, full auction", "spread", "batch", 256, "full"),
)


def keyed_paths() -> dict:
    """NorthStar's 5000 nodes with 4096 pods and TopologySpreading/5000Nodes
    (1024 spread pods; 256 more under assign_mode="batch") with
    rng_key=(0, 7): the full auction (the dedup gate falls back under
    "rng_key"), the scan (assign_mode="scan"; the router scans the coupled
    spread batches), every pod bound, the spread held, K33 launched, K17 in
    its keyed mode where the scan runs; each beside the same cell without a
    key."""
    out = {}
    for label, kind, mode, n_pods, engine in KEYED_RUNS:
        n_pre = 2000 if kind == "northstar" else 5000
        keyed = keyed_run("cuda", kind, RNG_KEY, mode, n_pre=n_pre, n_pods=n_pods)["record"]
        plain = keyed_run("cuda", kind, None, mode, n_pre=n_pre, n_pods=n_pods)["record"]
        if keyed["routes"] != [engine]:
            fail(f"{label}: the batches took {keyed['routes']}, not {engine}")
        if engine == "full" and keyed["dedup_fallbacks"] != ["rng_key"]:
            fail(f"{label}: dedup fallbacks {keyed['dedup_fallbacks']}, not rng_key")
        need = ("tie_noise",) + (("scan_select_keyed",) if engine == "scan" else
                                 ("topk_rows", "auction_resolve_commit"))
        for k in need:
            if keyed["launches"][k] <= 0:
                fail(f"{label}: kernel {k} never launched")
        if plain["launches"]["tie_noise"] or plain["launches"]["scan_select_keyed"]:
            fail(f"{label} without a key: a keyed kernel launched")
        ln = keyed["launches"]
        if ln["tie_noise"] != ln["tie_split"] + ln["tie_plane"] + ln["tie_row"]:
            fail(f"{label}: K33's count {ln['tie_noise']} is not its entries' sum")
        if engine == "scan" and (ln["tie_row"] or ln["tie_plane"]
                                 or ln["tie_split"] != keyed["dispatches"]["scan"]):
            fail(f"{label}: the keyed scan launched tie_row {ln['tie_row']} and tie_plane "
                 f"{ln['tie_plane']} times and tie_split {ln['tie_split']} times in "
                 f"{keyed['dispatches']['scan']} batches (0, 0 and once a batch expected)")
        out[label] = {"keyed": keyed, "keyless": plain}
        log(f"{label}, 5000 nodes / {n_pods} pods: {keyed['pods_per_s']:.1f} pods/s keyed "
            f"({keyed['routes']}, fallbacks {keyed['dedup_fallbacks']}) vs "
            f"{plain['pods_per_s']:.1f} without a key ({plain['routes']}); attempt p99 "
            f"{keyed['attempt_p99_ms']:.1f} vs {plain['attempt_p99_ms']:.1f} ms; nodes used "
            f"{keyed['nodes_used']} vs {plain['nodes_used']}; zones {keyed['zone_counts']}; "
            f"launches K33 {ln['tie_noise']} (split {ln['tie_split']}, plane "
            f"{ln['tie_plane']}, row {ln['tie_row']}), K17 keyed "
            f"{ln['scan_select_keyed']}")
    return out


def extender_cuda_vs_cpu(url: str) -> dict:
    """cuda == cpu at 1000 nodes: the extender path (200 pre-bound, 512 pods
    and 16 spread pods) synchronous and async, and the keyed auction and
    keyed scan (512 pods)."""
    out = {}
    for async_ in (False, True):
        t = time.perf_counter()
        g = extender_run("cuda", url, 1000, 200, 512, 16, async_)
        c = extender_run("cpu", url, 1000, 200, 512, 16, async_)
        if g["bindings"] != c["bindings"]:
            diff = [k for k in g["bindings"] if g["bindings"][k] != c["bindings"].get(k)]
            fail(f"extender path 1000 nodes ({'async' if async_ else 'sync'}): cuda and cpu "
                 f"bindings differ for {len(diff)} pods, e.g. {diff[:3]}")
        if g["record"]["rounds"] != c["record"]["rounds"]:
            fail("extender path 1000 nodes: cuda and cpu rounds differ")
        label = f"extender {'async' if async_ else 'sync'}"
        out[label] = {"pods": len(g["bindings"]), "rounds": g["record"]["rounds"],
                      "s": time.perf_counter() - t}
        log(f"{label}, 1000 nodes: cuda == cpu bindings ({len(g['bindings'])} pods, "
            f"{g['record']['rounds']} rounds) in {out[label]['s']:.1f} s")
    for label, kind, mode in (("keyed auction", "northstar", "auto"),
                              ("keyed scan", "northstar", "scan")):
        t = time.perf_counter()
        g = keyed_run("cuda", kind, RNG_KEY, mode, n_nodes=1000, n_pre=200, n_pods=512)
        c = keyed_run("cpu", kind, RNG_KEY, mode, n_nodes=1000, n_pre=200, n_pods=512)
        if g["bindings"] != c["bindings"]:
            diff = [k for k in g["bindings"] if g["bindings"][k] != c["bindings"].get(k)]
            fail(f"{label}, 1000 nodes: cuda and cpu bindings differ for {len(diff)} pods, "
                 f"e.g. {diff[:3]}")
        if g["record"]["launches"]["tie_noise"] <= 0:
            fail(f"{label}, 1000 nodes: K33 never launched")
        out[label] = {"pods": 512, "routes": g["record"]["routes"],
                      "s": time.perf_counter() - t}
        log(f"{label}, 1000 nodes: cuda == cpu bindings (512 pods, routes "
            f"{g['record']['routes']}) in {out[label]['s']:.1f} s")
    return out


def time_extender_kernels(keyed_calls: dict, packed_calls: dict, err: dict,
                          launches: dict) -> list:
    """K33 (the noise plane, the step keys and — off the scan since K17
    draws inside — select_host's step row at the scan's N), K17's keyed
    mode and K2's packed mode on the arguments of their latest call on the
    keyed paths and the extender path, timed as in 6 and held once more
    against their plain versions; the bounds from those inputs.
    ``launches``: each row's launches on the path whose call it times
    ("plane": the last keyed full auction's ``tie_plane``, "scan": the last
    keyed scan's counts, "packed": the extender path)."""
    import torch

    from kubernetes_tpu_torch.kernels import scan as KS
    from kubernetes_tpu_torch.kernels import tie_noise as KT
    from kubernetes_tpu_torch.kernels.normalize import normalize_combine, normalize_combine_plain

    rows_out = []

    def last(calls, key):
        got = calls.get(key)
        if got is None:
            fail(f"kernel timing: no recorded call of {key}")
        return got

    def row(name, err_key, src, replaces, symbol, fn, plain_fn, n_bytes, n_ops, shape,
            n_launch, library=None):
        least, bound_by = bound_ms(n_bytes, n_ops)
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": n_launch, "max_abs_err": err[err_key],
            "ms": device_ms(fn, symbol), "ms_source": MS_SOURCE[0], "call_ms": time_ms(fn),
            "plain_ms": time_ms(plain_fn, reps=5, warmup=1), "bound_ms": least,
            "bound_by": bound_by, "library_ms": library, "bytes": n_bytes, "ops": n_ops,
            "shape": shape})

    tf_ops = KW.THREEFRY_OPS
    (key, bits, full, total), _kw = last(keyed_calls, "tie_plane")
    base = total.clone()
    got = KT.tie_plane(key, bits, full, base.clone())
    want = KT.tie_plane_plain(key, bits, full, base.clone())
    err["tie_noise"] = max(err["tie_noise"], require_equal(
        "tie_plane (path shapes)", [("total", got, want)]))
    c, n = bits.shape
    masked = int((bits == full).sum())
    work = base.clone()
    row("tie_noise (plane)", "tie_noise", K33_SOURCE, K33_REPLACES, "tie_plane_kernel",
        lambda a=(key, bits, full, work): KT.tie_plane(*a),
        lambda a=(key, bits, full, base): KT.tie_plane_plain(*a[:3], a[3].clone()),
        nbytes(bits) + 8 * masked, c * n + masked * (tf_ops + 2),
        {"C": c, "N": n, "masked": masked}, launches["plane"])
    (key, b, dev), _kw = last(keyed_calls, "tie_split")
    row("tie_noise (step keys)", "tie_noise", K33_SOURCE,
        "kubernetes_tpu/framework/runtime.py:397", "tie_split_kernel",
        lambda: KT.tie_split(key, b, dev), lambda: KT.tie_split_plain(key, b, device=dev),
        8 * b, b * tf_ops, {"B": b}, launches["scan"]["tie_split"])
    # the step row is no longer drawn on the scan (K17 draws inside): timed
    # as select_host's draw at the scan's N, its launches the scan's (0)
    args, _kw = last(keyed_calls, "scan_select_keyed")
    n_row = args[0].shape[-1]
    krow = KT.key_rows(key, dev)
    got, want = KT.tie_row(krow, 0, n_row), KT.tie_row_plain(krow, 0, n_row)
    err["tie_noise"] = max(err["tie_noise"], require_equal(
        "tie_row (select_host's draw)", [("row", got, want)]))
    row("tie_noise (step row)", "tie_noise", K33_SOURCE,
        "kubernetes_tpu/framework/runtime.py:307", "tie_row_kernel",
        lambda: KT.tie_row(krow, 0, n_row), lambda: KT.tie_row_plain(krow, 0, n_row),
        8 + 4 * n_row, n_row * tf_ops, {"N": n_row, "key": "select_host's"},
        launches["scan"]["tie_row"])
    (sbits, sfull, stotal, i, nominated, valid, request, pod_nz, requested, node_nz,
     node_row, feas, keys, k) = args
    outs_k = [t.clone() for t in (requested, node_nz, node_row, feas)]
    outs_p = [t.clone() for t in outs_k]
    KS.scan_select_assume(sbits, sfull, stotal, i, nominated, valid, request, pod_nz,
                          *outs_k, keys, k)
    KS.scan_select_assume_plain(sbits, sfull, stotal, i, nominated, valid, request, pod_nz,
                                *outs_p, keys, k)
    err["scan_select_keyed"] = max(err["scan_select_keyed"], require_equal(
        "scan_select_assume keyed (path shapes)",
        [(f, a, c_) for f, a, c_ in zip("rnsf", outs_k, outs_p)]))
    n_s = sbits.shape[-1]
    r_dims = request.shape[1]
    work = [t.clone() for t in (requested, node_nz, node_row, feas)]
    k17 = (lambda: KS.scan_select_assume(sbits, sfull, stotal, i, nominated, valid, request,
                                         pod_nz, *work, keys, k))
    row("scan_select_assume (keyed)", "scan_select_keyed", K17_SOURCE, K17_KEYED_REPLACES,
        "scan_select_kernel", k17,
        lambda: KS.scan_select_assume_plain(sbits, sfull, stotal, i, nominated, valid,
                                            request, pod_nz,
                                            *[t.clone() for t in work], keys, k),
        *KW.k17_work(sbits, sfull, stotal, i, nominated, valid, request, keys),
        {"N": n_s, "R": r_dims, "step": k}, launches["scan"]["scan_select_keyed"])
    rows_out[-1]["host_us"] = host_issue_us(k17)
    log(f"  scan_select_assume (keyed): the host issues a call in "
        f"{rows_out[-1]['host_us']:.2f} us (1000 queued calls)")
    one_device_activity("scan_select_assume (keyed)", k17, "scan_select_kernel",
                        "scan_select_keyed")
    (pbits, pfull, praw, plan), kw = last(packed_calls, "normalize_combine_packed")
    if not kw.get("packed"):
        fail("kernel timing: the extender path's latest K2 call was not the packed mode")
    got = normalize_combine(pbits, pfull, praw, plan, packed=True)
    want, _f = normalize_combine_plain(pbits, pfull, praw, plan)
    err["normalize_combine_packed"] = max(err["normalize_combine_packed"], require_equal(
        "normalize_combine packed (path shapes)", [("packed", got, want)]))
    cc, nn = pbits.shape
    n_planes = praw.shape[0]
    # as K2's other rows: the raw planes read only on feasible nodes
    n_feas = int((pbits == pfull).sum())
    row("normalize_combine (packed)", "normalize_combine_packed", K2_SOURCE,
        K2_PACKED_REPLACES, "normalize_combine_kernel",
        lambda: normalize_combine(pbits, pfull, praw, plan, packed=True),
        lambda: normalize_combine_plain(pbits, pfull, praw, plan),
        nbytes(pbits) + 4 * n_planes * n_feas + 4 * cc * nn, n_feas * n_planes * 4,
        {"C": cc, "N": nn, "planes": n_planes, "feasible": n_feas}, launches["packed"])
    ROUND_CALLS["normalize_combine (packed)"] = (
        lambda: normalize_combine(pbits, pfull, praw, plan, packed=True),
        "normalize_combine_kernel", {})
    for rr in rows_out:
        log(f"  {rr['name']}: {rr['ms']:.5f} ms device ({rr['call_ms']:.4f} ms a call), "
            f"bound {rr['bound_ms']:.7f} ms ({rr['bound_by']}), plain {rr['plain_ms']:.4f} ms; "
            f"{rr['shape']}; launches {rr['launches']}")
    return rows_out


def main() -> None:
    here = Path(__file__).resolve().parent
    if not (here / "kubernetes_tpu_torch" / "csrc").is_dir():
        fail("kubernetes_tpu_torch/ is not beside chip_smoke.py: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(here))
    os.chdir(here)
    t_start = time.perf_counter()
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
    log(f"built {len(build.SOURCES)} kernel sources for sm_90a in {record['build_s']:.1f} s")
    for name in build.SOURCES:
        for line in build.PTXAS_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t = time.perf_counter()
    err = check_kernels(dev)
    err.update(check_spread_kernels(dev))
    err.update(check_ipa_kernels(dev))
    err.update(check_pipeline_kernels(dev))
    scan_err, reuse_err = check_scan_kernels(dev)
    err.update(scan_err)
    err.update(check_gang_kernels(dev))
    err.update(check_dra_kernels(dev))
    err.update(check_preempt_kernels(dev))
    err.update(check_fork_kernels(dev))
    err.update(check_profile_kernels(dev))
    err.update(check_extender_kernels(dev))
    record["kernel_check_s"] = time.perf_counter() - t
    out_dir = here / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    kargs = KernelArgs(PIPELINE_TARGETS, key=pipeline_key).install()
    t = time.perf_counter()
    ns = northstar("cuda")
    record["northstar"] = ns["record"]
    record["northstar"]["phase_s"] = time.perf_counter() - t

    # the pipelined main path: NorthStar through the perf harness
    t = time.perf_counter()
    nsh = northstar_harness(kargs, out_dir)
    record["northstar_harness"] = nsh["record"]
    record["northstar_harness"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["overlap_sync_compare"] = overlap_sync_compare(nsh["sched"].overlap_sync)
    record["overlap_sync_compare"]["phase_s"] = time.perf_counter() - t
    path_calls = {k: v for k, v in kargs.last.items()
                  if k[0] in ("prev_delta_apply", "scatter_rows")}

    t = time.perf_counter()
    topo = topology_spreading("cuda")
    record["topology_spreading"] = topo["record"]
    record["topology_spreading"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["preferred_spreading"] = preferred_spreading("cuda")
    record["preferred_spreading"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    topo_pipe = topology_spreading("cuda", pipeline=True)
    record["topology_spreading_pipelined"] = topo_pipe["record"]
    record["topology_spreading_pipelined"]["phase_s"] = time.perf_counter() - t
    path_calls[("spread_chain_prev", 0)] = kargs.last[("spread_chain_prev", 0)]

    affinity = {}
    for suite in AFFINITY_SUITES:
        t = time.perf_counter()
        affinity[suite] = affinity_suite("cuda", suite)
        record[suite] = affinity[suite]["record"]
        record[suite]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pref_pipe = affinity_suite("cuda", "SchedulingPreferredPodAffinity", pipeline=True)
    record["SchedulingPreferredPodAffinity_pipelined"] = pref_pipe["record"]
    record["SchedulingPreferredPodAffinity_pipelined"]["phase_s"] = time.perf_counter() - t
    path_calls[("ipa_chain_prev", 0)] = kargs.last[("ipa_chain_prev", 0)]
    # each pipelined run beside the synchronous run of its suite, this call
    record["pipelined_vs_sync"] = {
        name: {mode: {k: r_.get(k) for k in ("pods_per_s", "attempt_p50_ms",
                                             "attempt_p99_ms", "phase_wall_s",
                                             "window_phase_wall_s", "rounds_per_cycle",
                                             "carried_pods")}
               for mode, r_ in (("sync", sync_rec), ("pipelined", pipe_rec))}
        for name, sync_rec, pipe_rec in (
            ("NorthStar", ns["record"], nsh["record"]),
            ("TopologySpreading", topo["record"], topo_pipe["record"]),
            ("SchedulingPreferredPodAffinity",
             affinity["SchedulingPreferredPodAffinity"]["record"], pref_pipe["record"]))}
    # the full auction and the exact scan at full width: each synchronous
    # run keeps its kernels' latest arguments for the timing phase
    engine_runs, recorders = {}, {}
    for what, pipeline in ENGINE_RUNS:
        t = time.perf_counter()
        recorder = None
        if not pipeline:
            recorder = scan_recorder() if ENGINE_PATHS[what][5] == "scan" else full_recorder()
            recorders[what] = recorder
        key = what + (" (pipelined)" if pipeline else "")
        engine_runs[key] = engine_path("cuda", what, out_dir, pipeline=pipeline,
                                       recorder=recorder)["record"]
        engine_runs[key]["phase_s"] = time.perf_counter() - t
    record["engine_paths"] = engine_runs

    # gang scheduling: GangBasic/5000Nodes synchronous (its K20–K23 calls
    # kept for the timing phase) and through the perf harness
    gang_args = KernelArgs(GANG_TARGETS, key=gang_key)
    t = time.perf_counter()
    gang = gang_basic_sync(gang_args, out_dir)
    record["gang_basic"] = gang["record"]
    record["gang_basic"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["gang_basic_harness"] = gang_basic_harness()
    record["gang_basic_harness"]["phase_s"] = time.perf_counter() - t

    # device claims: DeviceClaimGang/5000Nodes synchronous (its K24–K26
    # calls kept for the timing phase) and through the perf harness
    dra_args = KernelArgs(DRA_TARGETS)
    t = time.perf_counter()
    claim = claim_gang_sync(dra_args, out_dir)
    record["device_claim_gang"] = claim["record"]
    record["device_claim_gang"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["device_claim_gang_harness"] = claim_gang_harness()
    record["device_claim_gang_harness"]["phase_s"] = time.perf_counter() - t

    # preemption: PreemptionBasic/5000Nodes synchronous (its K27 / K28
    # calls kept for the timing phase) and through the perf harness
    preempt_args = KernelArgs(PREEMPT_TARGETS)
    t = time.perf_counter()
    preempt = preemption_basic_sync(preempt_args, out_dir)
    record["preemption_basic"] = preempt["record"]
    record["preemption_basic"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["preemption_basic_harness"] = preemption_basic_harness()
    record["preemption_basic_harness"]["phase_s"] = time.perf_counter() - t

    # counterfactuals: Defrag and AutoscaleGang at 5000Nodes through the perf
    # harness (K30 / K31's latest calls kept for the timing phase)
    with KernelArgs(FORK_TARGETS, key=fork_key) as defrag_args:
        t = time.perf_counter()
        record["defrag_harness"] = defrag_harness(out_dir)
        record["defrag_harness"]["phase_s"] = time.perf_counter() - t
    with KernelArgs(FORK_TARGETS, key=fork_key) as auto_args:
        t = time.perf_counter()
        record["autoscale_harness"] = autoscale_harness(out_dir)
        record["autoscale_harness"]["phase_s"] = time.perf_counter() - t

    # scheduler profiles: SelectorSpread (K32) and Fit's strategies (K1) at
    # 5000 nodes, synchronous (its K32 / K1 calls kept for the timing
    # phase) and pipelined; then SchedulingWithMixedChurn through the harness
    with KernelArgs(PROFILE_TARGETS, key=profile_key) as profile_args:
        t = time.perf_counter()
        prof = profiles_path(out_dir=out_dir)
        record["profiles_path"] = prof["record"]
        record["profiles_path"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    record["profiles_path_pipelined"] = profiles_path(pipeline=True)["record"]
    record["profiles_path_pipelined"]["phase_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mc, _mc_pods, mc_launch = mixed_churn_harness("cuda", "5000Nodes")
    for k_ in PATH_KERNELS[:4]:
        if mc["window_launches"][k_] <= 0:
            fail(f"SchedulingWithMixedChurn/5000Nodes: kernel {k_} not launched in the window")
    record["mixed_churn_harness"] = {**mc, "launches": mc_launch,
                                     "phase_s": time.perf_counter() - t}
    log(f"SchedulingWithMixedChurn/5000Nodes through run_workload: {mc['pods_per_s']} pods/s, "
        f"attempt p50 {mc['attempt_p50_ms']:.1f} / p99 {mc['attempt_p99_ms']:.1f} ms, "
        f"window {mc['window_pipeline']}; {record['mixed_churn_harness']['phase_s']:.1f} s")

    # extenders: the round walk at 5000 nodes with a subprocess extender,
    # synchronous (K2 packed's calls kept for the timing phase) and async,
    # then SchedulingExtender/500Nodes through the harness; the keyed tie
    # noise: the full auction and the scan with rng_key (K33 / K17 keyed
    # calls kept), each beside the same cell without a key
    ext_url, stop_ext = start_extender_server()
    try:
        with KernelArgs(PACKED_TARGETS) as packed_args:
            t = time.perf_counter()
            record["extender_path"] = extender_path(ext_url, False)["record"]
            record["extender_path"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        record["extender_path_async"] = extender_path(ext_url, True)["record"]
        record["extender_path_async"]["phase_s"] = time.perf_counter() - t
        t = time.perf_counter()
        record["extender_harness"] = extender_harness()
        record["extender_harness"]["phase_s"] = time.perf_counter() - t
        with KernelArgs(KEYED_TARGETS) as keyed_args:
            t = time.perf_counter()
            record["keyed_paths"] = keyed_paths()
            record["keyed_paths_s"] = time.perf_counter() - t
        t = time.perf_counter()
        record["extender_cuda_vs_cpu"] = extender_cuda_vs_cpu(ext_url)
        record["extender_cuda_vs_cpu_s"] = time.perf_counter() - t
    finally:
        stop_ext()

    t = time.perf_counter()
    gpu_bind, gpu_launch, gpu_cycles, gpu_wall = hetero_bindings("cuda")
    cpu_bind, _cpu_launch, cpu_cycles, cpu_wall = hetero_bindings("cpu")
    if gpu_bind != cpu_bind:
        diff = [k for k in gpu_bind if gpu_bind[k] != cpu_bind.get(k)]
        fail(f"heterogeneous cluster: cuda and cpu bindings differ for {len(diff)} "
             f"pods, e.g. {diff[:3]}")
    for k_ in ("filter_score_planes", "normalize_combine", "topk_rows",
               "auction_resolve_commit"):
        if gpu_launch[k_] <= 0:
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

    record["spread_cuda_vs_cpu"] = {}
    for kind_ in ("spread", "preferred", "mixed"):
        t = time.perf_counter()
        gb, gl = spread_bindings("cuda", kind_)
        cb, _ = spread_bindings("cpu", kind_)
        if gb != cb:
            diff = [k for k in gb if gb[k] != cb.get(k)]
            fail(f"{kind_} spread cluster: cuda and cpu bindings differ for {len(diff)} "
                 f"pods, e.g. {diff[:3]}")
        if not all(gb.values()):
            fail(f"{kind_} spread cluster: not every pod bound")
        if gl["spread_score_combine"] <= 0 or gl["spread_update_classes"] <= 0:
            fail(f"{kind_} spread cluster: the spread kernels did not launch ({gl})")
        record["spread_cuda_vs_cpu"][kind_] = {"pods": len(gb), "launches": gl,
                                               "s": time.perf_counter() - t}
        log(f"{kind_} spread cluster, 1000 nodes / 1000 + 512 pods: cuda == cpu "
            f"bindings ({len(gb)} pods) in {time.perf_counter() - t:.1f} s")

    record["affinity_cuda_vs_cpu"] = {}
    for kind_ in ("anti", "affinity", "preferred", "mixed"):
        t = time.perf_counter()
        gb, gl = affinity_bindings("cuda", kind_)
        cb, _ = affinity_bindings("cpu", kind_)
        if gb != cb:
            diff = [k for k in gb if gb[k] != cb.get(k)]
            fail(f"{kind_} affinity cluster: cuda and cpu bindings differ for {len(diff)} "
                 f"pods, e.g. {diff[:3]}")
        unbound = sum(1 for v in gb.values() if not v)
        if kind_ != "anti" and unbound:
            fail(f"{kind_} affinity cluster: {unbound} pods unbound")
        for k_ in IPA_KERNELS:
            if gl[k_] <= 0:
                fail(f"{kind_} affinity cluster: kernel {k_} never launched ({gl})")
        record["affinity_cuda_vs_cpu"][kind_] = {"pods": len(gb), "unbound": unbound,
                                                 "launches": gl,
                                                 "s": time.perf_counter() - t}
        log(f"{kind_} affinity cluster, 1000 nodes / 200 + 512 pods: cuda == cpu "
            f"bindings ({len(gb)} pods, {unbound} unschedulable) in "
            f"{time.perf_counter() - t:.1f} s")

    record["engine_cuda_vs_cpu"] = {}
    for what in list(ENGINE_PATHS) + ["mixed queue"]:
        t = time.perf_counter()
        if what == "mixed queue":
            (gb, gl, gr), (cb, _, cr) = mixed_engine_bindings("cuda"), mixed_engine_bindings("cpu")
            need = ("scan_select_assume", "spread_update_row", "topk_rows",
                    "ipa_update_classes")
            if not {"scan", "full", "dedup"} <= set(gr):
                fail(f"mixed queue: the batches took {gr}, not every engine")
        else:
            (gb, gl, gr), (cb, _, cr) = engine_bindings("cuda", what), engine_bindings("cpu", what)
            need = ENGINE_PATHS[what][6]
        if gb != cb:
            diff = [k for k in gb if gb[k] != cb.get(k)]
            fail(f"{what} (1000 nodes): cuda and cpu bindings differ for {len(diff)} pods, "
                 f"e.g. {diff[:3]}")
        if gr != cr:
            fail(f"{what} (1000 nodes): cuda routes {gr} differ from cpu routes {cr}")
        for k_ in need:
            if gl[k_] <= 0:
                fail(f"{what} (1000 nodes): kernel {k_} never launched ({gl})")
        unbound = sum(1 for v in gb.values() if not v)
        if unbound:
            fail(f"{what} (1000 nodes): {unbound} pods unbound")
        record["engine_cuda_vs_cpu"][what] = {"pods": len(gb), "routes": gr, "launches": gl,
                                              "s": time.perf_counter() - t}
        log(f"{what}, 1000 nodes: cuda == cpu bindings ({len(gb)} pods, routes {gr}) in "
            f"{time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    (gb, gl), (cb, _) = gang_bindings("cuda"), gang_bindings("cpu")
    if gb != cb:
        diff = [k for k in gb if gb[k] != cb.get(k)]
        fail(f"GangBasic/500Nodes: cuda and cpu bindings differ for {len(diff)} pods, "
             f"e.g. {diff[:3]}")
    if not all(gb.values()):
        fail("GangBasic/500Nodes: not every gang pod bound")
    for k_ in PATH_KERNELS[:4] + GANG_KERNELS:
        if gl[k_] <= 0:
            fail(f"GangBasic/500Nodes: kernel {k_} never launched ({gl})")
    record["gang_bindings"] = {"pods": len(gb), "launches": gl, "s": time.perf_counter() - t}
    log(f"GangBasic/500Nodes: cuda == cpu bindings ({len(gb)} pods) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    g_res, c_res = gang_starved("cuda"), gang_starved("cpu")
    names = ("bindings", "PodGroup phases", "held binds per cycle",
             "queue counts per cycle", "partly bound gangs per cycle", "gang counters")
    for what, a, b in zip(names, g_res[:6], c_res[:6]):
        if a != b:
            fail(f"starved gangs: cuda and cpu differ in {what}")
    g_bind, g_phase, g_held, _g_active, g_partial, (g_att, g_to), g_launch = g_res
    n_bound = sum(1 for v in g_bind.values() if v)
    if max(g_partial) or n_bound % 8 or not max(g_held) or not g_to:
        fail(f"starved gangs: partly bound {max(g_partial)}, bound {n_bound}, held "
             f"{max(g_held)}, timeouts {g_to}: expected whole gangs only, holds and "
             "timeouts")
    for k_ in GANG_KERNELS:
        if g_launch[k_] <= 0:
            fail(f"starved gangs: kernel {k_} never launched ({g_launch})")
    record["gang_starved"] = {"bound": n_bound, "held_per_cycle": g_held,
                              "gang_attempts": g_att, "gang_timeouts": g_to,
                              "phases": sorted(set(g_phase.values())),
                              "launches": g_launch, "s": time.perf_counter() - t}
    log(f"starved gangs, 1020 nodes / 130 gangs of 8: cuda == cpu on bindings, phases, "
        f"held binds and requeues; {n_bound} pods bound in whole gangs, held binds per "
        f"cycle {g_held}, gang attempts {g_att}, timeouts {g_to} "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    g_res, c_res = claim_gang_bindings("cuda"), claim_gang_bindings("cpu")
    for what, a, b in zip(("bindings", "claims", "claim series"), g_res[:3], c_res[:3]):
        if a != b:
            fail(f"DeviceClaimGang/500Nodes cut to 125 nodes: cuda and cpu differ in {what}")
    if not all(g_res[0].values()) or g_res[2]["allocated"] != len(g_res[0]):
        fail(f"DeviceClaimGang/500Nodes cut to 125 nodes: not every pod bound with its "
             f"claim ({g_res[2]})")
    for k_ in DRA_KERNELS:
        if g_res[3][k_] <= 0:
            fail(f"DeviceClaimGang/500Nodes cut to 125 nodes: kernel {k_} never launched")
    record["claim_gang_bindings"] = {"pods": len(g_res[0]), "claim_series": g_res[2],
                                     "launches": g_res[3], "s": time.perf_counter() - t}
    log(f"DeviceClaimGang/500Nodes cut to 125 nodes (15 gangs, B = 64): cuda == cpu "
        f"bindings, claims and claim series ({len(g_res[0])} pods, {g_res[2]}) in "
        f"{time.perf_counter() - t:.1f} s")

    record["preempt_bindings"] = {}
    for kind_, need in (("basic", ("priority_prefix", "candidate_fit")),
                        ("requeue", ("priority_prefix", "candidate_fit", "prev_delta_apply")),
                        ("dense", ("candidate_dense",))):
        t = time.perf_counter()
        # the dense run's K29 arguments are kept for the timing phase
        with KernelArgs(PREEMPT_TARGETS if kind_ == "dense" else {}) as recorded:
            g_res = preempt_bindings("cuda", kind_)
        if kind_ == "dense":
            dense_args = recorded
        c_res = preempt_bindings("cpu", kind_)
        for what, a, b in zip(("bindings", "victims", "nominations", "outcomes"),
                              g_res[:4], c_res[:4]):
            if a != b:
                fail(f"preemption ({kind_}): cuda and cpu differ in {what}")
        pods, victims, noms, outcomes, launches = g_res
        if not all(pods.values()) or not victims or not outcomes["attempts"]:
            fail(f"preemption ({kind_}): expected every pod bound after preempting, got "
                 f"{sum(1 for v in pods.values() if not v)} unbound, {len(victims)} victims")
        if kind_ == "requeue" and (outcomes["fast_binds"] or not noms[0]):
            fail("preemption (requeue): expected nominations across cycles, no fast bind")
        for k_ in need:
            if launches[k_] <= 0:
                fail(f"preemption ({kind_}): kernel {k_} never launched ({launches})")
        record["preempt_bindings"][kind_] = {
            "pods": len(pods), "victims": len(victims), "nominated_per_step":
            [len(x) for x in noms], "outcomes": {k_: v for k_, v in outcomes.items()
                                                 if k_ != "victims_per_preemption"},
            "launches": launches, "s": time.perf_counter() - t}
        log(f"preemption ({kind_}): cuda == cpu on bindings, victims, nominations and "
            f"outcomes ({len(pods)} pods, {len(victims)} victims, nominated per step "
            f"{[len(x) for x in noms]}, {outcomes['fast_binds']} fast binds; launches "
            + ", ".join(f"{k_} {launches[k_]}" for k_ in need)
            + f") in {time.perf_counter() - t:.1f} s")

    record["whatif_bindings"] = {}
    for suite in ("Defrag", "AutoscaleGang"):
        t = time.perf_counter()
        g_res, c_res = whatif_bindings("cuda", suite), whatif_bindings("cpu", suite)
        for what, a, b in zip(("bindings", "evicted pods", "decisions", "fork counts",
                               "stacked predictions"), g_res[:5], c_res[:5]):
            if a != b:
                fail(f"{suite}/500Nodes: cuda and cpu differ in {what}")
        pods, evicted, decisions, forks_n, _vm, launches = g_res
        need = FORK_KERNELS if suite == "AutoscaleGang" else ("fork_masks",)
        for k_ in need + ("gang_all_or_nothing",):
            if launches[k_] <= 0:
                fail(f"{suite}/500Nodes: kernel {k_} never launched ({launches})")
        record["whatif_bindings"][suite] = {
            "pods": len(pods), "evicted": len(evicted), "decisions": decisions,
            "forks": forks_n, "launches": launches, "s": time.perf_counter() - t}
        log(f"{suite}/500Nodes driven synchronously with its controller: cuda == cpu on "
            f"bindings, evicted pods, decisions and fork counts ({len(pods)} pods, "
            f"{len(evicted)} evicted, {decisions}, {forks_n} forks), stacked == one-by-one "
            f"on the card; launches " + ", ".join(f"{k_} {launches[k_]}" for k_ in need)
            + f" ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    (gb, gr, gl), (cb, cr, _) = profiles_bindings("cuda"), profiles_bindings("cpu")
    if gb != cb:
        diff = [(p_, k_) for p_ in gb for k_ in gb[p_] if gb[p_][k_] != cb[p_].get(k_)]
        fail(f"profiles cut to 1000 nodes: cuda and cpu bindings differ for {len(diff)} "
             f"pods, e.g. {diff[:3]}")
    if gr != cr:
        fail(f"profiles cut to 1000 nodes: cuda routes {gr} differ from cpu routes {cr}")
    if gl["selector_spread_score"] <= 0:
        fail("profiles cut to 1000 nodes: K32 never launched")
    record["profiles_bindings"] = {"pods": {p_: len(v) for p_, v in gb.items()},
                                   "routes": gr, "launches": gl,
                                   "s": time.perf_counter() - t}
    log(f"profiles cut to 1000 nodes: cuda == cpu bindings and routes "
        f"({ {p_: len(v) for p_, v in gb.items()} }) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _, g_pods, g_launch = mixed_churn_harness("cuda", "1000Nodes")
    _, c_pods, _ = mixed_churn_harness("cpu", "1000Nodes")
    if g_pods != c_pods:
        diff = [k_ for k_ in g_pods if g_pods[k_] != c_pods.get(k_)]
        fail(f"SchedulingWithMixedChurn/1000Nodes: cuda and cpu bindings differ for "
             f"{len(diff)} pods, e.g. {diff[:3]}")
    record["mixed_churn_bindings"] = {"pods": len(g_pods), "launches": g_launch,
                                      "s": time.perf_counter() - t}
    log(f"SchedulingWithMixedChurn/1000Nodes through run_workload: cuda == cpu bindings "
        f"({len(g_pods)} pods) in {time.perf_counter() - t:.1f} s")

    record["cuda_pipelined_vs_sync"] = {}
    for kind_ in ("northstar", "spread", "preferred", "anti"):
        t = time.perf_counter()
        record["cuda_pipelined_vs_sync"][kind_] = pipelined_vs_sync(kind_)
        record["cuda_pipelined_vs_sync"][kind_]["s"] = time.perf_counter() - t

    pref = affinity["SchedulingPreferredPodAffinity"]
    rows = (time_kernels(ns["sched"], err) + time_spread_kernels(topo["sched"], err)
            + time_ipa_kernels(pref["sched"], err) + time_pipeline_kernels(path_calls, err))
    gang_rows = time_gang_kernels(gang_args.last, err)
    dra_rows = time_dra_kernels(dra_args.last, err)
    preempt_rows = time_preempt_kernels(preempt_args.last, dense_args.last, err, dev)
    record["k13_nominated_bundle"] = time_nominated_bundle(dev)
    fork_rows = time_fork_kernels(defrag_args.last, auto_args.last, err)
    profile_rows = time_profile_kernels(profile_args.last, prof["waves"], err)
    ext_rows = time_extender_kernels(
        keyed_args.last, packed_args.last, err,
        # the runs whose calls were recorded last: KEYED_RUNS' last full
        # auction and last scan
        {"plane": record["keyed_paths"]["TopologySpreading keyed, full auction"]["keyed"][
            "launches"]["tie_plane"],
         "scan": record["keyed_paths"]["TopologySpreading keyed"]["keyed"]["launches"],
         "packed": record["extender_path"]["launches"]["normalize_combine_packed"]})
    scan_args = dict(recorders["TopologySpreading scan"].last)
    scan_args["ipa_update_row"] = \
        recorders["SchedulingPreferredPodAffinity scan"].last["ipa_update_row"]
    scan_args["ipa_update_row tables"] = \
        recorders["SchedulingPodAffinity scan"].last["ipa_update_row"]
    full_args = dict(recorders["heterogeneous backlog"].last)
    full_args["ipa_update_classes"] = \
        recorders["SchedulingPodAntiAffinity priority 10"].last["ipa_update_classes"]
    full_args["ipa_score_combine"] = \
        recorders["SchedulingPodAntiAffinity priority 10"].last["ipa_score_combine"]
    scan_args["ipa_score_combine"] = \
        recorders["SchedulingPreferredPodAffinity scan"].last["ipa_score_combine"]
    full_args["spread_update_classes"] = \
        recorders["TopologySpreading priority 10, full auction"].last["spread_update_classes"]
    full_args["spread_filter_bits"] = \
        recorders["TopologySpreading priority 10, full auction"].last["spread_filter_bits"]
    engine_rows = time_engine_kernels(scan_args, full_args, err, reuse_err, dev)
    record["round_kernels_method"] = time_round_kernels(rows + engine_rows + ext_rows)
    record["extender_programs"] = time_extender_programs(ns["sched"], err)
    record["b9_row_bounds"] = b9_row_bounds(
        recorders["TopologySpreading scan"].last,
        recorders["SchedulingPreferredPodAffinity scan"].last)
    # device_ms's fallback, held against the profiler on one elementwise op
    # (4M floats), so that a run that needs it uses a method checked here
    x = torch.zeros(1 << 22, device=dev)
    record["queued_timing_check_ms"] = {
        "profiler": device_ms(lambda: x.add_(1.0)),
        "queued_events": queued_device_ms(lambda: x.add_(1.0))}
    log(f"timing check, 4M-float add_: profiler {record['queued_timing_check_ms']['profiler']:.5f}"
        f" ms, queued behind a spin {record['queued_timing_check_ms']['queued_events']:.5f} ms")
    # each kernel's launches on the path that carries it: K1–K8 on the
    # TopologySpreading run, K9–K12 on SchedulingPreferredPodAffinity, K13
    # and K16 on the NorthStar harness run, K14 on the pipelined
    # TopologySpreading run, K15 on the pipelined SchedulingPreferredPodAffinity
    carrier = {"prev_delta_apply": nsh, "scatter_rows": nsh, "spread_chain_prev": topo_pipe,
               "ipa_chain_prev": pref_pipe, **{k_: pref for k_ in IPA_KERNELS}}
    paths = {"NorthStar": ns, "NorthStar harness": nsh, "TopologySpreading": topo,
             "TopologySpreading pipelined": topo_pipe,
             "SchedulingPreferredPodAffinity pipelined": pref_pipe, **affinity}
    for r in rows:
        r["launches"] = carrier.get(r["name"], topo)["record"]["launches"][r["name"]]
        r["launches_by_path"] = {p_: v["record"]["launches"].get(r["name"])
                                 for p_, v in paths.items()}
    # the engine rows: K17 and K18 on the TopologySpreading scan, K19 on the
    # two pod-affinity scans (planes, tables), the C = 512 rows on the full
    # auctions that gave their arguments
    for r in engine_rows:
        run = engine_runs[ENGINE_CARRIER[r["name"]]]
        r["launches"] = run["launches"][r["kernel"]]
        # the kernel's device time per launch inside the path's profiled
        # cycle (idle gaps between launches; the timed calls run back to back)
        hits = [(ms, cnt) for ms, cnt, name in run["profile"].get("top", [])
                if kernel_hit(name, r["symbol"])]
        r["path_ms"] = sum(ms for ms, _ in hits) / max(sum(c for _, c in hits), 1) \
            if hits else None
        r["launches_by_path"] = {p_: v["launches"].get(r["kernel"])
                                 for p_, v in engine_runs.items()}
        if r["launches"] <= 0:
            fail(f"{r['name']}: no launch on {ENGINE_CARRIER[r['name']]}")
    rows += engine_rows
    # K20–K23: their launches on the GangBasic/5000Nodes synchronous run
    for r in gang_rows:
        r["launches"] = gang["record"]["launches"][r["name"]]
        r["launches_by_path"] = {"GangBasic": r["launches"],
                                 "GangBasic harness": record["gang_basic_harness"]
                                 ["launches"][r["name"]],
                                 "NorthStar": ns["record"]["launches"].get(r["name"])}
    rows += gang_rows
    # K24–K26: their launches on the DeviceClaimGang/5000Nodes synchronous run
    for r in dra_rows:
        r["launches"] = claim["record"]["launches"][r["name"]]
        r["launches_by_path"] = {"DeviceClaimGang": r["launches"],
                                 "DeviceClaimGang harness": record[
                                     "device_claim_gang_harness"]["launches"][r["name"]],
                                 "GangBasic": gang["record"]["launches"].get(r["name"])}
    rows += dra_rows
    # K27 / K28: their launches on the PreemptionBasic/5000Nodes synchronous
    # run; K29 on the dense cluster's cuda run
    for r in preempt_rows:
        carry = record["preempt_bindings"]["dense"] if r["name"] == "candidate_dense" \
            else preempt["record"]
        r["launches"] = carry["launches"][r["name"]]
        r["launches_by_path"] = {
            "PreemptionBasic": preempt["record"]["launches"][r["name"]],
            "PreemptionBasic harness": record["preemption_basic_harness"]["launches"][
                r["name"]],
            **{f"preemption ({k_})": v["launches"][r["name"]]
               for k_, v in record["preempt_bindings"].items()}}
    rows += preempt_rows
    # K30 on the Defrag harness run, K31 on the AutoscaleGang harness run
    fork_paths = {"Defrag harness": record["defrag_harness"],
                  "AutoscaleGang harness": record["autoscale_harness"],
                  **{f"{k_}/500Nodes (sync)": v for k_, v in
                     record["whatif_bindings"].items()}}
    for r in fork_rows:
        carry = "Defrag harness" if r["name"] == "fork_masks" else "AutoscaleGang harness"
        r["launches"] = fork_paths[carry]["launches"][r["name"]]
        r["launches_by_path"] = {p_: v["launches"][r["name"]] for p_, v in fork_paths.items()}
    rows += fork_rows
    # K32 and K1's strategy rows: their launches on the profiles path's
    # synchronous run (K1: in the wave of the profile with that strategy)
    for r in profile_rows:
        r["launches_by_path"] = {
            "profiles path": record["profiles_path"]["launches"].get(
                r["name"].split(" ")[0]),
            "profiles path (pipelined)": record["profiles_path_pipelined"]["launches"].get(
                r["name"].split(" ")[0])}
        if r["launches"] <= 0:
            fail(f"{r['name']}: no launch on the profiles path")
    rows += profile_rows
    # K33, K17 keyed and K2 packed: their launches on the keyed paths and
    # the extender path (the rows carry them); every path that ran them
    ext_paths = {"extender path": record["extender_path"],
                 "extender path (async)": record["extender_path_async"],
                 **{f"{k_} ({t_})": v[t_] for k_, v in record["keyed_paths"].items()
                    for t_ in ("keyed", "keyless")}}
    for r in ext_rows:
        kname = {"scan_select_assume (keyed)": "scan_select_keyed",
                 "normalize_combine (packed)": "normalize_combine_packed",
                 "tie_noise (plane)": "tie_plane", "tie_noise (step keys)": "tie_split",
                 "tie_noise (step row)": "tie_row"}[r["name"]]
        r["launches_by_path"] = {p_: v["launches"][kname] for p_, v in ext_paths.items()}
        if kname == "tie_row":  # select_host's draw: no path launches it
            if any(r["launches_by_path"].values()):
                fail(f"{r['name']}: launched on a path {r['launches_by_path']}")
        elif r["launches"] <= 0:
            fail(f"{r['name']}: no launch on the path that carries it")
    rows += ext_rows
    record["kfork_solve_bound"] = kfork_bound(record["defrag_harness"]["profile_evaluate"],
                                              rows, record["b9_row_bounds"])
    record["step2_order"] = step2_order(rows)
    record["kernels"] = rows
    record["profile"] = profile_cycle(
        ns["sched"], out_dir, "NorthStar-shaped",
        lambda i: default_pod(i, "prof"), "profile_cycle.txt")
    record["profile_spread"] = profile_cycle(
        topo["sched"], out_dir, "TopologySpreading", lambda i: spread_pod(i, "profspread",
                                                                          ts0=3e6),
        "profile_spread_cycle.txt")
    record["profile_affinity"] = profile_cycle(
        pref["sched"], out_dir, "SchedulingPreferredPodAffinity",
        lambda i: affinity_pod("preferred", i, "sched-1", ts0=3e6, tag="prof"),
        "profile_affinity_cycle.txt")
    record["total_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: all phases passed in {record['total_s']:.1f} s")
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "ms_source", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k_: r[k_] for k_ in keys} for r in rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def child_pids() -> list:
    """The processes whose parent is this one, from /proc."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            stat = Path(f"/proc/{d}/stat").read_text()
        except OSError:
            continue
        # the command name may hold spaces or parentheses: the parent's pid is
        # the second field after the last ')'
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(d))
    return out


def stop_children() -> None:
    """Stop and reap every process the script started, whether it passed or
    failed: the spawn extender servers still alive, multiprocessing's
    resource tracker (started with the first spawn child, it runs until its
    pipe closes, so it would outlive the script), then any other child."""
    import signal

    mp = sys.modules.get("multiprocessing")
    if mp is not None:
        for proc in mp.active_children():
            proc.terminate()
            proc.join(5)
        from multiprocessing import resource_tracker

        tracker = resource_tracker._resource_tracker
        if hasattr(tracker, "_stop"):
            tracker._stop()
        elif tracker._fd is not None:
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None
    for pid in child_pids():
        print(f"chip_smoke: stopping leftover child process {pid}", file=sys.stderr,
              flush=True)
        try:
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
