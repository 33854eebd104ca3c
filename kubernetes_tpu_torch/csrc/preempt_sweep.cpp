// Host C++ preemption victim sweep: the reprieve loop + 6-criteria candidate
// ranking of Evaluator.preempt_plain (kubernetes_tpu_torch/preemption.py)
// over flat arrays.  A copy of the JAX package's native/preempt_sweep.cpp.
//
// Reference semantics: framework/preemption/preemption.go DryRunPreemption
// (:546) victim minimization -- victims ordered violating-first then by
// descending importance, each reprieved if the preemptor still fits with it
// restored -- and pickOneNodeForPreemption (:397) lexicographic ranking:
// fewest PDB violations, lowest top victim priority, lowest priority sum,
// fewest victims, latest earliest-start among top-priority victims; full
// ties resolve to window order.  The numpy pass in whatif/dryrun.py
// (sweep_and_rank) is its plain version; tests/test_torch_preemption.py
// holds the two equal on the rows the contract defines (valid candidates).
//
// Build: g++ -O2 -shared -fPIC, at first use, into build/kernels/
// (kernels/build.py HOST_SOURCES).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Inputs (row-major):
//   base[C][R]   used-minus-all-victims per candidate
//   alloc[C][R]  allocatable
//   vr[C][V][R]  per-victim request vectors (violating-first, importance-desc)
//   v_valid[C][V] (uint8), v_viol[C][V] (uint8)
//   v_prio[C][V] (int64), v_ts[C][V] (double)
//   req[R]       preemptor request
// Outputs:
//   victim_mask[C][V] (uint8)  final victims (valid & !reprieved)
//   order[C] (int32)           candidate indices, best-ranked first
//   nviol[C] (int32)           PDB violations among final victims
//   valid_out[C] (uint8)       candidate feasible with >0 victims
// Returns the number of valid candidates.
int64_t ktpu_preempt_sweep(
    int64_t C, int64_t V, int64_t R,
    const int64_t* base, const int64_t* alloc, const int64_t* vr,
    const uint8_t* v_valid, const uint8_t* v_viol,
    const int64_t* v_prio, const double* v_ts,
    const int64_t* req,
    uint8_t* victim_mask, int32_t* order, int32_t* nviol,
    uint8_t* valid_out)
{
    std::vector<int64_t> used(R);
    // per-candidate rank keys
    std::vector<int64_t> k_top(C), k_sum(C), k_cnt(C);
    std::vector<double> k_early(C);

    for (int64_t c = 0; c < C; ++c) {
        const int64_t* b = base + c * R;
        const int64_t* a = alloc + c * R;
        bool feasible = true;
        for (int64_t r = 0; r < R; ++r) {
            if (req[r] != 0 && req[r] > a[r] - b[r]) { feasible = false; break; }
        }
        int32_t count = 0, viol = 0;
        int64_t top = INT64_MIN, sum = 0;
        double early = 1e300;
        std::memcpy(used.data(), b, R * sizeof(int64_t));
        for (int64_t v = 0; v < V; ++v) {
            uint8_t vm = 0;
            if (feasible && v_valid[c * V + v]) {
                // reprieve: restore this victim if the preemptor still fits
                const int64_t* w = vr + (c * V + v) * R;
                bool fits = true;
                for (int64_t r = 0; r < R; ++r) {
                    if (req[r] != 0 && req[r] > a[r] - (used[r] + w[r])) {
                        fits = false; break;
                    }
                }
                if (fits) {
                    for (int64_t r = 0; r < R; ++r) used[r] += w[r];
                } else {
                    vm = 1;
                    ++count;
                    int64_t p = v_prio[c * V + v];
                    if (v_viol[c * V + v]) ++viol;
                    sum += p + (int64_t(1) << 31);
                    if (p > top) { top = p; early = v_ts[c * V + v]; }
                    else if (p == top && v_ts[c * V + v] < early)
                        early = v_ts[c * V + v];
                }
            }
            victim_mask[c * V + v] = vm;
        }
        bool ok = feasible && count > 0;
        valid_out[c] = ok ? 1 : 0;
        nviol[c] = viol;
        k_top[c] = ok ? top : INT64_MAX;
        k_sum[c] = ok ? sum : INT64_MAX;
        k_cnt[c] = ok ? count : INT32_MAX;
        k_early[c] = ok ? early : -1e300;  // ranking prefers LATEST earliest
    }

    int64_t n_valid = 0;
    for (int64_t c = 0; c < C; ++c) { order[c] = (int32_t)c; if (valid_out[c]) ++n_valid; }
    std::stable_sort(order, order + C, [&](int32_t x, int32_t y) {
        if (valid_out[x] != valid_out[y]) return valid_out[x] > valid_out[y];
        if (nviol[x] != nviol[y]) return nviol[x] < nviol[y];
        if (k_top[x] != k_top[y]) return k_top[x] < k_top[y];
        if (k_sum[x] != k_sum[y]) return k_sum[x] < k_sum[y];
        if (k_cnt[x] != k_cnt[y]) return k_cnt[x] < k_cnt[y];
        if (k_early[x] != k_early[y]) return k_early[x] > k_early[y];
        return false;  // stable: window order breaks full ties
    });
    return n_valid;
}

}  // extern "C"
