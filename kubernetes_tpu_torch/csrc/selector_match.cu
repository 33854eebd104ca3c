// K23 selector_match: compiled label / node selectors against label sets.
//
// Replaces (JAX package): state/selectors.py requirements_match_matrix
// (:299), label_match_matrix (:345) and node_match_matrix (:357), and with
// them plugins/helpers.py weighted_term_matrix (:35) and
// flat_selector_matrix (:52): requirement sets [U, T, S] (key, op, values
// [V], numeric right-hand side) against objects' label sets [O, L] (keys,
// value ids, numeric values) -> bool[B, O] through the per-pod index.
//
// Rules, exactly those of the plain version:
// - a requirement with op OP_PAD (-1) is true (the AND identity), as is an
//   unknown op code;
// - present = the object has the key (a key < 0 is never present); val = the
//   largest value id among the label columns with the key (keys are unique
//   per object, so at most one column matches), -1 when absent;
// - In: present and val among the values (a value id < 0 never matches);
//   NotIn: absent, or val not among them (an absent key matches);
//   Exists / DoesNotExist: present / absent;
// - Gt / Lt: present and the label's number > / < the right-hand side, in
//   float32; false on NaN (an unparseable value or right-hand side) and on
//   an absent key; the label's number is vals_num when given, else the
//   dictionary's numeric side-table at the value id (NaN for an id < 0);
//   with has_numeric = 0 they are false without reading either;
// - AND over the S requirements of a term;
// - label mode (term_valid null, T = 1): the term's result, false where
//   match_none; node mode: OR over the valid terms (an invalid term matches
//   nothing), true where match_all.
//
// Two stages in one launch call: one thread per (unique row, object) loops
// over T terms, S requirements, L label columns and V values into a byte
// matrix [U, O]; then one thread per (pod, object) gathers its unique row by
// index into bool [B, O].  Bound on the card: bytes (the label sets read
// once, the [B, O] result written once; the loops stay in registers).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define OP_IN 0
#define OP_NOT_IN 1
#define OP_EXISTS 2
#define OP_DOES_NOT_EXIST 3
#define OP_GT 4
#define OP_LT 5
#define OP_PAD (-1)

struct Reqs {
  const int32_t* key;    // [U, T, S]
  const int32_t* op;     // [U, T, S]
  const int32_t* vals;   // [U, T, S, V]
  const float* num;      // [U, T, S]
  const uint8_t* term_valid;  // [U, T] or null (label mode)
  const uint8_t* match_all;   // [U] or null
  const uint8_t* match_none;  // [U] or null
};

struct Labels {
  const int32_t* keys;   // [O, L]
  const int32_t* vals;   // [O, L]
  const float* vals_num; // [O, L] or null
  const float* numeric;  // [D] or null
  int D;
};

__device__ bool requirement_ok(const Reqs& r, const Labels& lb, int L, int V,
                               int has_numeric, long long rs, int o) {
  const int op = r.op[rs];
  if (op == OP_PAD || op < OP_IN || op > OP_LT) return true;
  const int rk = r.key[rs];
  bool present = false;
  int val = -1;
  float vn = -INFINITY;
  const long long base = (long long)o * L;
  for (int l = 0; l < L; ++l) {
    if (rk < 0 || lb.keys[base + l] != rk) continue;
    present = true;
    const int v = lb.vals[base + l];
    val = max(val, v);
    if (has_numeric) {
      float x;
      if (lb.vals_num != nullptr) {
        x = lb.vals_num[base + l];
      } else if (v >= 0) {
        x = lb.numeric[min(v, lb.D - 1)];
      } else {
        x = NAN;
      }
      // the plain version's amax propagates NaN
      vn = (isnan(vn) || isnan(x)) ? NAN : fmaxf(vn, x);
    }
  }
  switch (op) {
    case OP_EXISTS:
      return present;
    case OP_DOES_NOT_EXIST:
      return !present;
    case OP_GT:
      return has_numeric && present && vn > r.num[rs];
    case OP_LT:
      return has_numeric && present && vn < r.num[rs];
    default:
      break;
  }
  bool in_vals = false;
  if (val >= 0) {
    const int32_t* rv = r.vals + rs * V;
    for (int v = 0; v < V; ++v) in_vals |= (rv[v] == val);
  }
  return op == OP_IN ? (present && in_vals) : (!present || !in_vals);
}

__global__ void selector_unique_kernel(int U, int T, int S, int V, int O, int L,
                                       int has_numeric, Reqs r, Labels lb,
                                       uint8_t* __restrict__ m_u) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)U * O) return;
  const int u = (int)(k / O);
  const int o = (int)(k - (long long)u * O);
  bool any_term = false;
  for (int t = 0; t < T; ++t) {
    if (r.term_valid != nullptr && !r.term_valid[(long long)u * T + t]) continue;
    bool ok = true;
    for (int s = 0; s < S && ok; ++s)
      ok = requirement_ok(r, lb, L, V, has_numeric, ((long long)u * T + t) * S + s, o);
    any_term |= ok;
  }
  bool m = any_term;
  if (r.match_all != nullptr && r.match_all[u]) m = true;
  if (r.match_none != nullptr && r.match_none[u]) m = false;
  m_u[k] = m ? 1 : 0;
}

__global__ void selector_gather_kernel(int B, int O, const int32_t* __restrict__ index,
                                       const uint8_t* __restrict__ m_u,
                                       uint8_t* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (long long)B * O) return;
  const int b = (int)(k / O);
  const int o = (int)(k - (long long)b * O);
  const long long u = index == nullptr ? b : index[b];
  out[k] = m_u[u * O + o];
}

extern "C" int launch_selector_match(int U, int T, int S, int V, int O, int L, int B,
                                     int has_numeric, const void* req_key,
                                     const void* req_op, const void* req_vals,
                                     const void* req_num, const void* term_valid,
                                     const void* match_all, const void* match_none,
                                     const void* keys, const void* vals,
                                     const void* vals_num, const void* numeric, int D,
                                     const void* index, void* m_u, void* out,
                                     void* stream) {
  if (U <= 0 || O <= 0 || B <= 0) return 0;
  Reqs r{(const int32_t*)req_key, (const int32_t*)req_op, (const int32_t*)req_vals,
         (const float*)req_num, (const uint8_t*)term_valid, (const uint8_t*)match_all,
         (const uint8_t*)match_none};
  Labels lb{(const int32_t*)keys, (const int32_t*)vals, (const float*)vals_num,
            (const float*)numeric, D};
  const int threads = 256;
  const long long w1 = (long long)U * O;
  selector_unique_kernel<<<(unsigned)((w1 + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(U, T, S, V, O, L, has_numeric, r, lb,
                                                   (uint8_t*)m_u);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long w2 = (long long)B * O;
  selector_gather_kernel<<<(unsigned)((w2 + threads - 1) / threads), threads, 0,
                           (cudaStream_t)stream>>>(B, O, (const int32_t*)index,
                                                   (const uint8_t*)m_u, (uint8_t*)out);
  return (int)cudaGetLastError();
}
