"""Hand-written CUDA kernels of the scheduling cycle, with their plain torch
versions.

Each wrapper takes the plain version for tensors that lie on the CPU and
launches its kernel for CUDA tensors (raising if the launch fails — there
is no fallback).  ``LAUNCHES`` counts, per kernel, its launches on the
card (K9 launches once per pass, so one of its wrapper calls may count
more than once); ``reset_launches`` zeroes the counts.

  K1 filter_score_planes  csrc/filter_score.cu (node tiles × class chunks,
                          the class rows and invariants staged once a block)
  K2 normalize_combine    csrc/normalize_combine.cu (one launch: a row over a
                          cluster of up to 8 blocks at C <= 16, each plane
                          read once)
  K3 topk_rows            csrc/topk_rows.cu
  K4 auction_resolve_commit csrc/auction.cu
  K5 spread_prepare_counts  csrc/spread.cu
  K6 spread_filter_bits     csrc/spread.cu
  K7 spread_score_combine   csrc/spread.cu
  K8 spread_update_classes  csrc/spread.cu (one launch a call, class_of read
                            as the engines' int64: a thread a (pod, row), two
                            dependent round trips, a warp's adds summed)
  K9 ipa_prepare            csrc/interpodaffinity.cu (ipa_prepare_counts,
                            ipa_existing_planes: one count per pass)
  K10 ipa_filter_bits       csrc/interpodaffinity.cu (one launch a call: a
                            run of nodes a thread, every load at entry, one
                            dependent round trip at most, a store only
                            where a bit clears)
  K11 ipa_score_combine     csrc/interpodaffinity.cu (one pass: a row over a
                            cluster of up to 8 blocks at C <= 16)
  K12 ipa_update_classes    csrc/interpodaffinity.cu (one launch a call for
                            every term group: commits compacted once a
                            block, domains keyed in a small table, node
                            tiles)
  K13 prev_delta_apply      csrc/prev_delta.cu (one launch a call: node tiles,
                            the copy fused in, shared-memory adds)
  K14 spread_chain_prev     csrc/spread.cu
  K15 ipa_chain_prev        csrc/interpodaffinity.cu (one launch per present
                            term group of this batch, and per prev term group
                            with a valid term)
  K16 scatter_rows          csrc/scatter_rows.cu (one launch per array group:
                            tiles of one array's rows over the whole card,
                            16-byte vectors, loads ahead of stores)
  K17 scan_select_assume    csrc/scan.cu (the exact scan: one launch per step,
                            one pass over the row split across a cluster
                            of up to 8 blocks; keyed, the step's noise
                            drawn inside, a thread's four nodes together)
  K18 spread_update_row     csrc/spread.cu (one launch per scan step)
  K19 ipa_update_row        csrc/interpodaffinity.cu (one launch per scan step)
  K20 gang_all_or_nothing   csrc/gang.cu (one launch per dispatch)
  K21 cosched_score_into    csrc/cosched.cu (per round or scan step of a
                            batch that anchors a gang)
  K22 diag_pack             csrc/diag_pack.cu (one launch per dispatch)
  K23 selector_match        csrc/selector_match.cu (one launch per selector
                            matrix: object tiles × chunks of result rows,
                            each label set read once into registers, the
                            rows' (row, term) verdicts as ballot words in
                            shared memory, the result written once in
                            16-byte stores)
  K24 dra_filter_bits       csrc/dra.cu (per round or scan step of a batch
                            with resource claims)
  K25 dra_score_into        csrc/dra.cu (the same; 4 nodes of 1–8 rows a
                            thread, bits, cap and free loaded at entry, a
                            row's totals only where an entry is feasible,
                            a 16-byte store there)
  K26 dra_take              csrc/dra.cu (per auction round or scan step)
  K27 priority_prefix       csrc/preempt.cu (once per failing batch that may
                            preempt, with at most 128 scheduled priorities;
                            one launch, the tier gathered by node tile in
                            row order in the kernel, no sort, each output
                            element written once)
  K28 candidate_fit         csrc/preempt.cu (the same; a block a tile of
                            128 nodes × 128 batch rows, the group's distinct
                            threshold rows staged once, 16 nodes a thread
                            in 16-byte loads and one 16-byte store)
  K29 candidate_dense       csrc/preempt.cu (the same, above 128 priorities;
                            one launch, the tier gathered by node tile in
                            row order in the kernel, no sort)
  K30 fork_masks            csrc/fork.cu (one launch per what-if evaluate over K
                            forks, or per fork when not stacked: output
                            tiles, the copy and the entries in one pass)
  K31 fork_add_rows         csrc/fork.cu (the same, when a fork adds nodes)
  K32 selector_spread_score csrc/selectorspread.cu (per round or scan step of
                            a batch under a profile with SelectorSpread; one
                            pass over a row split across a cluster of up to
                            8 blocks at C <= 16)
  K33 tie_noise             csrc/tie_noise.cu (a scheduler with an rng_key: the
                            full auction's noise plane once per round, the
                            scan's step keys once per batch; each entry —
                            tie_split, tie_plane, tie_row — counted apart
                            as well, ``tie_noise`` their sum)

K2 has a packed mode (``normalize_combine_packed``: the plane alone, −inf off
the mask, no feasible count) for the extender rounds' ``compute_packed``, and
K17 a keyed mode (``scan_select_keyed``: the uniform draw among the tied
maxima, under the step's key) for a scheduler with an rng_key; each mode
counts its own launches.

The full auction runs K1–K4, K6–K8 and K10–K12 at identity classes (one
class row per pod); the exact scan runs K1, K2, K6, K7, K10 and K11 on one
pod's row per step, then K17–K19.  Every dispatch ends in K20 (the gang
mask) and K22 (the packed result); K23 matches the selectors of the
plugins' inputs, and K21 adds Coscheduling's score where a gang anchors.
Under a profile with SelectorSpread, K32 adds its score to every round or
step; K1 computes Fit's plane under the profile's scoring strategy.
A batch with resource claims adds DynamicResources' filter (K24) and score
(K25) to every round or step and takes the placed pods' chips (K26).  A
failing batch whose pods may preempt runs K1 on its rows for the static bits
and the candidate mask (K27 + K28, or K29); the nominated pods' requests
ride K13 as one more bundle.  A what-if evaluate (whatif/engine.py) forks
the snapshot with K30 (and K31 when a fork adds nodes), then solves each
fork through the same engines, K13's nominated bundle and K20.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {
    "filter_score_planes": 0,
    "normalize_combine": 0,
    "topk_rows": 0,
    "auction_resolve_commit": 0,
    "spread_prepare_counts": 0,
    "spread_filter_bits": 0,
    "spread_score_combine": 0,
    "spread_update_classes": 0,
    "ipa_prepare": 0,
    "ipa_filter_bits": 0,
    "ipa_score_combine": 0,
    "ipa_update_classes": 0,
    "prev_delta_apply": 0,
    "spread_chain_prev": 0,
    "ipa_chain_prev": 0,
    "scatter_rows": 0,
    "scan_select_assume": 0,
    "spread_update_row": 0,
    "ipa_update_row": 0,
    "gang_all_or_nothing": 0,
    "cosched_score_into": 0,
    "diag_pack": 0,
    "selector_match": 0,
    "dra_filter_bits": 0,
    "dra_score_into": 0,
    "dra_take": 0,
    "priority_prefix": 0,
    "candidate_fit": 0,
    "candidate_dense": 0,
    "fork_masks": 0,
    "fork_add_rows": 0,
    "selector_spread_score": 0,
    "tie_noise": 0,
    "tie_split": 0,
    "tie_plane": 0,
    "tie_row": 0,
    "normalize_combine_packed": 0,
    "scan_select_keyed": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_CTYPE = {"i": ctypes.c_int, "u": ctypes.c_uint, "l": ctypes.c_longlong,
          "p": ctypes.c_void_p, "f": ctypes.c_float}


def bind(lib, name: str, spec: str):
    """The C launch function ``name`` with argtypes from ``spec`` (one letter
    per argument: i = int, u = unsigned int, l = long long, p = pointer,
    f = float); returns cudaError_t."""
    fn = getattr(lib, name)
    fn.argtypes = [_CTYPE[ch] for ch in spec]
    fn.restype = ctypes.c_int
    return fn


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor has ``dtype`` (the kernels read raw bytes)."""
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every input must be a CUDA tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev
