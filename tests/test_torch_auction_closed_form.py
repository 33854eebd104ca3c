"""K4's semantics on the CPU: ``auction_resolve_commit_plain`` against the
reference's propose/resolve fixpoint, and the one-class closed form that
K4 (csrc/auction.cu) ends a round with.

The reference is a test-local copy of the JAX package's ``pbody`` /
``pcond`` while_loop and ``apply_dyn`` scatter-add
(kubernetes_tpu/framework/runtime.py:898-939; the full path's twin is
:626-654), jitted on the CPU.  The closed form is mirrored in numpy as the
kernel runs it, in its prefix form: where no unresolved pod can take its
nominated row and the usable entries (finite, unused) of every unresolved
pod's list begin with the same m entries, the pod of rank r by position
takes the r-th of them for r < m — with one class, the whole list, so the
pods past its usable entries drop in the next iteration; otherwise one
loop iteration.  The inputs are made with numpy
from a seed; the candidate lists are a stable descending sort's first K
columns, as K3 gives them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kernels.auction import (
    auction_resolve_commit,
    auction_resolve_commit_plain,
)

R = 8


@jax.jit
def jax_round(cv_c, ci_c, class_of, pos_of, unresolved0, nom, nom_ok, request, pod_nz,
              requested, node_nz):
    """The reference's round fixpoint and commit (runtime.py:898-939)."""
    b = class_of.shape[0]
    n_cap = requested.shape[0]
    cv = cv_c[class_of]
    ci = ci_c[class_of]

    def pcond(c):
        unresolved, _, _, _ = c
        return jnp.any(unresolved)

    def pbody(c):
        unresolved, used, commit, choice = c
        ok = (cv > -jnp.inf) & ~used[ci]
        first = jnp.argmax(ok, axis=1)
        prop = ci[jnp.arange(b), first]
        has_cand = jnp.any(ok, axis=1)
        take_nom = nom_ok & ~used[nom]
        prop = jnp.where(take_nom, nom, prop)
        has_bid = jnp.where(take_nom, True, has_cand)
        bidder = unresolved & has_bid
        posb = jnp.where(bidder, pos_of, b)
        minpos_n = jnp.full(n_cap, b, pos_of.dtype).at[prop].min(posb)
        win = bidder & (minpos_n[prop] == posb)
        commit = commit | win
        choice = jnp.where(win, prop, choice)
        used = used.at[prop].max(win)
        return unresolved & ~win & has_bid, used, commit, choice

    _, _, commit, choice = jax.lax.while_loop(
        pcond, pbody, (unresolved0, jnp.zeros(n_cap, bool), jnp.zeros(b, bool),
                       jnp.zeros(b, jnp.int32)))
    rows = jnp.clip(choice, 0, n_cap - 1)
    addm = commit[:, None]
    req = requested.at[rows].add(jnp.where(addm, request, 0).astype(requested.dtype))
    nz = node_nz.at[rows].add(jnp.where(addm, pod_nz, 0).astype(node_nz.dtype))
    return commit, choice, req, nz


def usable_lists(cv, ci, class_of, used):
    """[B, K] each pod's usable entries (finite, unused) in list order,
    left-aligned, −1 past the end."""
    cvb, cib = cv[class_of], ci[class_of]
    ok = (cvb > -np.inf) & ~used[cib]
    order = np.argsort(~ok, axis=1, kind="stable")
    seq = np.take_along_axis(cib, order, axis=1)
    return np.where(np.take_along_axis(ok, order, axis=1), seq, -1)


def mirror(cv, ci, class_of, pos_of, unresolved0, nom, nom_ok, request, pod_nz,
           requested, node_nz):
    """K4's structure in numpy: at an iteration where no unresolved pod can
    take its nominated row and the usable entries of every unresolved pod's
    list begin with the same m >= 1 entries, the closed form's prefix form
    gives the pod of rank r by position the r-th of them (r < m); else one
    loop iteration → (commit, choice, requested, node_nz, iterations,
    prefix-form steps).  With one class the prefix is the list's usable
    entries and one step ends the round."""
    b = class_of.shape[0]
    n = requested.shape[0]
    used = np.zeros(n, bool)
    unres = unresolved0.copy()
    commit = np.zeros(b, bool)
    choice = np.zeros(b, np.int32)
    iters, steps = 0, 0
    while unres.any():
        iters += 1
        nom_bid = unres & nom_ok & ~used[nom]
        if not nom_bid.any():
            seq = usable_lists(cv, ci, class_of, used)[unres]
            ref = seq[0]
            m = min(int((ref >= 0).sum()), int(unres.sum()))
            if m > 0:
                same = seq[:, :m] == ref[None, :m]
                m = int(np.where(same.all(axis=1), m, np.argmin(same, axis=1)).min())
            if m > 0:
                pods = np.flatnonzero(unres)[np.argsort(pos_of[unres], kind="stable")]
                for r, p in enumerate(pods[:m]):
                    commit[p] = True
                    choice[p] = ref[r]
                    used[ref[r]] = True
                    unres[p] = False
                steps += 1
                continue
        cvb, cib = cv[class_of], ci[class_of]
        ok = (cvb > -np.inf) & ~used[cib]
        prop = np.where(nom_bid, nom, cib[np.arange(b), np.argmax(ok, axis=1)])
        has_bid = nom_bid | ok.any(axis=1)
        bidder = unres & has_bid
        posb = np.where(bidder, pos_of, b)
        minpos = np.full(n, b, np.int64)
        np.minimum.at(minpos, prop, posb)
        win = bidder & (minpos[prop] == posb)
        commit |= win
        choice = np.where(win, prop, choice).astype(np.int32)
        used[prop[win]] = True
        unres = unres & ~win & has_bid
    req, nz = requested.copy(), node_nz.copy()
    for i in np.flatnonzero(commit):
        req[choice[i]] += request[i]
        nz[choice[i]] += pod_nz[i]
    return commit, choice, req, nz, iters, steps


def make_case(rng, *, n=8192, b=512, k=512, classes=1, nominated=0.0, resolved=0.0,
              permuted=True, finite=None, same_list=False, overlap=False):
    """K4's inputs as numpy arrays (chip_smoke.py's auction_case, made with
    numpy): the top K of random class rows by (value desc, column asc)."""
    if overlap:
        base = rng.integers(0, 100, n).astype(np.float32)
        vals = base + rng.integers(0, 3, (classes, n)).astype(np.float32)
    else:
        vals = rng.integers(0, 20, (classes, n)).astype(np.float32)
    vals[rng.random((classes, n)) < 0.1] = -np.inf
    if finite is not None:
        vals[:, finite:] = -np.inf
    if same_list:
        vals[1:] = vals[0]
    idx = np.argsort(-vals, axis=1, kind="stable")[:, :k].astype(np.int32)
    cv = np.take_along_axis(vals, idx, axis=1)
    class_of = rng.integers(0, classes, b).astype(np.int32)
    unres = rng.random(b) >= resolved
    nom_ok = rng.random(b) < nominated
    in_list = idx[class_of, rng.integers(0, k, b)]
    nom = np.where(rng.random(b) < 0.5, in_list, rng.integers(0, n, b)).astype(np.int32)
    pos_of = (rng.permutation(b) if permuted else np.arange(b)).astype(np.int32)
    request = rng.integers(1, 500, (b, R)).astype(np.int32)
    pod_nz = request[:, :2].copy()
    requested = rng.integers(0, 1 << 20, (n, R)).astype(np.int32)
    node_nz = requested[:, :2].copy()
    return (cv, idx, class_of, pos_of, unres, nom, nom_ok, request, pod_nz, requested,
            node_nz)


def run_plain(case):
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in case]
    req, nz = t[9].clone(), t[10].clone()
    commit, choice, iters = auction_resolve_commit_plain(
        t[0], t[1], t[2].long(), t[3].long(), t[4], t[5].long(), t[6], t[7], t[8], req, nz,
        count_iters=True)
    return commit.numpy(), choice.numpy(), req.numpy(), nz.numpy(), int(iters[0])


def run_jax(case):
    out = jax_round(*[jnp.asarray(x) for x in case])
    return tuple(np.asarray(x) for x in out)


def assert_same(a, b, what):
    for name, x, y in zip(("commit", "choice", "requested", "non_zero"), a, b):
        assert np.array_equal(x, y), f"{what}: {name} differs"


# K4's cases at N <= 8192 (chip_smoke.py's AUCTION_CASES): keywords, and
# whether the closed form must end the fixpoint
CASES = {
    "one class, 5% nominated": (dict(nominated=0.05), True),
    "one class, fewer finite entries than bidders": (dict(finite=300), True),
    "one class, 30% resolved, permuted": (dict(resolved=0.3), True),
    "one class, identical pods in order": (dict(permuted=False), True),
    "two classes, one list": (dict(classes=2, same_list=True), False),
    "400 overlapping classes": (dict(classes=400, overlap=True, nominated=0.05,
                                     resolved=0.1), False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_and_closed_form_match_reference(name):
    """The plain version and the numpy mirror of K4 (loop, then the closed
    form) equal the reference's fixpoint on commit, choice, requested and
    non_zero; the one-class cases end in the closed form."""
    kw, closed_expected = CASES[name]
    case = make_case(np.random.default_rng(list(CASES).index(name)), **kw)
    want = run_jax(case)
    plain = run_plain(case)
    assert_same(plain[:4], want, f"{name}: plain")
    m = mirror(*case)
    assert_same(m[:4], want, f"{name}: closed-form mirror")
    if closed_expected:
        assert m[5], f"{name}: the closed form did not end the fixpoint"
        # the mirror ends in at most one iteration past the nominated bids
        assert m[4] <= 2 < plain[4]


def test_closed_form_random_one_class_cases():
    """200 random one-class rounds (small shapes, nominated rows switched on
    and off, some pods resolved, positions permuted, short lists): the
    closed-form mirror equals the plain version and the reference, and the
    closed form ends every round that has an unresolved pod."""
    rng = np.random.default_rng(12)
    closed = 0
    for t in range(200):
        nominated = 0.0 if t % 2 == 0 else float(rng.choice([0.05, 0.2, 0.5]))
        case = make_case(rng, n=64, b=32, k=32, nominated=nominated,
                         resolved=float(rng.choice([0.0, 0.3])),
                         permuted=bool(t % 3), finite=int(rng.integers(8, 64)))
        want = run_jax(case)
        assert_same(run_plain(case)[:4], want, f"case {t}: plain")
        m = mirror(*case)
        assert_same(m[:4], want, f"case {t}: closed-form mirror")
        if case[4].any():
            assert m[5], f"case {t}: the closed form did not end the fixpoint"
            closed += 1
    assert closed >= 190


def test_closed_form_needs_no_nominated_bid():
    """A nominated pod whose row is still unused keeps the round in the loop:
    the closed form starts only once its bid is resolved, and the result is
    still the reference's."""
    rng = np.random.default_rng(3)
    case = list(make_case(rng, n=64, b=16, k=16))
    case[6] = np.zeros(16, bool)
    case[6][5] = True  # pod 5 nominated to a node outside the top of the list
    case[5] = np.full(16, 63, np.int32)
    want = run_jax(tuple(case))
    m = mirror(*case)
    assert_same(m[:4], want, "nominated")
    assert m[5] and m[4] == 2


def test_count_iters_on_the_cpu():
    """The wrapper's optional iteration output on CPU tensors: the plain
    version's loop count, and 0 for the closed form it does not have."""
    case = make_case(np.random.default_rng(4), n=64, b=16, k=16)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in case]
    commit, choice, iters = auction_resolve_commit(
        t[0], t[1], t[2].long(), t[3].long(), t[4], t[5].long(), t[6], t[7], t[8],
        t[9].clone(), t[10].clone(), count_iters=True)
    want = run_jax(case)
    assert np.array_equal(commit.numpy(), want[0])
    assert np.array_equal(choice.numpy(), want[1])
    assert iters.dtype == torch.int32 and iters.shape == (2,)
    assert int(iters[0]) >= 1 and int(iters[1]) == 0
