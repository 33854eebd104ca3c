"""Scheduler extenders on the port against the JAX package.

* The protocol (kubernetes_tpu_torch/extender.py), the cases of
  tests/test_extender.py, tests/test_extender_e2e.py and the extender cases
  of tests/test_chaos.py on the port: the filter round trip, the weighted
  prioritize, ignorable and non-ignorable transport failures, the circuit
  breaker, a chunked Go-style reply, the default-port Host header; and in
  a TorchScheduler: a filter that steers placement, managedResources
  gating, and the preemption callout in both forms (full pods under
  nodeNameToVictims, uids under nodeNameToMetaVictims).
* The round walk (TorchScheduler's ``_assign_with_extenders``) against
  TPUScheduler's on one cluster: 120 nodes (above 100, so an extender sees
  a k_cap-capped window that rotates), an extender whose filter rejects
  every node whose index is 3 mod 7 and whose prioritize scores
  (index · 37) mod 11, a second extender whose prioritize fails (ignored),
  plain pods, a coupled zone-spread series that needs several rounds, a pod
  the extender rejects everywhere and one that fits no node — synchronous
  and async, with ``serialize_extender_callouts`` "auto" and "always": the
  same node for every pod, only approved nodes, the same rounds.
* An async walk that dies requeues its batch through the backoff queue.
* The round programs against the JAX functions on the JAX encoder's
  arrays: ``compute_packed`` (K1 + K2's packed mode), ``compute_static``
  and ``compute_row`` on several rows, and ``apply_commits`` (the dynamic
  state, and the next round's packed plane, which reads every updated aux).

Tolerance: exact (bindings, integer state, float32 planes bit for bit).
"""

from __future__ import annotations

import http.server
import io
import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.extender import ExtenderConfig as JCfg
from kubernetes_tpu.extender import HTTPExtender as JExt
from kubernetes_tpu.scheduler import TPUScheduler
from kubernetes_tpu.sim.store import ObjectStore as JStore
from kubernetes_tpu_torch.extender import (
    CIRCUIT_CLOSED,
    CIRCUIT_OPEN,
    CircuitBreaker,
    ExtenderConfig,
    ExtenderError,
    HTTPExtender,
    TPUScoreExtenderServer,
    _read_body,
    uniform_score_fn,
)
from kubernetes_tpu_torch.scheduler import TorchScheduler, _num_feasible_nodes
from kubernetes_tpu_torch.sim.store import ObjectStore
from kubernetes_tpu_torch.testutil import make_node, make_pod

from tests.test_torch_common import ZONE, _plain_node, fake_clock, make_node_obj, make_pod_obj
from tests.test_torch_fullpath import FULL_PROBLEMS
from tests.test_torch_scan import _eq


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def server():
    def score_fn(pod_dict, names):
        feasible = [n for n in names if int(n[-1]) % 2 == 0]
        return feasible, {n: i * 10 for i, n in enumerate(names)}

    srv = TPUScoreExtenderServer(score_fn)
    srv.start()
    yield srv
    srv.stop()


def _client(srv, **kw):
    return HTTPExtender(ExtenderConfig(
        url_prefix=srv.url, filter_verb="filter", prioritize_verb="prioritize",
        node_cache_capable=True, **kw))


def _pod(name="p", **req):
    return make_pod().name(name).uid(name).namespace("default").req(req or {"cpu": "1"}).obj()


# --- the protocol -----------------------------------------------------------


def test_filter_round_trip(server):
    ext = _client(server)
    feasible, failed = ext.filter(_pod(), ["n0", "n1", "n2", "n3"])
    assert feasible == ["n0", "n2"] and set(failed) == {"n1", "n3"}
    assert ext.callouts == {"filter": 1} and ext.circuit_state == CIRCUIT_CLOSED
    ext.close()


def test_prioritize_weighted(server):
    ext = _client(server, weight=3)
    assert ext.prioritize(_pod(), ["n0", "n2"]) == {"n0": 0, "n2": 30}
    ext.close()


def test_ignorable_extender_swallows_errors():
    ext = HTTPExtender(ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                                      ignorable=True, http_timeout=0.2))
    feasible, failed = ext.filter(_pod(), ["n0"])
    assert feasible == ["n0"] and not failed


def test_non_ignorable_extender_raises():
    ext = HTTPExtender(ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                                      http_timeout=0.2))
    with pytest.raises(ExtenderError):
        ext.filter(_pod(), ["n0"])


def test_circuit_breaker_opens_half_opens_and_recovers():
    clock = _Clock()
    br = CircuitBreaker(failure_threshold=3, reset_seconds=10, clock=clock)
    assert br.allow() and br.state == CIRCUIT_CLOSED
    for _ in range(3):
        br.failure()
    assert br.state == CIRCUIT_OPEN and not br.allow()
    clock.advance(10.1)
    assert br.allow() and not br.allow()  # one half-open probe
    br.failure()
    assert br.state == CIRCUIT_OPEN and not br.allow()
    clock.advance(10.1)
    assert br.allow()
    br.success()
    assert br.state == CIRCUIT_CLOSED and br.allow()


def test_read_body_decodes_chunked_transfer_encoding():
    wire = b"7\r\n{\"noden\r\n10\r\names\": [\"n1\"]}  \r\n0\r\n\r\n"
    assert json.loads(_read_body(io.BytesIO(wire), {b"transfer-encoding": b"chunked"})) == \
        {"nodenames": ["n1"]}
    wire = b"5;ext=1\r\nhello\r\n0\r\nTrailer: x\r\n\r\n"
    assert _read_body(io.BytesIO(wire), {b"transfer-encoding": b"chunked"}) == b"hello"
    assert _read_body(io.BytesIO(b"zz\r\n"), {b"transfer-encoding": b"chunked"}) is None


def test_extender_client_against_chunked_go_style_server():
    """A Go extender writing through json.NewEncoder replies chunked
    (tests/test_chaos.py:679)."""

    class Chunked(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            payload = json.dumps({"nodenames": ["n1"], "failedNodes": {"n0": "no"}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for part in (payload[:10], payload[10:]):
                self.wfile.write(f"{len(part):X}\r\n".encode() + part + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Chunked)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        ext = HTTPExtender(ExtenderConfig(
            url_prefix=f"http://127.0.0.1:{httpd.server_address[1]}",
            filter_verb="filter", node_cache_capable=True))
        assert ext.filter(_pod(), ["n0", "n1"]) == (["n1"], {"n0": "no"})
        ext.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_host_header_resolves_default_port():
    sent = []

    class FakeSock:
        def sendall(self, data):
            sent.append(data)

        def close(self):
            pass

    body = json.dumps({"nodenames": ["n1"], "failedNodes": {}}).encode()
    reply = b"HTTP/1.1 200 OK\r\nContent-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body
    ext = HTTPExtender(ExtenderConfig(url_prefix="http://example.com", filter_verb="filter"))
    ext._fresh_conn = lambda: (FakeSock(), io.BytesIO(reply))
    assert ext.filter(_pod(), ["n0", "n1"])[0] == ["n1"]
    assert b"Host: example.com:80\r\n" in sent[0] and b"None" not in sent[0]


# --- the extender in a TorchScheduler ----------------------------------------


def test_extender_filter_steers_placement():
    srv = TPUScoreExtenderServer(
        lambda pod, names: ([n for n in names if n.endswith("1")], {n: 0 for n in names}))
    srv.start()
    try:
        ext = HTTPExtender(ExtenderConfig(url_prefix=srv.url, filter_verb="filter",
                                          node_cache_capable=True))
        store = ObjectStore()
        sched = TorchScheduler(store, batch_size=4, device="cpu", extenders=[ext])
        store.create("Node", make_node().name("n0").obj())
        store.create("Node", make_node().name("n1").obj())
        store.create("Pod", _pod())
        assert sched.run_until_idle().scheduled == 1
        assert store.get("Pod", "default", "p").spec.node_name == "n1"
        sched.close()
        ext.close()
    finally:
        srv.stop()


def test_managed_resources_gates_interest():
    calls = []

    def score_fn(pod, names):
        calls.append(pod["metadata"]["name"])
        return [n for n in names if n.endswith("1")], {n: 0 for n in names}

    srv = TPUScoreExtenderServer(score_fn)
    srv.start()
    try:
        ext = HTTPExtender(ExtenderConfig(url_prefix=srv.url, filter_verb="filter",
                                          node_cache_capable=True,
                                          managed_resources=["example.com/gpu"]))
        store = ObjectStore()
        sched = TorchScheduler(store, batch_size=4, device="cpu", extenders=[ext])
        for n in ("n0", "n1"):
            store.create("Node", make_node().name(n).capacity(
                {"cpu": "8", "memory": "8Gi", "pods": "10", "example.com/gpu": "4"}).obj())
        store.create("Pod", _pod("plain"))
        store.create("Pod", _pod("gpu", cpu="1", **{"example.com/gpu": "1"}))
        assert sched.run_until_idle().scheduled == 2
        assert calls == ["gpu"]
        assert store.get("Pod", "default", "gpu").spec.node_name == "n1"
        sched.close()
        ext.close()
    finally:
        srv.stop()


def _preempt_server(reply):
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            args = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            seen.append(args)
            body = json.dumps(reply(args)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, seen


@pytest.mark.parametrize("meta", [False, True])
def test_preemption_extender_callout(meta):
    """ProcessPreemption (extender.go:164-207): full pods under
    nodeNameToVictims (the extender keeps n1's candidates) or uids under
    nodeNameToMetaVictims for a nodeCacheCapable extender."""
    if meta:
        srv, seen = _preempt_server(
            lambda a: {"nodeNameToMetaVictims": a.get("nodeNameToMetaVictims") or {}})
    else:
        srv, seen = _preempt_server(lambda a: {"nodeNameToVictims": {
            k: v for k, v in (a.get("nodeNameToVictims") or {}).items() if k == "n1"}})
    try:
        ext = HTTPExtender(ExtenderConfig(url_prefix=f"http://127.0.0.1:{srv.server_address[1]}",
                                          preempt_verb="preempt", node_cache_capable=meta))
        store = ObjectStore()
        sched = TorchScheduler(store, batch_size=4, device="cpu", extenders=[ext])
        nodes = ("n0",) if meta else ("n0", "n1")
        cpu = "1" if meta else "2"
        for n in nodes:
            store.create("Node", make_node().name(n).capacity(
                {"cpu": cpu, "memory": "4Gi", "pods": "10"}).obj())
        lows = ("n0",) if meta else ("n0", "n0", "n1", "n1")
        for i, _n in enumerate(lows):
            store.create("Pod", make_pod().name(f"low{i}").uid(f"low{i}").namespace("default")
                         .req({"cpu": "1"}).priority(0).obj())
        sched.run_until_idle()
        store.create("Pod", make_pod().name("high").uid("high").namespace("default")
                     .req({"cpu": cpu}).priority(100).obj())
        sched.schedule_cycle()
        assert seen, "the extender's preempt verb was never called"
        forms = sorted(k for k in seen[0] if k.startswith("nodeNameTo"))
        assert forms == (["nodeNameToMetaVictims"] if meta else ["nodeNameToVictims"])
        high = store.get("Pod", "default", "high")
        # a preemption-capable extender in play: nominated, not fast-bound
        assert high.status.nominated_node_name == ("n0" if meta else "n1")
        assert not high.spec.node_name
        sched.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_ignorable_extender_outage_skipped_then_recovers():
    port = _free_port()
    clock = _Clock()
    ext = HTTPExtender(ExtenderConfig(
        url_prefix=f"http://127.0.0.1:{port}", filter_verb="filter", node_cache_capable=True,
        ignorable=True, http_timeout=0.5, failure_threshold=3, circuit_reset_seconds=5.0),
        clock=clock)
    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=4, device="cpu", extenders=[ext])
    store.create("Node", make_node().name("n0").obj())
    store.create("Node", make_node().name("n1").obj())
    for i in range(3):
        store.create("Pod", _pod(f"down{i}"))
    assert sched.run_until_idle().scheduled == 3
    assert ext.breaker.state == CIRCUIT_OPEN == ext.circuit_state
    store.create("Pod", _pod("skip"))
    assert sched.run_until_idle().scheduled == 1
    srv = TPUScoreExtenderServer(
        lambda pod, names: ([n for n in names if n.endswith("1")], {n: 0 for n in names}),
        port=port)
    srv.start()
    try:
        clock.advance(5.1)
        store.create("Pod", _pod("steered"))
        assert sched.run_until_idle().scheduled == 1
        assert ext.breaker.state == CIRCUIT_CLOSED == ext.circuit_state
        assert store.get("Pod", "default", "steered").spec.node_name == "n1"
    finally:
        srv.stop()
        sched.close()
        ext.close()


def test_async_walk_error_requeues_the_batch(monkeypatch):
    store = ObjectStore()
    sched = TorchScheduler(store, batch_size=8, device="cpu", pipeline=True, batch_wait=0,
                           extenders=[HTTPExtender(ExtenderConfig(url_prefix="http://x"))])
    assert sched.async_extenders
    for i in range(4):
        store.create("Node", make_node().name(f"n{i}").obj())
        store.create("Pod", _pod(f"p{i}"))

    def die(*a, **kw):
        raise RuntimeError("walk died")

    monkeypatch.setattr(sched, "_assign_with_extenders", die)
    s1 = sched.schedule_cycle()  # the dispatch starts the walk
    s2 = sched.schedule_cycle()  # the join surfaces its error: a requeue
    assert s1.attempted == 0 and s2.attempted == 4 and s2.scheduled == 0
    assert all(not p.spec.node_name for p in store.list("Pod")[0])
    a, b, u = sched.queue.pending_count()
    assert a + b + u == 4  # every pod retriable, none assumed
    assert not any(sched.cache.is_assumed(p) for p in store.list("Pod")[0])
    sched.close()


# --- the round walk against the reference -------------------------------------


def _score_fn(pod, names):
    """Rejects every node whose index is 3 mod 7 (and every node for a pod
    labelled reject); scores (index · 37) mod 11."""
    if (pod["metadata"].get("labels") or {}).get("reject"):
        return [], {n: 0 for n in names}
    return ([n for n in names if int(n[1:]) % 7 != 3],
            {n: (int(n[1:]) * 37) % 11 for n in names})


class _PrioritizeFails(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.send_response(500)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")


@pytest.fixture(scope="module")
def walk_servers():
    srv = TPUScoreExtenderServer(_score_fn)
    srv.start()
    bad = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _PrioritizeFails)
    threading.Thread(target=bad.serve_forever, daemon=True).start()
    yield srv.url, f"http://127.0.0.1:{bad.server_address[1]}"
    srv.stop()
    bad.shutdown()
    bad.server_close()


def _walk_cluster():
    nodes = [_plain_node(i, {ZONE: f"z{i % 3}"}) for i in range(120)]
    pods = [{"name": f"p{i:03d}", "ts": float(i), "req": {"cpu": "500m", "memory": "1Gi"}}
            for i in range(40)]
    blue = {"color": "blue"}
    pods += [{"name": f"sp{i:03d}", "ts": 100.0 + i, "req": {"cpu": "100m"}, "labels": blue,
              "spread": [(1, ZONE, "DoNotSchedule", blue, None)]} for i in range(12)]
    pods += [{"name": "rejected", "ts": 200.0, "req": {"cpu": "100m"},
              "labels": {"reject": "yes"}},
             {"name": "huge", "ts": 201.0, "req": {"cpu": "64"}}]
    return nodes, pods


def _walk(pkg, urls, async_, serialize):
    good, bad = urls
    cfg, ext_cls = (JCfg, JExt) if pkg == "jax" else (ExtenderConfig, HTTPExtender)
    exts = [ext_cls(cfg(url_prefix=good, filter_verb="filter", prioritize_verb="prioritize",
                        node_cache_capable=True)),
            ext_cls(cfg(url_prefix=bad, prioritize_verb="prioritize", weight=5,
                        node_cache_capable=True))]
    kw = dict(batch_size=32, clock=fake_clock(), batch_wait=0, extenders=exts,
              pipeline=async_, async_extenders=async_,
              serialize_extender_callouts=serialize)
    if pkg == "jax":
        store = JStore()
        sched = TPUScheduler(store, rng_key=None, **kw)
    else:
        store = ObjectStore()
        sched = TorchScheduler(store, device="cpu", **kw)
    nodes, pods = _walk_cluster()
    for d in nodes:
        store.create("Node", make_node_obj(pkg, d))
    for d in pods:
        store.create("Pod", make_pod_obj(pkg, d))
    rounds = []
    orig = type(sched)._assign_with_extenders

    def walk(self, *a, **k):
        out = orig(self, *a, **k)
        rounds.append(int(out[2]))
        return out

    type(sched)._assign_with_extenders = walk
    try:
        sched.run_until_idle(backoff_wait=0)
    finally:
        type(sched)._assign_with_extenders = orig
    sched.close()
    for e in exts:
        e.close()
    return {p.metadata.name: p.spec.node_name for p in store.list("Pod")[0]}, rounds, exts


@pytest.mark.parametrize("async_,serialize", [(False, "auto"), (False, "always"),
                                              (True, "auto"), (True, "always")])
def test_extender_walk_binds_as_reference(walk_servers, async_, serialize):
    jb, jrounds, _ = _walk("jax", walk_servers, async_, serialize)
    tb, trounds, texts = _walk("torch", walk_servers, async_, serialize)
    assert tb == jb, {k: (jb[k], tb[k]) for k in jb if jb[k] != tb.get(k)}
    assert trounds == jrounds and max(trounds) > 1  # the spread series takes rounds
    bound = {k: v for k, v in tb.items() if v}
    assert set(tb) - set(bound) == {"rejected", "huge"}
    assert all(int(v[1:]) % 7 != 3 for v in bound.values())  # approved nodes only
    assert texts[1].callouts.get("prioritize", 0) > 0  # its failures were ignored
    assert _num_feasible_nodes(120) == 100 < 120  # the window rotates here


# --- the round programs against the JAX functions -------------------------------


@pytest.fixture(scope="module", params=["plain", "spread_3zones", "affinity_planes"])
def prepared(request):
    p = FULL_PROBLEMS[request.param]()
    jauxes = p["fw"].prepare(p["batch"], p["dsnap"], p["dyn"], p["host_auxes"])
    tauxes = p["tfw"].prepare(p["tbatch"], p["tsnap"], p["tdyn"], p["thost"])
    return request.param, p, jauxes, tauxes


def test_compute_packed_equals_reference(prepared):
    _kind, p, jauxes, tauxes = prepared
    want = jax.jit(p["fw"].compute_packed)(p["batch"], p["dsnap"], p["dyn"], jauxes)
    got = p["tfw"].compute_packed(p["tbatch"], p["tsnap"], p["tdyn"], tauxes)
    _eq(want, got, "packed")
    assert np.isinf(got.numpy()).any() and np.isfinite(got.numpy()).any()


def test_compute_static_and_row_equal_reference(prepared):
    _kind, p, jauxes, tauxes = prepared
    fw, tfw = p["fw"], p["tfw"]
    jmask, jraw = jax.jit(fw.compute_static)(p["batch"], p["dsnap"], p["dyn"], jauxes)
    tmask, traw = tfw.compute_static(p["tbatch"], p["tsnap"], p["tdyn"], tauxes)
    _eq(jmask, tmask, "static_mask")
    assert len(jraw) == len(traw)
    for k, (a, b) in enumerate(zip(jraw, traw)):
        _eq(a, b, f"static_raw[{k}]")
    row = jax.jit(fw.compute_row, static_argnums=())
    valid = np.asarray(p["hbatch"].valid)
    for i in [0, 1, 5, int(np.nonzero(valid)[0][-1]), len(valid) - 1]:
        jm, js = row(p["batch"], p["dsnap"], p["dyn"], jauxes, jmask, jraw, i)
        tm, ts = tfw.compute_row(p["tbatch"], p["tsnap"], p["tdyn"], tauxes, tmask, traw, i)
        _eq(jm, tm, f"row_mask[{i}]")
        _eq(js, ts, f"row_scores[{i}]")


def test_apply_commits_equals_reference(prepared):
    _kind, p, jauxes, tauxes = prepared
    fw, tfw = p["fw"], p["tfw"]
    packed = np.asarray(jax.jit(fw.compute_packed)(p["batch"], p["dsnap"], p["dyn"], jauxes))
    b = packed.shape[0]
    rng = np.random.default_rng(5)
    commit = np.zeros(b, bool)
    choice = np.zeros(b, np.int32)
    used = set()
    for i in rng.permutation(b):
        feas = [n for n in np.nonzero(np.isfinite(packed[i]))[0] if n not in used]
        if feas and rng.random() < 0.6:
            commit[i], choice[i] = True, int(rng.choice(feas))
            used.add(int(choice[i]))
    assert commit.any()
    jdyn, jaux2 = jax.jit(fw.apply_commits)(p["batch"], p["dsnap"], p["dyn"], jauxes,
                                            jnp.asarray(commit), jnp.asarray(choice))
    req0 = p["tdyn"].requested.clone()
    tdyn, taux2 = tfw.apply_commits(p["tbatch"], p["tsnap"], p["tdyn"], tauxes,
                                    torch.from_numpy(commit), torch.from_numpy(choice))
    _eq(jdyn.requested, tdyn.requested, "requested")
    _eq(jdyn.non_zero, tdyn.non_zero, "non_zero")
    _eq(req0, p["tdyn"].requested, "input requested")
    # the next round's plane reads every updated aux
    want = jax.jit(fw.compute_packed)(p["batch"], p["dsnap"], jdyn, jaux2)
    got = tfw.compute_packed(p["tbatch"], p["tsnap"], tdyn, taux2)
    _eq(want, got, "packed after the commits")
    # the input auxes are untouched: the plane before the commits again
    _eq(packed, tfw.compute_packed(p["tbatch"], p["tsnap"], p["tdyn"], tauxes), "packed")


def test_uniform_score_fn_and_the_subprocess_server_stay_stdlib():
    assert uniform_score_fn({}, ["a", "b"]) == (["a", "b"], {"a": 1, "b": 1})
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", "import sys, kubernetes_tpu_torch.extender; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'numpy', 'jax', 'kubernetes_tpu')))"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
