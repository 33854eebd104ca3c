"""Scheduler extenders: the HTTP/JSON client and the extender score server.

Reference: the JAX package's extender.py (``ExtenderConfig`` :33,
``CircuitBreaker`` :73, the HTTP/1.1 keep-alive client ``HTTPExtender``
:211 with ``is_interested`` :270, ``process_preemption`` :283, ``filter``
:492, ``prioritize`` :536, ``bind`` :566; the headers / body / chunked
readers :135-193; ``TPUScoreExtenderServer`` :654,
``run_subprocess_score_server`` :784, ``uniform_score_fn`` :799), itself
after pkg/scheduler/extender.go (HTTPExtender.Filter :277, .Prioritize
:347, .Bind :389, .send :416; config in apis/config/types.go:246-286).

Two halves:
  - ``HTTPExtender``: the client the scheduler calls out-of-process
    extenders with at Filter / Prioritize / Bind / ProcessPreemption; the
    scheduler merges the weighted extender scores into the device totals
    (scheduler.go:1146-1185).
  - ``TPUScoreExtenderServer``: a server that exposes a score function over
    the same protocol (the benchmarks' extender, run in a subprocess).

The reference publishes each extender's circuit state and its callouts to
its metrics registry; the port keeps them as attributes of the client
(``circuit_state`` and ``callouts``), as the port's scheduler counts.  The
module imports the standard library only (no torch): a ``spawn`` child that
runs the score server imports nothing else.
"""

from __future__ import annotations

import json
import select
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
from typing import TYPE_CHECKING
from urllib.parse import urlparse

if TYPE_CHECKING:  # annotations only: the module imports the stdlib alone
    from .api import objects as v1


def _memo_encode(obj, attr: str, key, build):
    """Per-object encode memo (the reference's api/wire.py memo_encode,
    :608): ``build()``'s value cached on ``obj`` under ``attr``, keyed by
    ``key`` (conventionally ``(resourceVersion, ...)`` — the store bumps
    resourceVersion on every update, so a store-mediated mutation
    invalidates).  An object that cannot carry attributes is served
    uncached."""
    cached = getattr(obj, attr, None)
    if cached is not None and cached[0] == key:
        return cached[1]
    value = build()
    try:
        setattr(obj, attr, (key, value))
    except (AttributeError, TypeError):
        pass  # an uncacheable stand-in: correctness over memoization
    return value


@dataclass
class ExtenderConfig:
    """apis/config/types.go:246-286 subset."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    http_timeout: float = 5.0
    # Resource names this extender manages (extender.go:444-471): when
    # non-empty, the extender is only consulted for pods that request or
    # limit at least one of them (IsInterested / hasManagedResources).
    managed_resources: List[str] = field(default_factory=list)
    # Circuit breaker (degradation policy, not in the reference config —
    # the reference relies on ignorable alone, which still pays the full
    # http_timeout on EVERY callout during an outage): after
    # ``failure_threshold`` consecutive transport failures the circuit
    # opens and callouts are skipped outright; after
    # ``circuit_reset_seconds`` one half-open probe is let through —
    # success closes the circuit, failure re-opens it.
    failure_threshold: int = 3
    circuit_reset_seconds: float = 30.0


class ExtenderError(Exception):
    pass


# circuit states — also the extender_circuit_state gauge values
CIRCUIT_CLOSED = 0
CIRCUIT_OPEN = 1
CIRCUIT_HALF_OPEN = 2


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a timed half-open probe.

    Thread-safe: the scheduler fans extender callouts across a 16-worker
    pool, and N workers hitting a dead extender must resolve to ONE open
    circuit (and later exactly one half-open probe), not N racing states.
    """

    def __init__(self, failure_threshold: int = 3,
                 reset_seconds: float = 30.0, clock=time.monotonic):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_seconds = reset_seconds
        self.clock = clock
        self._state = CIRCUIT_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._lock = threading.Lock()

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call go out now?  OPEN past the reset window transitions
        to HALF_OPEN and admits exactly one probe; further calls are
        refused until that probe resolves via success()/failure()."""
        with self._lock:
            if self._state == CIRCUIT_CLOSED:
                return True
            if self._state == CIRCUIT_OPEN and \
                    self.clock() - self._opened_at >= self.reset_seconds:
                self._state = CIRCUIT_HALF_OPEN
                return True
            return False

    def success(self) -> None:
        with self._lock:
            self._state = CIRCUIT_CLOSED
            self._failures = 0

    def failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state == CIRCUIT_HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._state = CIRCUIT_OPEN
                self._opened_at = self.clock()


# --- minimal HTTP/1.1 fast path ---------------------------------------------
#
# The standard library's HTTP stack re-parses every message's headers through
# email.parser, and the extender protocol is two callouts of two messages per
# pod, so both endpoints are hand-rolled.  The wire format stays exactly
# HTTP/1.1 + JSON (a real kube-scheduler or any external extender
# interoperates).  A reply the client cannot parse (an unknown framing)
# surfaces as ExtenderError, and the ignorable policy then applies, as for
# any malformed extender reply.


def _read_headers(rfile) -> Optional[Dict[bytes, bytes]]:
    """Read header lines until the blank line; lowercase-keyed dict.
    None on EOF before any header (peer closed a keep-alive socket)."""
    headers: Dict[bytes, bytes] = {}
    while True:
        line = rfile.readline(65536)
        if not line:
            return None
        if line in (b"\r\n", b"\n"):
            return headers
        k, _, v = line.partition(b":")
        headers[k.strip().lower()] = v.strip()


def _read_body(rfile, headers: Dict[bytes, bytes]) -> Optional[bytes]:
    """Content-Length- or chunked-framed body; None when the framing is
    neither — the client surfaces that as ExtenderError (ignorable policy
    applies) and the server drops the connection.

    Chunked matters for interop: a Go extender writing large JSON replies
    through json.NewEncoder(w) emits Transfer-Encoding: chunked (net/http
    buffers only small handler writes)."""
    te = headers.get(b"transfer-encoding")
    if te is not None:
        if te.strip().lower() != b"chunked":
            return None
        return _read_chunked(rfile)
    cl = headers.get(b"content-length")
    if cl is None:
        return None
    n = int(cl)
    chunks = []
    while n > 0:
        chunk = rfile.read(n)
        if not chunk:
            raise ConnectionResetError("peer closed mid-body")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _read_chunked(rfile) -> Optional[bytes]:
    """RFC 7230 §4.1 chunked decoding: size line (hex, extensions after
    ';' ignored) → chunk data → CRLF, until the 0-size chunk, then trailer
    lines until the blank line.  None on a malformed size line (stream
    desynced — caller treats as unsupported framing and drops the
    connection); ConnectionResetError when the peer closes mid-body."""
    chunks = []
    while True:
        size_line = rfile.readline(65536)
        if not size_line:
            raise ConnectionResetError("peer closed mid-chunk-size")
        try:
            n = int(size_line.split(b";", 1)[0].strip(), 16)
        except ValueError:
            return None
        if n == 0:
            while True:  # trailer section
                t = rfile.readline(65536)
                if not t:
                    raise ConnectionResetError("peer closed in trailers")
                if t in (b"\r\n", b"\n"):
                    return b"".join(chunks)
        remaining = n
        while remaining > 0:
            chunk = rfile.read(remaining)
            if not chunk:
                raise ConnectionResetError("peer closed mid-chunk")
            chunks.append(chunk)
            remaining -= len(chunk)
        crlf = rfile.readline(65536)  # the chunk-terminating CRLF
        if crlf not in (b"\r\n", b"\n"):
            return None


def _conn_stale(sock) -> bool:
    """True when an idle pooled HTTP connection is unusable: a readable
    idle socket means the peer closed it (EOF queued) or desynced the
    stream (unsolicited bytes) — either way a request on it is wasted."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True  # closed/invalid fd
    return bool(readable)


class HTTPExtender:
    def __init__(self, cfg: ExtenderConfig, clock=time.monotonic):
        self.cfg = cfg
        # pool of idle keep-alive connections, shared across the scheduler's
        # callout threads
        self._pool: List[tuple] = []  # (socket, buffered reader)
        self._pool_lock = threading.Lock()
        # per-extender circuit breaker (see ExtenderConfig): transport
        # failures trip it; an open circuit skips callouts so an ignorable
        # extender's outage stops costing http_timeout per pod, and a
        # non-ignorable one fails fast into the unschedulable/backoff path
        self.breaker = CircuitBreaker(cfg.failure_threshold,
                                      cfg.circuit_reset_seconds, clock=clock)
        # the reference's extender_circuit_state gauge, as an attribute
        self.circuit_state = CIRCUIT_CLOSED
        # callouts sent, by verb (each HTTP exchange, resends included)
        self.callouts: Dict[str, int] = {}
        self._publish_circuit()

    def _publish_circuit(self) -> None:
        self.circuit_state = self.breaker.state

    def _circuit_allow(self) -> bool:
        ok = self.breaker.allow()
        self._publish_circuit()
        return ok

    def _circuit_result(self, ok: bool) -> None:
        (self.breaker.success if ok else self.breaker.failure)()
        self._publish_circuit()

    def close(self) -> None:
        with self._pool_lock:
            conns, self._pool = self._pool, []
        for sock, rfile in conns:
            rfile.close()
            sock.close()

    @property
    def is_ignorable(self) -> bool:
        return self.cfg.ignorable

    @property
    def supports_preemption(self) -> bool:
        """ProcessPreemption is only attempted when preemptVerb is set
        (extender.go SupportsPreemption)."""
        return bool(self.cfg.preempt_verb)

    def is_interested(self, pod: v1.Pod) -> bool:
        """IsInterested (extender.go:444-471): no managed resources → all
        pods; otherwise any container (incl. init) requesting/limiting one."""
        if not self.cfg.managed_resources:
            return True
        managed = set(self.cfg.managed_resources)
        for c in list(pod.spec.containers) + list(pod.spec.init_containers):
            res = c.resources
            for table in (res.requests, res.limits):
                if table and managed & set(table):
                    return True
        return False

    def process_preemption(
        self, pod: v1.Pod, node_name_to_victims: Dict[str, dict]
    ) -> Dict[str, dict]:
        """ProcessPreemption (extender.go:164-207): ships the candidate
        victim map, receives the subset of nodes the extender accepts
        (possibly with different victims).

        Form follows nodeCacheCapable exactly as the reference client does
        (extender.go convertToNodeNameToMetaVictims): capable extenders get
        metaVictims (uids only), others get full pod objects under
        nodeNameToVictims; both reply forms are parsed.  An error from an
        ignorable extender keeps the original candidates.

        Each ``node_name_to_victims`` entry: {"pods": [v1.Pod],
        "numPDBViolations": int}."""
        if not self.supports_preemption:
            return node_name_to_victims
        if not self._circuit_allow():
            # checked BEFORE building the victims payload: an open circuit
            # must not pay the per-victim pod serialization it would discard
            if self.cfg.ignorable:
                return node_name_to_victims
            raise ExtenderError(
                f"extender {self.cfg.url_prefix}: circuit open")
        if self.cfg.node_cache_capable:
            victims_key = "nodeNameToMetaVictims"
            victims = {
                node: {
                    "pods": [{"uid": p.uid} for p in entry["pods"]],
                    "numPDBViolations": entry["numPDBViolations"],
                }
                for node, entry in node_name_to_victims.items()
            }
        else:
            victims_key = "nodeNameToVictims"
            victims = {
                node: {
                    "pods": [_pod_to_dict(p) for p in entry["pods"]],
                    "numPDBViolations": entry["numPDBViolations"],
                }
                for node, entry in node_name_to_victims.items()
            }
        args = {"pod": _pod_to_dict(pod), victims_key: victims}
        try:
            result = self._send(self.cfg.preempt_verb, args)
        except Exception as e:
            self._circuit_result(False)
            if self.cfg.ignorable:
                return node_name_to_victims
            raise ExtenderError(str(e)) from e
        self._circuit_result(True)
        reply = result.get("nodeNameToMetaVictims") or result.get("nodeNameToVictims") or {}
        out = {}
        for node, meta in reply.items():
            if node not in node_name_to_victims:
                continue
            uids = set()
            for pd in (meta or {}).get("pods", []):
                uid = pd.get("uid") or ((pd.get("metadata") or {}).get("uid"))
                if uid:
                    uids.add(uid)
            by_uid = {p.uid: p for p in node_name_to_victims[node]["pods"]}
            out[node] = {
                "pods": [by_uid[u] for u in uids if u in by_uid],
                "numPDBViolations": (meta or {}).get("numPDBViolations", 0),
            }
        return out

    def _fresh_conn(self):
        """(socket, buffered reader) with TCP_NODELAY: the request goes out
        in one sendall, and Nagle would hold small segments for the peer's
        delayed ACK."""
        u = urlparse(self.cfg.url_prefix)
        sock = socket.create_connection(
            (u.hostname, u.port or (443 if u.scheme == "https" else 80)),
            timeout=self.cfg.http_timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if u.scheme == "https":
            import ssl

            sock = ssl.create_default_context().wrap_socket(
                sock, server_hostname=u.hostname)
        return (sock, sock.makefile("rb"))

    def _send(self, verb: str, payload,
              idempotent: bool = False) -> dict:
        """POST over a POOLED persistent connection — hand-rolled HTTP/1.1
        (see the fast-path note above; the stdlib stack's per-message
        parsing was ~1.9ms of GIL per callout).  Keep-alive with one safe
        resend when a pooled socket was idled out by the server; timeouts
        and mid-request errors are NOT retried (the extender may have
        acted).  The reference's client shares one keep-alive http.Client
        (extender.go NewHTTPExtender -> utilnet.SetTransportDefaults) --
        same discipline, leaner stack.

        ``idempotent`` marks pure-query verbs (filter/prioritize): those may
        be resent even after a PARTIAL response (server reset mid-reply) —
        one transient reset otherwise turns the pod unschedulable for a
        backoff window; side-effecting verbs (bind,
        preempt) never resend once any byte arrived (double-bind hazard)."""
        u = urlparse(self.cfg.url_prefix)
        path = f"{u.path.rstrip('/')}/{verb}"
        with self._pool_lock:
            self.callouts[verb] = self.callouts.get(verb, 0) + 1
        # pre-encoded bodies (bytes) skip json.dumps: the round walk builds
        # callout bodies from cached pod / name-list fragments
        body = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        # resolved port, matching _fresh_conn: u.port is None for a URL
        # without an explicit port, and "Host: example.com:None" breaks
        # strict servers / vhost routing
        port = u.port or (443 if u.scheme == "https" else 80)
        head = (
            f"POST {path} HTTP/1.1\r\nHost: {u.hostname}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: keep-alive\r\n\r\n"
        ).encode()
        with self._pool_lock:
            conn = self._pool.pop() if self._pool else None
        if conn is not None and _conn_stale(conn[0]):
            # the server idled this keep-alive socket out (EOF already
            # queued) or left stray bytes: a zero-timeout readability probe
            # detects it for free, saving the wasted send + the one safe
            # resend the reset path would burn
            conn[1].close()
            conn[0].close()
            conn = None
        fresh = conn is None
        if fresh:
            conn = self._fresh_conn()
        for attempt in (0, 1):
            sock, rfile = conn
            got_bytes = False  # any response byte => handler may have acted
            try:
                sock.sendall(head + body)
                status_line = rfile.readline(65536)
                if not status_line:
                    # ZERO response bytes on a pooled socket the server
                    # idled out: the request never reached a handler, so
                    # ONE resend is safe even for side-effecting verbs.
                    # Any later truncation (reset in headers/body) is NOT
                    # retried — the handler may already have acted (the
                    # double-bind hazard).
                    raise ConnectionResetError("peer closed keep-alive socket")
                got_bytes = True
                parts = status_line.split(None, 2)
                status = int(parts[1])
                headers = _read_headers(rfile)
                if headers is None:
                    raise ExtenderError(
                        f"extender {verb}: peer closed mid-headers")
                data = _read_body(rfile, headers)
                if data is None:
                    # exotic framing (chunked ...): only Content-Length
                    # replies fast-parse; socket state is now unknown
                    raise ExtenderError(
                        f"extender {verb}: unsupported response framing")
                if not 200 <= status < 300:
                    raise ExtenderError(
                        f"extender {verb}: HTTP {status} {data[:200]!r}")
                keep = headers.get(b"connection", b"keep-alive").lower() != b"close"
                if keep:
                    with self._pool_lock:
                        if len(self._pool) < 16:
                            self._pool.append(conn)
                            conn = None
                if conn is not None:
                    rfile.close()
                    sock.close()
                return json.loads(data)
            except (ConnectionResetError, BrokenPipeError) as e:
                rfile.close()
                sock.close()
                if attempt or (got_bytes and not idempotent) \
                        or (fresh and not idempotent):
                    raise ExtenderError(str(e)) from e
                conn = self._fresh_conn()
            except (ValueError, json.JSONDecodeError) as e:
                # malformed status line / Content-Length / JSON — the
                # stream is desynced; close, never resend
                rfile.close()
                sock.close()
                raise ExtenderError(
                    f"extender {verb}: malformed response ({e})") from e
            except (OSError, ExtenderError):
                rfile.close()
                sock.close()
                raise

    def _args_body(self, pod: v1.Pod, node_names: List[str],
                   names_json: Optional[bytes],
                   node_manifests=None) -> bytes:
        """ExtenderArgs wire bytes, assembled from cached fragments.

        nodeCacheCapable extenders get the NAME-LIST form (``nodenames``,
        extender.go:277 convertToNodeNames) — the fast path; non-capable extenders get full node manifests under
        ``nodes.items`` exactly as the reference client does
        (extender.go:416 ``send`` with ExtenderArgs.Nodes), built through
        the caller-provided ``node_manifests(names) -> bytes`` hook (the
        scheduler caches the encoded manifest list per feasible-set)."""
        pod_json = _pod_to_json(pod)
        if self.cfg.node_cache_capable or node_manifests is None:
            names = names_json if names_json is not None \
                else json.dumps(node_names).encode()
            return b'{"pod":' + pod_json + b',"nodenames":' + names + b"}"
        return (b'{"pod":' + pod_json + b',"nodes":{"items":'
                + node_manifests(node_names) + b"}}")

    def filter(
        self, pod: v1.Pod, node_names: List[str],
        names_json: Optional[bytes] = None, node_manifests=None,
    ) -> Tuple[List[str], Dict[str, str]]:
        """→ (feasible node names, failed node → reason). ExtenderArgs uses
        nodenames when nodeCacheCapable, full manifests otherwise
        (extender.go:277-345); ``names_json``/``node_manifests`` are
        optional pre-encoded fragments (see _args_body)."""
        if not self.cfg.filter_verb:
            return node_names, {}
        if not self._circuit_allow():
            # open circuit: an ignorable extender is SKIPPED (all nodes
            # pass, the cycle proceeds without it — graceful degradation);
            # a non-ignorable one fails fast, sparing the timeout, and the
            # scheduler's callout handler turns that into
            # unschedulable+backoff, never a crashed cycle
            if self.cfg.ignorable:
                return node_names, {}
            raise ExtenderError(
                f"extender {self.cfg.url_prefix}: circuit open")
        body = self._args_body(pod, node_names, names_json, node_manifests)
        try:
            result = self._send(self.cfg.filter_verb, body, idempotent=True)
        except Exception as e:
            self._circuit_result(False)
            if self.cfg.ignorable:
                return node_names, {}
            raise ExtenderError(str(e)) from e
        self._circuit_result(True)
        if result.get("error"):
            # protocol-level error from a HEALTHY extender (it answered):
            # not a transport failure — the circuit stays closed
            raise ExtenderError(result["error"])
        if result.get("nodenames") is not None:
            names = list(result.get("nodenames") or [])
        else:
            # non-capable reply form: full node objects (FilterResult.Nodes)
            names = [
                ((item.get("metadata") or {}).get("name"))
                for item in ((result.get("nodes") or {}).get("items") or [])
            ]
            names = [n for n in names if n]
        return names, dict(result.get("failedNodes") or {})

    def prioritize(
        self, pod: v1.Pod, node_names: List[str],
        names_json: Optional[bytes] = None, node_manifests=None,
    ) -> Dict[str, float]:
        """→ node → weighted score contribution (HostPriorityList × weight,
        scheduler.go:1146-1185).  The reference's ``send`` builds ONE
        ExtenderArgs form per extender for BOTH verbs, so a
        non-nodeCacheCapable extender receives full manifests here too."""
        if not self.cfg.prioritize_verb:
            return {}
        if not self._circuit_allow():
            if self.cfg.ignorable:
                return {}
            raise ExtenderError(
                f"extender {self.cfg.url_prefix}: circuit open")
        body = self._args_body(pod, node_names, names_json, node_manifests)
        try:
            result = self._send(self.cfg.prioritize_verb, body,
                                idempotent=True)
        except Exception as e:
            self._circuit_result(False)
            if self.cfg.ignorable:
                return {}
            raise ExtenderError(str(e)) from e
        self._circuit_result(True)
        return {
            hp["host"]: hp["score"] * self.cfg.weight
            for hp in result or []
        }

    def bind(self, pod: v1.Pod, node_name: str) -> bool:
        if not self.cfg.bind_verb:
            return False
        if not self._circuit_allow():
            raise ExtenderError(
                f"extender {self.cfg.url_prefix}: circuit open")
        try:
            result = self._send(self.cfg.bind_verb, {
                "podNamespace": pod.namespace, "podName": pod.metadata.name,
                "podUID": pod.uid, "node": node_name,
            })
        except Exception:
            self._circuit_result(False)
            raise
        self._circuit_result(True)
        if result.get("error"):
            raise ExtenderError(result["error"])
        return True


def _pod_to_dict(pod: v1.Pod) -> dict:
    """Serialized form memoized per pod object (``_memo_encode``): one
    scheduling round calls filter AND prioritize for
    the same pod (2 serializations), and a pod deferred across rounds
    repeats both.  The key is (resourceVersion, nodeName): the sim store
    bumps resourceVersion on every update, so in-place mutations that went
    through the store invalidate; nodeName covers the bind subresource
    path."""
    key = (pod.metadata.resource_version, pod.spec.node_name)
    return _memo_encode(pod, "_extender_dict", key,
                            lambda: _pod_to_dict_uncached(pod))


def _node_to_dict(node) -> dict:
    """Minimal node manifest for the non-nodeCacheCapable ExtenderArgs
    form (extender.go:416 ships the full node list when the extender
    can't resolve names against its own cache)."""
    return {
        "metadata": {
            "name": node.metadata.name,
            "labels": dict(node.metadata.labels),
        },
        "status": {
            "allocatable": dict(node.status.allocatable or {}),
            "capacity": dict(node.status.capacity or {}),
        },
    }


def _pod_to_json(pod: v1.Pod) -> bytes:
    """json.dumps(_pod_to_dict(pod)) memoized per (resourceVersion,
    nodeName) — one round calls filter AND
    prioritize for the same pod, and a pod deferred across rounds repeats
    both."""
    key = (pod.metadata.resource_version, pod.spec.node_name)
    return _memo_encode(pod, "_extender_json", key,
                            lambda: json.dumps(_pod_to_dict(pod)).encode())


def _pod_to_dict_uncached(pod: v1.Pod) -> dict:
    return {
        "metadata": {
            "name": pod.metadata.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "labels": dict(pod.metadata.labels),
        },
        "spec": {
            "schedulerName": pod.spec.scheduler_name,
            "priority": pod.spec.priority,
            "nodeName": pod.spec.node_name,
            "containers": [
                {"name": c.name, "image": c.image,
                 "resources": {"requests": dict(c.resources.requests or {})}}
                for c in pod.spec.containers
            ],
            "nodeSelector": dict(pod.spec.node_selector),
            "tolerations": [
                {"key": t.key, "operator": t.operator, "value": t.value,
                 "effect": t.effect}
                for t in pod.spec.tolerations
            ],
        },
    }


class TPUScoreExtenderServer:
    """Serves a score function over the extender protocol.

    Endpoints: POST /filter and /prioritize with ExtenderArgs
    (nodeCacheCapable: node names only).  Backed by a callable
    ``score_fn(pod_dict, node_names) -> (feasible names, {name: score})``.
    """

    def __init__(self, score_fn, host: str = "127.0.0.1", port: int = 0):
        import socketserver

        self.score_fn = score_fn
        self._thread: Optional[threading.Thread] = None
        # name → its JSON encoding (quoted/escaped), cached across requests:
        # the same few hundred node names ride every callout, and re-encoding
        # them per response is avoidable work
        self._name_json: Dict[str, str] = {}
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            # hand-rolled HTTP/1.1 persistent-connection loop (see the
            # fast-path note above); the whole reply goes out in one
            # sendall, which also sidesteps the Nagle / delayed-ACK stall
            disable_nagle_algorithm = True

            def handle(self):
                while True:
                    req_line = self.rfile.readline(65536)
                    if not req_line or not req_line.strip():
                        return  # client closed the keep-alive socket
                    parts = req_line.split(None, 2)
                    if len(parts) < 2:
                        return
                    path = parts[1].decode("latin-1")
                    headers = _read_headers(self.rfile)
                    if headers is None:
                        return
                    data = _read_body(self.rfile, headers)
                    if data is None:
                        return  # unsupported framing: drop the connection
                    try:
                        body = outer._dispatch(path, data)
                        status = b"200 OK"
                    # the error goes to the client as an HTTP 500 with the
                    # message in the JSON body, and the connection closes
                    except Exception as e:  # handler bug → 500 + close
                        body = json.dumps({"error": str(e)}).encode()
                        status = b"500 Internal Server Error"
                    self.wfile.write(
                        b"HTTP/1.1 " + status
                        + b"\r\nContent-Type: application/json\r\n"
                        + b"Content-Length: " + str(len(body)).encode()
                        + b"\r\nConnection: keep-alive\r\n\r\n" + body
                    )
                    if status[:3] != b"200":
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _dispatch(self, path: str, data: bytes) -> bytes:
        args = json.loads(data or b"{}")
        pod = args.get("pod") or {}
        names = list(args.get("nodenames") or [])
        if not names:
            # non-nodeCacheCapable callers ship full manifests
            # (ExtenderArgs.Nodes) — serve them off the metadata names
            names = [
                ((item.get("metadata") or {}).get("name"))
                for item in ((args.get("nodes") or {}).get("items") or [])
            ]
            names = [n for n in names if n]
        try:
            feasible, scores = self.score_fn(pod, names)
        # the protocol's error field (FilterResult.Error): the scheduler
        # side decides whether that is ignorable
        except Exception as e:  # extender protocol error field
            return json.dumps({"error": str(e)}).encode()
        jname = self._name_json
        if len(jname) > 65536:
            # bound the per-name memo: a server outliving heavy node churn
            # (autoscaling creates uniquely-named nodes forever) must not
            # leak an entry per retired name
            jname.clear()

        def enc(n: str) -> str:
            v = jname.get(n)
            if v is None:
                v = jname[n] = json.dumps(n)
            return v

        if path.rstrip("/").endswith("filter"):
            feas = set(feasible)  # a list membership scan was O(N²)/request
            failed = {n: "TPUScore: infeasible" for n in names
                      if n not in feas}
            return ('{"nodenames":[' + ",".join(enc(n) for n in feasible)
                    + '],"failedNodes":' + json.dumps(failed)
                    + "}").encode()
        return ("[" + ",".join(
            '{"host":%s,"score":%d}' % (enc(n), int(scores.get(n, 0)))
            for n in names
        ) + "]").encode()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            # shutdown() returns once serve_forever exits its loop; the
            # bounded join keeps a request already in a handler from
            # leaking the serving thread past stop()
            thread.join(timeout=2.0)


def run_subprocess_score_server(score_fn, port_pipe):
    """Subprocess entry for benchmarks and integration: serve ``score_fn``
    over the extender protocol and report the bound port.  It lives here
    (standard-library imports only) so that a spawn-context child imports
    neither torch nor the perf modules."""
    srv = TPUScoreExtenderServer(score_fn)
    srv.start()
    port_pipe.send(srv.port)
    port_pipe.close()
    import time as _t

    while True:  # until the parent terminates us
        _t.sleep(3600)


def uniform_score_fn(pod_dict, names):
    """Trivial extender body (module-level so subprocess targets can import
    it by name): every node feasible, uniform score."""
    return names, {name: 1 for name in names}
