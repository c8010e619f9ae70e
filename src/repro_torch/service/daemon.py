"""Long-lived simulation daemon: the service shape of the service
(DESIGN.md §12).

One process owns the expensive shared state — the ``ResultStore`` root,
the CUDA context and the loaded ``ws_sim`` kernel library, one
:class:`QueryBroker` and its :class:`EventHistory` — and any number of
short-lived clients speak the length-prefixed JSON RPC of
:mod:`repro_torch.service.wire` over a unix socket:

``ping``
    liveness probe (also returns the protocol version).
``submit``
    enqueue one query (solo or paired) on this connection; admission
    controlled — over ``max_pending`` queries daemon-wide it soft-rejects
    with ``status="busy"`` and a ``retry_after_s`` hint (HTTP-429 style;
    ``DaemonClient`` honours it with jittered retries, then falls back to
    library mode).
``flush``
    answer everything this connection submitted. Flushes from *different
    clients* that arrive within ``coalesce_window_s`` of each other land
    in the same broker round, so N processes asking the same question
    cost ONE backend dispatch — and different questions still share
    pow2-padded bucket dispatches. Rounds drain clients round-robin, one
    query at a time, capped at ``max_round_queries``: a client with 1000
    queries cannot starve a client with one.
``query_pair`` / ``sweep_chunk`` / ``stats`` / ``shutdown``
    paired A/B round trip, one store-backed sweep chunk, the metrics
    snapshot as the fleet-dashboard payload, graceful stop.

Artifacts are byte-identical to library mode: the daemon answers through
the very same ``SimulationService`` code path (same ``SimQuery.key()``,
same canonical model, same npz writer), so a store filled through the
daemon is indistinguishable from one filled in-process — which is also
what makes the client's library-mode *fallback* safe to mix freely with
daemon calls.

Straggler EMA state survives restarts: on shutdown the broker's
``EventHistory`` is persisted to ``<store root>/history.json`` (atomic
tmp + replace) and reloaded on start, so the first dispatch after a
restart already sorts by learned event counts.

The protocol, the store keys and the npz bytes are the JAX package's
(``PROTOCOL_VERSION`` 1), so a JAX client is answered by this daemon and a
store or history sidecar filled by either package serves the other. The
daemon runs on the card unless it is built with ``device="cpu"``
(``--device cpu`` on the command line); without a CUDA device and without
that argument it raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import socket
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.core.sweep import (canonical_grid, grid_rows, lam_pair,
                                    resolve_model, run_rows)
from repro_torch.service import store as store_mod
from repro_torch.service import wire
from repro_torch.service.api import SimulationService
from repro_torch.service.broker import (EventHistory, PairedQuery,
                                        PairedResult)
from repro_torch.service.wire import WireError

#: Bumped on any incompatible RPC change; ping/hello carries it so a
#: mismatched client can refuse early instead of misparsing frames.
PROTOCOL_VERSION = 1

#: Name of the EventHistory sidecar inside the store root.
HISTORY_SIDECAR = "history.json"

#: The ``retry_after_s`` hint of a busy soft-reject.
RETRY_AFTER_S = 0.05

#: The listener's accept timeout: the accept loop re-reads ``_running`` at
#: least this often, so a stop ends it on kernels where neither
#: ``shutdown()`` nor ``close()`` of the listener wakes a blocked
#: ``accept()``.
ACCEPT_POLL_S = 0.25


def default_socket_path(root: Optional[os.PathLike] = None) -> Path:
    """Rendezvous path: clients that share a store root share a daemon."""
    base = Path(root) if root is not None else store_mod.DEFAULT_ROOT
    return base / wire.SOCKET_NAME


class _Client:
    """Per-connection state: queries submitted but not yet flushed."""

    _next_id = 0
    _id_lock = threading.Lock()

    def __init__(self):
        with _Client._id_lock:
            _Client._next_id += 1
            self.id = _Client._next_id
        self.pending: List[object] = []   # SimQuery | PairedQuery


class _FlushReq:
    """One client's flush: fulfilled across one or more dispatcher rounds
    (round-robin fairness may split a large flush)."""

    def __init__(self, client_id: int, queries: List[object]):
        self.client_id = client_id
        self.queries = queries
        self.taken = 0                    # queries handed to rounds so far
        self.results: Dict[int, object] = {}
        self.error: Optional[BaseException] = None
        self.done = threading.Event()

    def fulfil(self, idx: int, result: object) -> None:
        self.results[idx] = result
        if len(self.results) == len(self.queries):
            self.done.set()

    def fail(self, err: BaseException) -> None:
        self.error = err
        self.done.set()


class SimulationDaemon:
    """The daemon: a ``SimulationService`` plus a unix-socket RPC front.

    ``max_pending`` bounds admitted-but-unanswered queries daemon-wide
    (admission control); ``coalesce_window_s`` is how long a round waits
    for more clients after the first flush arrives (the cross-client
    coalescing window); ``max_round_queries`` caps one round's size and is
    the fairness quantum — rounds drain flushing clients round-robin one
    query at a time up to this cap. Remaining keywords go to
    :class:`SimulationService` verbatim, ``device`` among them: every
    round and every sweep chunk runs there (None is the card).
    """

    def __init__(self, socket_path: Optional[os.PathLike] = None,
                 root: Optional[os.PathLike] = None,
                 max_pending: int = 256,
                 coalesce_window_s: float = 0.02,
                 max_round_queries: int = 256,
                 **service_kw):
        self.service = SimulationService(root=root, **service_kw)
        self.store = self.service.store
        self.socket_path = Path(socket_path) if socket_path is not None \
            else default_socket_path(self.store.root)
        self.max_pending = int(max_pending)
        self.coalesce_window_s = float(coalesce_window_s)
        self.max_round_queries = int(max_round_queries)
        self.metrics = self.service.metrics

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._flushq: List[_FlushReq] = []
        self._pending = 0                 # admitted, unanswered queries
        self._running = False
        self._stopping = False
        self._stopped = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._accept_thread: Optional[threading.Thread] = None
        # Serializes every simulation execution (broker rounds and
        # sweep_chunk): the broker is single-owner by design.
        self._exec_lock = threading.Lock()
        self.n_clients = 0
        self.n_rounds = 0
        self.n_busy_rejections = 0
        self.n_rpcs = 0
        self.load_history()

    # -- EventHistory persistence (straggler sorting survives restarts) ----

    @property
    def history_path(self) -> Path:
        return self.store.root / HISTORY_SIDECAR

    def load_history(self) -> int:
        """Merge the persisted EMA sidecar (if any) into the broker's
        history; returns the number of cells loaded. Corrupt or
        foreign-version sidecars load as empty, never raise."""
        path = self.history_path
        try:
            doc = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return 0
        hist = EventHistory.from_json(doc)
        self.service.broker.history.merge(hist)
        self.metrics.gauge("daemon.history_loaded").set(len(hist))
        return len(hist)

    def save_history(self) -> Path:
        """Atomically persist the broker's EMA state to the sidecar."""
        self.store.root.mkdir(parents=True, exist_ok=True)
        blob = json.dumps(self.service.broker.history.to_json(),
                          sort_keys=True, separators=(",", ":")).encode()
        self.store._write_atomic(self.history_path, lambda f: f.write(blob))
        return self.history_path

    # -- lifecycle ----------------------------------------------------------

    def bind(self) -> None:
        """Create + bind + listen on the unix socket (stale path unlinked:
        the daemon owns its rendezvous)."""
        self.store.root.mkdir(parents=True, exist_ok=True)
        with contextlib.suppress(OSError):
            os.unlink(self.socket_path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(str(self.socket_path))
            sock.listen(64)
            sock.settimeout(ACCEPT_POLL_S)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._running = True
        self._stopping = False
        self._stopped.clear()

    def start(self) -> "SimulationDaemon":
        """Bind and serve from background threads (in-process daemon for
        tests and embedding); returns once the socket accepts."""
        self.bind()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="daemon-dispatch", daemon=True)
        self._dispatcher.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="daemon-accept", daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        """Bind and serve on the calling thread (the __main__ mode)."""
        self.bind()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="daemon-dispatch", daemon=True)
        self._dispatcher.start()
        self._accept_loop()

    def stop(self) -> None:
        """Graceful stop: refuse new work, finish in-flight rounds,
        persist the straggler history, remove the socket. Safe to call
        from any thread, repeatedly: the first caller tears down, later
        callers block until teardown is complete — so the CLI main
        thread cannot exit the process while a shutdown-RPC handler
        thread is still persisting state."""
        with self._cond:
            first = not self._stopping
            self._stopping = True
            self._running = False
            self._cond.notify_all()
        if not first:
            self._stopped.wait(timeout=60.0)
            return
        try:
            sock, self._sock = self._sock, None
            if sock is not None:
                # close() alone does not wake a thread blocked in accept() on
                # Linux; shutdown() does where the kernel honours it on a
                # listener (elsewhere the accept timeout ends the loop).
                # Without either the CLI daemon (which serves the accept loop
                # on its *main* thread) would hang forever after
                # acknowledging a shutdown RPC.
                with contextlib.suppress(OSError):
                    sock.shutdown(socket.SHUT_RDWR)
                with contextlib.suppress(OSError):
                    sock.close()
            if self._dispatcher is not None:
                self._dispatcher.join(timeout=30.0)
            try:
                self.save_history()
            except OSError:
                pass
            with contextlib.suppress(OSError):
                os.unlink(self.socket_path)
        finally:
            self._stopped.set()

    # -- accept / per-connection handler ------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            sock = self._sock             # stop() nulls this concurrently
            if sock is None:
                break
            try:
                conn, _ = sock.accept()
            except TimeoutError:
                continue                  # re-read _running
            except OSError:
                break                     # listener closed by stop()
            try:
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="daemon-conn", daemon=True).start()
            except BaseException:         # handler never took ownership
                conn.close()
                raise

    def _serve_conn(self, conn: socket.socket) -> None:
        client = _Client()
        with self._lock:
            self.n_clients += 1
        try:
            while self._running:
                try:
                    req = wire.recv_frame(conn)
                except (WireError, OSError):
                    break                 # peer died / garbage: drop conn
                if req is None:
                    break                 # clean EOF
                try:
                    resp = self._handle(client, req)
                except WireError as e:
                    resp = {"ok": False, "error": f"bad request: {e}"}
                except Exception as e:    # noqa: BLE001 — RPC boundary
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                try:
                    wire.send_frame(conn, resp)
                except (WireError, OSError):
                    break
                if resp.get("stopping"):
                    self.stop()           # ack delivered; now wind down
                    break
        finally:
            conn.close()
            with self._cond:
                self.n_clients -= 1
                # Submitted-but-never-flushed queries die with the client;
                # give their admission slots back.
                self._pending -= len(client.pending)
                client.pending.clear()

    # -- RPC ops -------------------------------------------------------------

    def _handle(self, client: _Client, req: dict) -> dict:
        op = str(req.get("op", ""))
        with obs.span("daemon.rpc", op=op):
            self.metrics.counter("daemon.rpcs", {"op": op}).inc()
            with self._lock:
                self.n_rpcs += 1
            if op == "ping":
                return {"ok": True, "pong": True,
                        "protocol": PROTOCOL_VERSION, "pid": os.getpid()}
            if op == "submit":
                return self._op_submit(client, req)
            if op == "flush":
                return self._op_flush(client)
            if op == "query_pair":
                return self._op_query_pair(client, req)
            if op == "sweep_chunk":
                return self._op_sweep_chunk(req)
            if op == "stats":
                return {"ok": True, "stats": self.stats()}
            if op == "shutdown":
                # The stop itself happens in _serve_conn AFTER this
                # response is flushed: stopping first races process exit
                # (CLI mode) against the client ever seeing the ack.
                return {"ok": True, "stopping": True}
            return {"ok": False, "error": f"unknown op {op!r}"}

    def _decode_query(self, doc: dict):
        topology, kw = wire.decode_query_spec(doc)
        return self.service.make_query(topology, **_make_query_kw(kw))

    def _admit(self, n: int) -> bool:
        """Reserve n admission slots, or refuse (backpressure)."""
        with self._lock:
            if self._pending + n > self.max_pending:
                self.n_busy_rejections += 1
                self.metrics.counter("daemon.busy_rejections").inc()
                return False
            self._pending += n
            return True

    def _busy(self) -> dict:
        return {"ok": False, "status": "busy",
                "retry_after_s": RETRY_AFTER_S,
                "pending": self._pending, "max_pending": self.max_pending}

    def _op_submit(self, client: _Client, req: dict) -> dict:
        if "paired" in req:
            pr = req["paired"]
            query = PairedQuery(
                a=self._decode_query(pr["a"]),
                b=self._decode_query(pr["b"]),
                policy=wire.decode_policy(pr.get("policy")))
        else:
            query = self._decode_query(req["query"])
        if not self._admit(1):
            return self._busy()
        client.pending.append(query)
        return {"ok": True, "queued": len(client.pending),
                "key": query.key()}

    def _op_flush(self, client: _Client) -> dict:
        queries, client.pending = client.pending, []
        if not queries:
            return {"ok": True, "results": []}
        freq = _FlushReq(client.id, queries)
        with self._cond:
            self._flushq.append(freq)
            self._cond.notify_all()
        freq.done.wait()
        if freq.error is not None:
            return {"ok": False,
                    "error": f"{type(freq.error).__name__}: {freq.error}"}
        return {"ok": True,
                "results": [_encode_result(freq.results[i],
                                           self.service.confidence)
                            for i in range(len(queries))]}

    def _op_query_pair(self, client: _Client, req: dict) -> dict:
        """One paired query, one round trip — rides the same dispatcher
        rounds as flushes, so it coalesces with other clients too. The
        connection's submitted-but-unflushed queries are untouched."""
        pr = req["paired"]
        query = PairedQuery(a=self._decode_query(pr["a"]),
                            b=self._decode_query(pr["b"]),
                            policy=wire.decode_policy(pr.get("policy")))
        if not self._admit(1):
            return self._busy()
        freq = _FlushReq(client.id, [query])
        with self._cond:
            self._flushq.append(freq)
            self._cond.notify_all()
        freq.done.wait()
        if freq.error is not None:
            return {"ok": False,
                    "error": f"{type(freq.error).__name__}: {freq.error}"}
        return {"ok": True,
                "results": [_encode_result(freq.results[0],
                                           self.service.confidence)]}

    def _op_sweep_chunk(self, req: dict) -> dict:
        topology, kw = wire.decode_query_spec(req["spec"])
        chunk_idx = int(req["chunk"])
        chunk_size = max(int(kw.pop("chunk_size", 1024)), 1)
        task_model = kw.pop("task_model", "divisible")
        W_list = kw.pop("W_list", (0,))
        lam_list = kw.pop("lam_list", (1,))
        theta = [tuple(t) for t in kw.pop("theta", ((0, 0),))]
        reps = int(kw.pop("reps", 1))
        seed0 = int(kw.pop("seed0", 1))
        mwt = bool(kw.pop("mwt", False))
        max_events = kw.pop("max_events", None)
        backend = kw.pop("backend", None)
        # Mirrors SimulationService.sweep exactly (same resolve_model
        # call, same canonical grid, same chunk_key/meta, the service's
        # device) so chunks computed here resume/serve library-mode sweeps
        # and vice versa.
        lam_flat = [l for entry in lam_list for l in lam_pair(entry)]
        model = resolve_model(topology, task_model, W_list=W_list,
                              lam_list=lam_flat, mwt=mwt,
                              max_events=max_events, backend=backend, **kw)
        grid = canonical_grid(W_list, lam_list, reps, theta=theta,
                              seed0=seed0)
        key = store_mod.chunk_key(model, grid, chunk_size, chunk_idx)
        rows = grid_rows(W_list, lam_list, reps, theta, seed0=seed0)
        lo = chunk_idx * chunk_size
        if lo >= len(rows):
            raise WireError(f"chunk {chunk_idx} out of range "
                            f"({len(rows)} rows / {chunk_size})")
        with self._exec_lock:
            g = self.store.get(key)
            from_cache = g is not None
            if g is None:
                g = run_rows(model, rows.slice(lo, lo + chunk_size),
                             backend=backend, device=self.service.device)
                canon = store_mod.canonical_model(model)
                self.store.put(key, g,
                               meta={"grid": grid, "model": canon,
                                     "chunk": {"size": int(chunk_size),
                                               "idx": int(chunk_idx)}})
        return {"ok": True, "key": key, "from_cache": from_cache,
                "n_rows": len(rows), "chunk_size": chunk_size,
                "grid": wire.encode_grid(g)}

    # -- the coalescing dispatcher ------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._flushq:
                    self._cond.wait(timeout=0.25)
                if not self._running and not self._flushq:
                    return
            # Let concurrent clients' flushes land in this round too: the
            # window is the price of cross-client coalescing (one short
            # sleep vs one whole device program per client).
            if self.coalesce_window_s > 0.0:
                time.sleep(self.coalesce_window_s)
            batch = self._take_round()
            if batch:
                self._run_round(batch)

    def _take_round(self) -> List[tuple]:
        """Round-robin drain: one query per flushing client per turn, up
        to ``max_round_queries`` — per-client fairness under load."""
        with self._cond:
            batch: List[tuple] = []       # (req, idx_in_req, query)
            while len(batch) < self.max_round_queries:
                progressed = False
                for freq in self._flushq:
                    if freq.taken < len(freq.queries):
                        batch.append((freq, freq.taken,
                                      freq.queries[freq.taken]))
                        freq.taken += 1
                        progressed = True
                        if len(batch) >= self.max_round_queries:
                            break
                if not progressed:
                    break
            # Requests whose queries are all handed out leave the queue
            # (their done event fires when results arrive).
            self._flushq = [f for f in self._flushq
                            if f.taken < len(f.queries)]
            return batch

    def _run_round(self, batch: List[tuple]) -> None:
        clients = {freq.client_id for freq, _, _ in batch}
        with self._exec_lock, \
                obs.span("daemon.round", n_queries=len(batch),
                         n_clients=len(clients)):
            self.n_rounds += 1
            self.metrics.counter("daemon.rounds").inc()
            self.metrics.histogram("daemon.round_queries").observe(
                len(batch))
            self.metrics.histogram("daemon.round_clients").observe(
                len(clients))
            try:
                for _, _, query in batch:
                    self.service.broker.submit(query)
                results = self.service.broker.flush()
            except BaseException as e:
                for freq, _, _ in batch:
                    freq.fail(e)
                with self._cond:
                    self._pending -= len(batch)
                if not isinstance(e, Exception):
                    raise                 # KeyboardInterrupt/SystemExit
                return
        for (freq, idx, _), result in zip(batch, results):
            freq.fulfil(idx, result)
        with self._cond:
            self._pending -= len(batch)

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """The fleet-dashboard payload: full service stats (including the
        metrics snapshot) plus daemon-level serving state."""
        with self._lock:
            daemon = dict(
                socket=str(self.socket_path),
                pid=os.getpid(),
                protocol=PROTOCOL_VERSION,
                n_clients=self.n_clients,
                n_rpcs=self.n_rpcs,
                n_rounds=self.n_rounds,
                n_busy_rejections=self.n_busy_rejections,
                pending=self._pending,
                max_pending=self.max_pending,
                coalesce_window_s=self.coalesce_window_s,
                max_round_queries=self.max_round_queries,
            )
        self.metrics.gauge("daemon.pending").set(daemon["pending"])
        self.metrics.gauge("daemon.clients").set(daemon["n_clients"])
        out = self.service.stats()
        out["daemon"] = daemon
        return out


def _make_query_kw(kw: dict) -> dict:
    """Wire kwargs -> ``make_query`` kwargs (JSON lists re-tupled where
    the query dataclass wants tuples; unknown keys pass through as
    ``model_kw``)."""
    out = dict(kw)
    if "theta" in out:
        out["theta"] = [tuple(t) for t in out["theta"]]
    if "lam_list" in out:
        out["lam_list"] = [tuple(l) if isinstance(l, list) else l
                           for l in out["lam_list"]]
    return out


def _encode_result(res, confidence: float) -> dict:
    if isinstance(res, PairedResult):
        return {"kind": "paired", "key": res.key,
                "grid_a": wire.encode_grid(res.grid_a),
                "grid_b": wire.encode_grid(res.grid_b),
                "from_cache": bool(res.from_cache),
                "n_rounds": int(res.n_rounds),
                "confidence": float(confidence)}
    return {"kind": "query", "key": res.key,
            "grid": wire.encode_grid(res.grid),
            "from_cache": bool(res.from_cache),
            "n_rounds": int(res.n_rounds),
            "confidence": float(confidence)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.daemon",
        description="Run the simulation daemon on a unix socket.")
    ap.add_argument("--socket", type=Path, default=None,
                    help="socket path (default: <store root>/daemon.sock)")
    ap.add_argument("--root", type=Path, default=None,
                    help="store root (default: artifacts/store)")
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--coalesce-window-s", type=float, default=0.02)
    ap.add_argument("--max-round-queries", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="where rounds and sweep chunks run (default: the "
                         "card; 'cpu' asks for the host)")
    args = ap.parse_args(argv)

    daemon = SimulationDaemon(
        socket_path=args.socket, root=args.root,
        max_pending=args.max_pending,
        coalesce_window_s=args.coalesce_window_s,
        max_round_queries=args.max_round_queries, device=args.device)

    def _term(signum, frame):
        daemon.stop()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    daemon.bind()
    print(f"READY {daemon.socket_path}", flush=True)
    daemon._dispatcher = threading.Thread(
        target=daemon._dispatch_loop, name="daemon-dispatch", daemon=True)
    daemon._dispatcher.start()
    daemon._accept_loop()
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
