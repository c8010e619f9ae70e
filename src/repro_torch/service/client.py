"""DaemonClient: the client half of the simulation daemon (DESIGN.md §12).

Looks like :class:`SimulationService`, speaks the
:mod:`repro_torch.service.wire` RPC to a
:class:`~repro_torch.service.daemon.SimulationDaemon` (or to the JAX
package's daemon: the frames are the same) when one is
listening, and *degrades to in-process library mode transparently* when it
is not — absent socket, daemon killed mid-round, version mismatch, a
question that cannot cross the wire (DAG arrays): every path ends in an
answer, never a client-visible transport exception. Mixing the two modes
is safe by construction: daemon and library fill the same content-addressed
store with byte-identical artifacts, so whatever one mode computed the
other serves as a cache hit.

Admission control is honoured client-side: a ``status="busy"`` soft-reject
is retried after the daemon's ``retry_after_s`` hint plus full-jitter
backoff (:class:`~repro_torch.service.resilience.RetryPolicy`), and only
after the retry budget is spent does the client fall back to library mode
— backpressure sheds load to the clients' own devices instead of queueing
without bound in the daemon.

Library mode runs where the client's ``device`` says (a keyword that goes
to :class:`SimulationService` with the others): the card unless the
caller asked for the CPU. It never moves to the CPU on its own.
"""
from __future__ import annotations

import os
import socket
import time
from pathlib import Path
from typing import List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.core.sweep import GridResult, concat_grids, grid_rows
from repro_torch.core.topology import Topology
from repro_torch.service import resilience as rz
from repro_torch.service import store as store_mod
from repro_torch.service import wire
from repro_torch.service.broker import (PairedResult, QueryResult,
                                        _paired_result)
from repro_torch.service.daemon import PROTOCOL_VERSION, default_socket_path
from repro_torch.service.estimator import PairedPolicy, summarize_cells
from repro_torch.service.wire import WireError


#: Seconds to wait for the daemon to accept a connection.
CONNECT_TIMEOUT_S = 2.0


class DaemonUnavailable(RuntimeError):
    """Raised only when ``fallback=False`` and the daemon path failed;
    with fallback enabled (the default) it is never visible to callers."""


class WireQuery:
    """A question held in wire form: the topology plus the raw
    ``make_query`` keyword arguments. Kept unresolved so the daemon's own
    service builds the model (one code path computes keys), and resolved
    locally only if the client must fall back."""

    __slots__ = ("topology", "kw")

    def __init__(self, topology: Topology, kw: dict):
        self.topology = topology
        self.kw = kw


class DaemonClient:
    """Daemon-first façade over the sweep service.

    ``root`` must name the same store root the daemon serves (the default
    socket path lives inside it, so the default wiring cannot disagree).
    ``fallback=False`` turns transport failures into
    :class:`DaemonUnavailable` instead of silent library mode — for tests
    and deployments that *require* the shared daemon. Remaining keywords
    go to the library-mode :class:`SimulationService` (``device`` among
    them: None is the card).
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 socket_path: Optional[os.PathLike] = None,
                 rpc_timeout_s: float = 600.0,
                 retry: Optional[rz.RetryPolicy] = None,
                 fallback: bool = True,
                 **service_kw):
        self.root = Path(root) if root is not None else store_mod.DEFAULT_ROOT
        self.socket_path = Path(socket_path) if socket_path is not None \
            else default_socket_path(self.root)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.retry = retry if retry is not None else rz.RetryPolicy(
            max_attempts=4, base_s=0.05, cap_s=1.0, deadline_s=30.0)
        self.fallback = bool(fallback)
        self._service_kw = dict(service_kw)
        self._local = None
        self.metrics = obs.REGISTRY
        self.n_daemon_answers = 0
        self.n_fallbacks = 0
        self.n_busy_retries = 0

    # -- the two substrates --------------------------------------------------

    @property
    def local(self):
        """The in-process fallback service (lazy: a healthy daemon-backed
        client never makes a CUDA context or loads the kernel library)."""
        if self._local is None:
            from repro_torch.service.api import SimulationService
            self._local = SimulationService(root=self.root,
                                            **self._service_kw)
        return self._local

    def _fall_back(self, why: str):
        if not self.fallback:
            raise DaemonUnavailable(why)
        self.n_fallbacks += 1
        self.metrics.counter("client.fallbacks").inc()
        obs.REGISTRY.info("client.last_fallback").set(why)
        return self.local

    # -- transport -----------------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(CONNECT_TIMEOUT_S)
            sock.connect(str(self.socket_path))
            sock.settimeout(self.rpc_timeout_s)
        except BaseException:
            sock.close()
            raise
        return sock

    def _call(self, conn: socket.socket, req: dict) -> dict:
        """One request/response on an open connection; busy soft-rejects
        are retried here (server hint + full-jitter backoff) so every
        caller sees either a definitive response or an exception."""
        attempt = 0
        while True:
            with obs.span("client.rpc", op=str(req.get("op", ""))):
                wire.send_frame(conn, req)
                resp = wire.recv_frame(conn)
            if resp is None:
                raise WireError("daemon closed the connection mid-RPC")
            if resp.get("status") != "busy":
                return resp
            attempt += 1
            self.n_busy_retries += 1
            self.metrics.counter("client.busy_retries").inc()
            if attempt >= self.retry.max_attempts:
                raise WireError(
                    f"daemon busy after {attempt} retries "
                    f"(pending={resp.get('pending')})")
            time.sleep(float(resp.get("retry_after_s", 0.05))
                       + self.retry.sleep_s(attempt))

    def _rpc_once(self, req: dict) -> dict:
        """Open, call, close — for single-shot ops (ping/stats/...)."""
        conn = self._connect()
        try:
            return self._call(conn, req)
        finally:
            conn.close()

    # -- liveness ------------------------------------------------------------

    def alive(self) -> bool:
        """Daemon liveness probe: socket answers a ping with a compatible
        protocol version."""
        try:
            resp = self._rpc_once({"op": "ping"})
        except (OSError, WireError):
            return False
        return bool(resp.get("ok")) \
            and resp.get("protocol") == PROTOCOL_VERSION

    # -- queries -------------------------------------------------------------

    def make_query(self, topology: Topology, **kw) -> WireQuery:
        """Build a query in wire form (mirrors
        ``SimulationService.make_query`` keywords verbatim)."""
        return WireQuery(topology, kw)

    def query(self, topology: Topology, **kw) -> QueryResult:
        return self.query_many([self.make_query(topology, **kw)])[0]

    def query_many(self, queries: Sequence[WireQuery]) -> List[QueryResult]:
        """Answer a batch: submitted to the shared daemon broker (where it
        coalesces with every other client's concurrent questions) or, on
        any transport/admission failure, recomputed in-process."""
        if not queries:
            return []
        try:
            specs = [wire.encode_query_spec(q.topology, q.kw)
                     for q in queries]
        except WireError as e:
            return self._local_query_many(
                queries, why=f"not wire-serializable: {e}")
        try:
            return self._daemon_query_many(specs)
        except (OSError, WireError) as e:
            return self._local_query_many(queries, why=str(e))

    def _daemon_query_many(self, specs: List[dict]) -> List[QueryResult]:
        conn = self._connect()
        try:
            for spec in specs:
                resp = self._call(conn, {"op": "submit", "query": spec})
                if not resp.get("ok"):
                    raise WireError(resp.get("error", "submit refused"))
            resp = self._call(conn, {"op": "flush"})
            if not resp.get("ok"):
                raise WireError(resp.get("error", "flush failed"))
            results = [_decode_result(doc) for doc in resp["results"]]
        finally:
            conn.close()
        if len(results) != len(specs):
            raise WireError(f"daemon answered {len(results)}/{len(specs)} "
                            "queries")
        self.n_daemon_answers += len(results)
        self.metrics.counter("client.daemon_answers").inc(len(results))
        return results

    def _local_query_many(self, queries: Sequence[WireQuery],
                          why: str) -> List[QueryResult]:
        svc = self._fall_back(why)
        return svc.query_many(
            [svc.make_query(q.topology, **q.kw) for q in queries])

    def query_pair(self, query_a: WireQuery, query_b: WireQuery,
                   policy: Optional[PairedPolicy] = None) -> PairedResult:
        """Paired CRN A/B comparison through the daemon (coalesces with
        other clients' rounds), falling back to library mode like
        :meth:`query_many`."""
        try:
            payload = {"paired": {
                "a": wire.encode_query_spec(query_a.topology, query_a.kw),
                "b": wire.encode_query_spec(query_b.topology, query_b.kw),
                "policy": wire.encode_policy(policy)}}
        except WireError as e:
            return self._local_query_pair(query_a, query_b, policy,
                                          why=str(e))
        try:
            resp = self._rpc_once({"op": "query_pair", **payload})
            if not resp.get("ok"):
                raise WireError(resp.get("error", "query_pair failed"))
            result = _decode_result(resp["results"][0])
            if not isinstance(result, PairedResult):
                raise WireError("daemon answered a paired query with a "
                                "solo result")
        except (OSError, WireError) as e:
            return self._local_query_pair(query_a, query_b, policy,
                                          why=str(e))
        self.n_daemon_answers += 1
        self.metrics.counter("client.daemon_answers").inc()
        return result

    def _local_query_pair(self, qa: WireQuery, qb: WireQuery,
                          policy, why: str) -> PairedResult:
        svc = self._fall_back(why)
        return svc.query_pair(svc.make_query(qa.topology, **qa.kw),
                              svc.make_query(qb.topology, **qb.kw),
                              policy=policy)

    # -- sweeps --------------------------------------------------------------

    def sweep(self, topology: Topology, *, chunk_size: int = 1024,
              **kw) -> GridResult:
        """Store-backed chunked sweep through the daemon, one
        ``sweep_chunk`` RPC per chunk (each chunk lands in the shared
        store the moment it finishes, so a client killed mid-sweep — or a
        daemon restarted mid-sweep — resumes at the next chunk for free).
        Falls back to ``SimulationService.sweep`` wholesale on transport
        failure; chunks the daemon already persisted are cache hits there.
        """
        chunk_size = max(int(chunk_size), 1)
        try:
            spec = wire.encode_query_spec(topology,
                                          {**kw, "chunk_size": chunk_size})
        except WireError as e:
            svc = self._fall_back(f"not wire-serializable: {e}")
            return svc.sweep(topology, chunk_size=chunk_size, **kw)
        n_rows = len(grid_rows(kw.get("W_list", (0,)),
                               kw.get("lam_list", (1,)),
                               int(kw.get("reps", 1)),
                               kw.get("theta", ((0, 0),)),
                               seed0=int(kw.get("seed0", 1))))
        n_chunks = -(-n_rows // chunk_size)
        parts = []
        try:
            conn = self._connect()
            try:
                for ci in range(n_chunks):
                    resp = self._call(conn, {"op": "sweep_chunk",
                                             "spec": spec, "chunk": ci})
                    if not resp.get("ok"):
                        raise WireError(resp.get("error", "sweep_chunk "
                                                          "failed"))
                    parts.append(wire.decode_grid(resp["grid"]))
            finally:
                conn.close()
        except (OSError, WireError) as e:
            svc = self._fall_back(str(e))
            return svc.sweep(topology, chunk_size=chunk_size, **kw)
        self.metrics.counter("client.daemon_answers").inc()
        self.n_daemon_answers += 1
        return concat_grids(parts)

    # -- admin ---------------------------------------------------------------

    def stats(self) -> dict:
        """Daemon stats when reachable (fleet payload, ``"daemon"`` key
        included), else the local fallback service's own stats."""
        try:
            resp = self._rpc_once({"op": "stats"})
            if resp.get("ok"):
                return resp["stats"]
            raise WireError(resp.get("error", "stats failed"))
        except (OSError, WireError) as e:
            return self._fall_back(str(e)).stats()

    def shutdown(self) -> bool:
        """Ask the daemon to stop (persisting its straggler history).
        True iff a daemon acknowledged."""
        try:
            resp = self._rpc_once({"op": "shutdown"})
        except (OSError, WireError):
            return False
        return bool(resp.get("ok"))


def _decode_result(doc: dict) -> Union[QueryResult, PairedResult]:
    conf = float(doc.get("confidence", 0.95))
    if doc.get("kind") == "paired":
        return _paired_result(str(doc["key"]),
                              wire.decode_grid(doc["grid_a"]),
                              wire.decode_grid(doc["grid_b"]),
                              conf, from_cache=bool(doc["from_cache"]),
                              n_rounds=int(doc["n_rounds"]))
    grid = wire.decode_grid(doc["grid"])
    return QueryResult(key=str(doc["key"]), grid=grid,
                       cells=summarize_cells(grid, conf),
                       from_cache=bool(doc["from_cache"]),
                       n_rounds=int(doc["n_rounds"]))
