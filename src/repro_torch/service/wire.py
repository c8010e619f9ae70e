"""Wire protocol of the simulation daemon (DESIGN.md §12).

Framing is the smallest thing that works over a ``SOCK_STREAM`` unix
socket: a 4-byte big-endian length prefix followed by one UTF-8 JSON
document. JSON (not pickle) because the two ends may run different code
revisions and a daemon must never ``eval`` client bytes; length-prefixed
(not newline-delimited) because result payloads embed base64 npz blobs.

Payload encodings are chosen so daemon answers are *bit-identical* to
library mode, and so the frames are the JAX package's own: the same field
names, the same base64 of int32 bytes, the same npz members — a client of
either package can talk to a daemon of the other:

* a :class:`~repro_torch.core.topology.Topology` crosses as its raw int32
  array bytes (base64) plus scalars — the daemon rebuilds the exact
  object, so canonical model JSON, store keys and bucket identities are
  unchanged;
* a :class:`~repro_torch.core.sweep.GridResult` crosses as an in-memory npz
  (``np.savez_compressed`` into a BytesIO, base64) — the same
  serialization the store's disk tier uses, so nothing is re-quantized;
* a query crosses as the *question* (``make_query`` keyword arguments),
  never as model objects: the daemon's own ``SimulationService`` builds
  the model, so query keys are computed by exactly one code path.

Anything that cannot cross losslessly (array-valued ``model_kw`` such as
DAG workloads, prebuilt ``TaskModel`` objects) raises :class:`WireError`
at *encode* time — the client catches it and transparently answers from
in-process library mode instead.
"""
from __future__ import annotations

import base64
import io
import json
import socket
import struct
from typing import Optional

import numpy as np

from repro_torch.core.sweep import GridResult
from repro_torch.core.topology import Topology
from repro_torch.service.estimator import (AdaptivePolicy, PairedPolicy,
                                           QuantilePolicy)
from repro_torch.service.store import _grid_from_npz, _grid_to_npz

#: Default daemon rendezvous: ``<store root>/daemon.sock`` (clients that
#: share a store root share a daemon). Kept as a name builder, not a
#: constant, because the root is per-deployment.
SOCKET_NAME = "daemon.sock"

#: Hard ceiling on a single frame. Far above any real payload (a 4096-row
#: grid is ~1 MB compressed); a peer announcing more is broken or hostile
#: and the connection is dropped instead of the daemon allocating it.
MAX_FRAME_BYTES = 256 * 1024 * 1024

_LEN = struct.Struct(">I")


class WireError(ValueError):
    """A value that cannot cross the wire losslessly (client falls back to
    library mode) or a malformed/oversized frame (connection is dropped)."""


# -- framing -----------------------------------------------------------------

def send_frame(sock: socket.socket, obj: dict) -> None:
    """One length-prefixed JSON frame; a single sendall so concurrent
    writers on *different* sockets never interleave partial frames."""
    blob = json.dumps(obj, separators=(",", ":")).encode()
    if len(blob) > MAX_FRAME_BYTES:
        raise WireError(f"frame of {len(blob)} bytes exceeds "
                        f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """n bytes or None on clean EOF at a frame boundary; raises WireError
    on EOF mid-frame (a peer that died while sending)."""
    buf = bytearray()
    while len(buf) < n:
        got = sock.recv(n - len(buf))
        if not got:
            if not buf:
                return None
            raise WireError(f"connection closed mid-frame "
                            f"({len(buf)}/{n} bytes)")
        buf += got
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    """One frame, or None when the peer closed cleanly between frames."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise WireError(f"peer announced a {n}-byte frame "
                        f"(cap {MAX_FRAME_BYTES})")
    body = _recv_exact(sock, n)
    if body is None:
        raise WireError("connection closed between length prefix and body")
    try:
        return json.loads(body.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable frame: {e}") from e


# -- arrays / topology -------------------------------------------------------

def _enc_i32(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(np.asarray(a, np.int32))
    return {"shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode()}


def _dec_i32(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.int32).reshape(d["shape"]).copy()


def encode_topology(t: Topology) -> dict:
    return {
        "cluster_id": _enc_i32(t.cluster_id),
        "hops": _enc_i32(t.hops),
        "lam_local": int(t.lam_local),
        "lam_remote": int(t.lam_remote),
        "strategy": int(t.strategy),
        "remote_prob": float(t.remote_prob),
        "name": str(t.name),
    }


def decode_topology(d: dict) -> Topology:
    return Topology(
        cluster_id=_dec_i32(d["cluster_id"]),
        hops=_dec_i32(d["hops"]),
        lam_local=int(d["lam_local"]),
        lam_remote=int(d["lam_remote"]),
        strategy=int(d["strategy"]),
        remote_prob=float(d["remote_prob"]),
        name=str(d["name"]),
    )


# -- grids -------------------------------------------------------------------

def encode_grid(grid: GridResult) -> str:
    """base64 of the store's own npz serialization (bit-lossless)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **_grid_to_npz(grid))
    return base64.b64encode(buf.getvalue()).decode()


def decode_grid(b64: str) -> GridResult:
    with np.load(io.BytesIO(base64.b64decode(b64))) as d:
        return _grid_from_npz(d)


# -- stopping policies -------------------------------------------------------

_POLICY_KINDS = {"adaptive": AdaptivePolicy, "quantile": QuantilePolicy,
                 "paired": PairedPolicy}


def encode_policy(policy) -> Optional[dict]:
    if policy is None:
        return None
    for kind, cls in _POLICY_KINDS.items():
        if isinstance(policy, cls):
            doc = {"kind": kind}
            for f in policy.__dataclass_fields__:
                v = getattr(policy, f)
                doc[f] = list(v) if isinstance(v, tuple) else v
            return doc
    raise WireError(f"unknown stopping policy {type(policy)!r}")


def decode_policy(doc: Optional[dict]):
    if doc is None:
        return None
    doc = dict(doc)
    cls = _POLICY_KINDS[doc.pop("kind")]
    if cls is QuantilePolicy and "quantiles" in doc:
        doc["quantiles"] = tuple(doc["quantiles"])
    return cls(**doc)


# -- query specs -------------------------------------------------------------

_SCALARS = (bool, int, float, str, type(None))


def encode_query_spec(topology: Topology, kw: dict) -> dict:
    """The ``make_query``/``sweep`` question as JSON. ``kw`` must be
    scalars/lists of scalars all the way down (DAG arrays, prebuilt models
    and callbacks cannot cross — WireError; the client answers those from
    library mode)."""
    if not isinstance(topology, Topology):
        raise WireError(f"expected a Topology, got {type(topology)!r}")
    out = {"topology": encode_topology(topology)}
    for k, v in kw.items():
        if k == "ci" and isinstance(v, (AdaptivePolicy, QuantilePolicy)):
            out["ci_policy"] = encode_policy(v)
            continue
        if isinstance(v, _SCALARS):
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = _enc_seq(k, v)
        else:
            raise WireError(f"query kwarg {k}={type(v)!r} is not "
                            "wire-serializable")
    return out


def _enc_seq(k: str, v) -> list:
    out = []
    for item in v:
        if isinstance(item, _SCALARS):
            out.append(item)
        elif isinstance(item, (list, tuple)):
            out.append(_enc_seq(k, item))
        elif isinstance(item, (np.integer,)):
            out.append(int(item))
        elif isinstance(item, (np.floating,)):
            out.append(float(item))
        else:
            raise WireError(f"query kwarg {k} contains non-scalar "
                            f"{type(item)!r}")
    return out


def decode_query_spec(doc: dict):
    """(topology, kwargs) ready for ``SimulationService.make_query``.
    Sequence kwargs arrive as JSON lists; ``make_query`` canonicalizes
    them itself (tuples of ints), so no per-field fixup is needed here."""
    doc = dict(doc)
    topology = decode_topology(doc.pop("topology"))
    if "ci_policy" in doc:
        doc["ci"] = decode_policy(doc.pop("ci_policy"))
    # theta arrives as [[a, b], ...]; make_query re-tuples it.
    return topology, doc
