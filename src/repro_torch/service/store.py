"""Content-addressed result store (DESIGN.md §5).

Every sweep the service ever ran is addressable by a canonical sha256 of the
*question* — (engine version, task-model config, topology, grid spec) — and
cached forever under ``artifacts/store/``: a repeated query is a disk read,
a repeated query in the same process is a dict lookup (in-process LRU in
front of the disk tier). Keys are computed from canonical JSON (sorted keys,
arrays folded to (dtype, shape, bytes) digests), never from Python ``hash``
(which is salted per process), so they are stable across processes, hosts
and runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import engine as eng
from repro_torch.core.sweep import GridResult, as_model
from repro_torch.core.topology import Topology, remote_prob_u32
from repro_torch.service import resilience as rz

#: Default disk tier location: <repo>/artifacts/store.
DEFAULT_ROOT = Path(__file__).resolve().parents[3] / "artifacts" / "store"

# --- store-key purity -------------------------------------------------------
# The key universe is closed: canonical_model may emit exactly these keys.
# All backends are bit-identical, so nothing about
# the execution substrate — backend, device count, host, time — may ever
# reach a sha256 store key; a fill from any machine serves every other.
# Growing a model config is legal, but it must be a deliberate whitelist
# edit here (the key universe is identical to the JAX package's, so the two
# packages share one store).

#: Top-level canonical_model keys.
CANONICAL_KEY_WHITELIST = frozenset({
    "kind", "topology", "dag", "mwt", "max_events", "log_trace", "max_trace",
    "owner_lifo", "deque_cap", "merge_alpha", "merge_beta_num",
    "merge_beta_den", "pool_cap",
})

#: Keys of the nested canonical_topology dict.
TOPOLOGY_KEY_WHITELIST = frozenset({
    "cluster_id", "hops", "lam_local", "lam_remote", "strategy",
    "remote_prob_u32", "name",
})

#: Keys of the nested dag digest dict.
DAG_KEY_WHITELIST = frozenset({"dur", "child_ptr", "child_idx", "name"})

#: A canonical key matching this pattern is *always* an error, whitelisted
#: or not: it names execution-substrate or wall-clock state.
FORBIDDEN_KEY_PATTERN = re.compile(
    r"backend|device|host\b|hostname|platform|node|time|clock|pid|rank|"
    r"uname|cwd|env", re.IGNORECASE)

_GRID_FIELDS = ("W", "lam", "theta_static", "theta_comm", "seed", "makespan",
                "n_requests", "n_success", "n_fail", "total_idle",
                "startup_end", "overflow")


def _arr_digest(a) -> str:
    """Content digest of an array: dtype + shape + raw bytes."""
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256()
    h.update(str(a.dtype.str).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def canonical_topology(t: Topology) -> dict:
    return {
        "cluster_id": _arr_digest(t.cluster_id),
        "hops": _arr_digest(t.hops),
        "lam_local": int(t.lam_local),
        "lam_remote": int(t.lam_remote),
        "strategy": int(t.strategy),
        "remote_prob_u32": remote_prob_u32(float(t.remote_prob)),
        "name": str(t.name),
    }


def canonical_model(model) -> dict:
    """Canonical JSON-able form of a TaskModel's full static config.

    Keys are pure simulation semantics: a field whose name matches
    :data:`FORBIDDEN_KEY_PATTERN` (backend/device/host/time...) is refused
    at runtime — leaking substrate state into keys would silently fork the
    cache per backend/host. The closed whitelist
    (:data:`CANONICAL_KEY_WHITELIST`) is enforced by the protocol lint.
    """
    model = as_model(model)
    out: Dict[str, object] = {"kind": type(model).__name__}
    for f in dataclasses.fields(model.cfg):
        if FORBIDDEN_KEY_PATTERN.search(f.name):
            raise ValueError(
                f"config field {f.name!r} matches the forbidden store-key "
                f"pattern ({FORBIDDEN_KEY_PATTERN.pattern}): backend/host/"
                f"device/time state must never reach sha256 store keys")
        v = getattr(model.cfg, f.name)
        if f.name == "topology":
            out[f.name] = canonical_topology(v)
        elif f.name == "dag":
            out[f.name] = {
                "dur": _arr_digest(v.dur),
                "child_ptr": _arr_digest(v.child_ptr),
                "child_idx": _arr_digest(v.child_idx),
                "name": str(v.name),
            }
        elif v is None or isinstance(v, (bool, str)):
            out[f.name] = v
        elif isinstance(v, (int, np.integer)):
            out[f.name] = int(v)
        elif isinstance(v, (float, np.floating)):
            # No float configs exist today; fail loud rather than hash
            # representation-dependent text if one appears.
            raise TypeError(f"float config field {f.name} needs a canonical "
                            "fixed-point encoding")
        else:
            raise TypeError(f"unhashable config field {f.name}: {type(v)!r}")
    return out


def query_key(model, grid: dict, extra: Optional[dict] = None) -> str:
    """Content address of a sweep question. ``grid`` is the canonical grid
    dict from :func:`repro_torch.core.sweep.canonical_grid`; ``extra`` carries
    layers above the raw sweep (e.g. the adaptive-estimation policy)."""
    payload = {
        "engine_version": eng.ENGINE_VERSION,
        "model": canonical_model(model),
        "grid": grid,
    }
    if extra:
        payload["extra"] = extra
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def model_digest(model) -> str:
    """sha256 of the canonical model config — the broker's bucket identity
    (structurally identical models coalesce even when built by different
    callers) and the cross-model component of paired-query arm keys."""
    blob = json.dumps(canonical_model(model), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def chunk_key(model, grid: dict, chunk_size: int, chunk_idx: int) -> str:
    """Content address of one ``run_grid`` chunk. Chunk boundaries are a
    deterministic function of (grid spec, chunk_size), so persisting each
    chunk under this key gives cross-process partial-sweep resume: a rerun
    recomputes only the chunks the store does not already hold."""
    return query_key(model, grid,
                     extra={"chunk": {"size": int(chunk_size),
                                      "idx": int(chunk_idx)}})


def _grid_to_npz(grid: GridResult) -> Dict[str, np.ndarray]:
    d = {name: np.asarray(getattr(grid, name)) for name in _GRID_FIELDS}
    d["p"] = np.asarray(grid.p, np.int32)
    for k, v in grid.extras.items():
        d[f"extra__{k}"] = np.asarray(v)
    return d


def _grid_from_npz(d) -> GridResult:
    extras = {k[len("extra__"):]: d[k] for k in d.files
              if k.startswith("extra__")}
    return GridResult(p=int(d["p"]), extras=extras,
                      **{name: d[name] for name in _GRID_FIELDS})


class ResultStore:
    """Two-tier (LRU dict over npz files) content-addressed GridResult store.

    Writes — both the npz artifact and its ``.json`` question sidecar — are
    atomic (tmp file + ``os.replace``) so concurrent processes sharing
    ``root`` can only ever observe complete artifacts. An artifact that is
    nonetheless unreadable (zero-byte or truncated npz from a killed writer
    on a filesystem without atomic rename visibility) is treated as a cache
    miss and quarantined (renamed ``*.corrupt``) rather than poisoning every
    future query with that key.

    ``gc_bytes`` bounds the disk tier: after every put exceeding the budget,
    the oldest artifacts (LRU on file mtime; reads refresh it) are evicted
    until the tier fits. :meth:`write_manifest` snapshots the disk tier as a
    ``manifest.json`` of (key, bytes, mtime, question digest) rows so
    fleet-shared object stores (GCS/S3) can sync the directory.
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 lru_capacity: int = 128,
                 gc_bytes: Optional[int] = None,
                 lock_stale_s: float = 300.0,
                 touch_throttle_s: float = 60.0,
                 metrics: Optional[obs.MetricsRegistry] = None,
                 retry: Optional[rz.RetryPolicy] = None):
        self.root = Path(root) if root is not None else DEFAULT_ROOT
        self.lru_capacity = int(lru_capacity)
        self.gc_bytes = None if gc_bytes is None else int(gc_bytes)
        self.lock_stale_s = float(lock_stale_s)
        # Memory-tier hits refresh the disk artifact's mtime (GC freshness)
        # at most once per key per this many seconds: a hot-loop key costs
        # one dict lookup per hit, not one utime syscall (0 = every hit).
        self.touch_throttle_s = float(touch_throttle_s)
        self._last_touch: Dict[str, float] = {}
        # Transient-I/O retry (full-jitter backoff) wrapped around disk reads
        # and the atomic artifact write; a fault that outlives the budget
        # degrades to the pre-existing behaviour (miss / raise).
        self.retry = retry if retry is not None else rz.RetryPolicy(
            max_attempts=3, base_s=0.01, cap_s=0.25, deadline_s=10.0)
        self._lru: "OrderedDict[str, GridResult]" = OrderedDict()
        self.metrics = metrics if metrics is not None else obs.REGISTRY
        self.hits_mem = 0
        self.hits_disk = 0
        self.misses = 0
        self.puts = 0
        self.corrupt = 0
        self.gc_evictions = 0
        self.locks_broken = 0
        self._disk_total: Optional[int] = None   # running estimate for GC

    def _count(self, name: str, n: int = 1):
        """Bump both the legacy attribute and the metrics-registry series
        (``store.<name>``) so old ``stats()`` readers and new ``snapshot()``
        consumers always agree."""
        setattr(self, name, getattr(self, name) + n)
        self.metrics.counter(f"store.{name}").inc(n)

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.npz"

    def _sidecar(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def get(self, key: str) -> Optional[GridResult]:
        with obs.span("store.get") as sp:
            g = self._lru.get(key)
            if g is not None:
                self._lru.move_to_end(key)
                self._count("hits_mem")
                sp.set(tier="mem")
                # Refresh the disk artifact's mtime on memory hits too: a key
                # this process serves from its LRU is hot, and must not look
                # cold to another process's oldest-mtime GC of the shared
                # tier. Throttled (touch_throttle_s): GC staleness is
                # measured in minutes, so hot-loop hits stay syscall-free.
                self._touch_throttled(key)
                return g
            path = self._path(key)
            if path.exists():
                def _load():
                    rz.fault_point("store.get", key=key)
                    with np.load(path) as d:
                        return _grid_from_npz(d)
                try:
                    g = self.retry.call(_load, retry_on=(OSError,),
                                        metrics=self.metrics,
                                        label="store.get")
                except Exception:
                    self._quarantine(key)
                else:
                    self._remember(key, g)
                    self._count("hits_disk")
                    sp.set(tier="disk")
                    self._touch_throttled(key)
                    return g
            self._count("misses")
            sp.set(tier="miss")
            return None

    def _quarantine(self, key: str):
        """Move an unreadable artifact aside so the key can be recomputed."""
        path = self._path(key)
        try:
            os.replace(path, path.with_suffix(".corrupt"))
        except OSError:
            pass                   # a concurrent reader may have beaten us
        self._count("corrupt")

    @staticmethod
    def _touch(path: Path):
        """Refresh mtime on read so GC evicts genuinely cold artifacts."""
        try:
            os.utime(path)
        except OSError:
            pass

    def _touch_throttled(self, key: str):
        """Per-key rate-limited :meth:`_touch`: the first hit always
        refreshes; repeats within ``touch_throttle_s`` are dropped (the
        mtime is at most that much stale, far inside any sane GC horizon)."""
        now = time.monotonic()
        last = self._last_touch.get(key)
        if last is not None and now - last < self.touch_throttle_s:
            self.metrics.counter("store.touches_throttled").inc()
            return
        self._last_touch[key] = now
        self._touch(self._path(key))

    def _write_atomic(self, path: Path, writer):
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                writer(f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put(self, key: str, grid: GridResult,
            meta: Optional[dict] = None) -> Path:
        with obs.span("store.put") as sp:
            return self._put(key, grid, meta, sp)

    def _put(self, key: str, grid: GridResult,
             meta: Optional[dict], sp) -> Path:
        self.root.mkdir(parents=True, exist_ok=True)
        path = self._path(key)

        def _write():
            # Fault site: "oserror"/"raise" simulate a failed write (retried
            # with backoff); "torn_write"/"bit_flip" return an action applied
            # AFTER the atomic write — the on-disk artifact is corrupted the
            # way a crashed writer / flaky disk would leave it, while this
            # process's LRU keeps the good copy (readers recover via
            # quarantine + recompute).
            act = rz.fault_point("store.put", key=key)
            self._write_atomic(
                path, lambda f: np.savez_compressed(f, **_grid_to_npz(grid)))
            return act

        action = self.retry.call(_write, retry_on=(OSError,),
                                 metrics=self.metrics, label="store.put")
        if action:
            self._corrupt_in_place(path, action)
        if meta is not None:
            blob = json.dumps(meta, sort_keys=True, indent=1).encode()
            self._write_atomic(self._sidecar(key), lambda f: f.write(blob))
        self._remember(key, grid)
        self._count("puts")
        if obs.enabled():          # _entry_bytes stats the files — skip when off
            sp.set(bytes=self._entry_bytes(key))
        if self.gc_bytes is not None:
            # Amortized budget check: one full directory scan seeds a
            # running byte estimate, each put increments it, and the real
            # (scanning) GC only runs when the estimate exceeds the budget
            # — store fills stay O(N), not O(N²) stat calls.
            if self._disk_total is None:
                self._disk_total = self.disk_bytes()
            else:
                self._disk_total += self._entry_bytes(key)
            if self._disk_total > self.gc_bytes:
                self.gc(self.gc_bytes)
        return path

    def _remember(self, key: str, grid: GridResult):
        self._lru[key] = grid
        self._lru.move_to_end(key)
        while len(self._lru) > self.lru_capacity:
            old, _ = self._lru.popitem(last=False)
            # The throttle map tracks only LRU-resident keys, so a
            # long-lived daemon's map is bounded by lru_capacity.
            self._last_touch.pop(old, None)

    def contains(self, key: str) -> bool:
        return key in self._lru or self._path(key).exists()

    def _corrupt_in_place(self, path: Path, action: str):
        """Apply an injected corruption to a landed artifact: ``torn_write``
        truncates it mid-file (a crashed writer on a non-atomic filesystem),
        ``bit_flip`` flips one byte (silent media corruption)."""
        try:
            size = path.stat().st_size
            if action == "torn_write":
                with open(path, "r+b") as f:
                    f.truncate(max(size // 2, 1))
            elif action == "bit_flip" and size:
                with open(path, "r+b") as f:
                    f.seek(size // 2)
                    b = f.read(1)
                    f.seek(size // 2)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        except OSError:
            pass

    # -- advisory key locks (cross-process in-flight dedup) ------------------

    def _lock_path(self, key: str) -> Path:
        return self.root / f"{key}.lock"

    @staticmethod
    def _lock_holder(path: Path):
        """(pid, host) recorded in a lock file, or None when unreadable
        (mid-write, foreign format, or gone)."""
        try:
            parts = path.read_text().split()
            return int(parts[0]), parts[1]
        except (OSError, ValueError, IndexError):
            return None

    @classmethod
    def _holder_dead(cls, path: Path) -> bool:
        """True iff the lock names a holder on THIS host whose pid no longer
        runs — wreckage of a crashed process, breakable immediately instead
        of after ``lock_stale_s``. Unreadable/foreign locks are presumed
        live (age-based staleness still applies to them)."""
        holder = cls._lock_holder(path)
        if holder is None or holder[1] != os.uname().nodename:
            return False
        try:
            os.kill(holder[0], 0)
        except ProcessLookupError:
            return True
        except OSError:
            pass
        return False

    def _break_lock(self, path: Path, st) -> bool:
        """Break the observed (stale or dead-holder) lock; True iff WE broke
        it and may deterministically re-acquire. Breaking is serialized by a
        per-key *break mutex* (``.lock-break``, itself ``O_EXCL``): the one
        breaker holding it re-verifies under the mutex that the lock on disk
        is still the stale one it judged (same inode — not a fresh lock a
        faster winner already re-created), and only then unlinks it. Every
        loser returns False and re-polls, so of N concurrent breakers at
        most one ever proceeds to the ``O_EXCL`` re-acquire and a winner's
        fresh lock is never collateral damage. A break mutex whose owner
        crashed is cleared by age."""
        brk = path.with_suffix(".lock-break")
        try:
            bfd = os.open(brk, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # Another breaker holds the mutex. Clear it if ITS owner died
            # mid-break (crashed breaker), then re-poll either way.
            try:
                if time.time() - brk.stat().st_mtime > \
                        max(5.0, self.lock_stale_s):
                    os.unlink(brk)
            except OSError:
                pass
            return False
        except OSError:
            return False
        try:
            os.close(bfd)
            try:
                cur = path.stat()
            except OSError:
                return True           # lock vanished: free to re-acquire
            if cur.st_ino != st.st_ino:
                return False          # fresh lock from a new winner: abort
            try:
                os.unlink(path)
            except OSError:
                return False
            self._count("locks_broken")
            return True
        finally:
            try:
                os.unlink(brk)
            except OSError:
                pass

    def try_lock(self, key: str, break_dead: bool = True) -> bool:
        """Best-effort advisory lock on a key: True iff this process now
        holds it. ``O_CREAT | O_EXCL`` is atomic on POSIX (incl. NFSv3+ for
        regular files), so of N processes about to compute the same key,
        one wins and the rest poll the store instead (see the broker's
        flush).

        The lock file records ``pid host timestamp``; its mtime is the
        holder's heartbeat (:meth:`heartbeat`). A lock is breakable when it
        is older than ``lock_stale_s`` (no heartbeat that long = presumed
        dead anywhere) or — with ``break_dead`` — the moment its holder pid
        stops running on this host, so waiters recover from a crashed
        holder in seconds, not minutes. Breaking is deterministic: the one
        process whose rename-away of the old lock succeeds re-acquires via
        ``O_EXCL``; every loser returns False and re-polls. Purely an
        optimization: correctness never depends on the lock — a process
        that cannot get it may still compute (the store write is atomic and
        idempotent)."""
        self.root.mkdir(parents=True, exist_ok=True)
        path = self._lock_path(key)
        broke = False
        for _ in range(3):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if broke:
                    # We broke the old lock but someone else O_EXCL'd the
                    # path before our re-acquire: their lock is fresh.
                    return False
                try:
                    st = path.stat()
                except OSError:
                    continue          # holder just released it; retry
                age = time.time() - st.st_mtime
                if age < self.lock_stale_s and not (
                        break_dead and self._holder_dead(path)):
                    return False
                if not self._break_lock(path, st):
                    return False      # another breaker is the winner
                broke = True
                continue              # we won the break: O_EXCL re-acquire
            with os.fdopen(fd, "w") as f:
                f.write(f"{os.getpid()} {os.uname().nodename} "
                        f"{time.time():.3f}")
            # Chaos hook: kind="exit" simulates a holder crashing right
            # after acquiring (waiters must detect the dead pid and break).
            rz.fault_point("store.lock.acquired", key=key)
            return True
        return False

    def heartbeat(self, key: str):
        """Refresh a held lock's mtime so long computations are not broken
        as stale by age (the holder's liveness signal for foreign hosts;
        same-host waiters also see the pid directly)."""
        try:
            os.utime(self._lock_path(key))
        except OSError:
            pass

    def unlock(self, key: str):
        try:
            os.unlink(self._lock_path(key))
        except OSError:
            pass

    def lock_live(self, key: str) -> bool:
        """The key's lock exists, is younger than ``lock_stale_s``, and its
        holder is not a dead same-host pid — i.e. some live process really
        is computing this key. GC must not evict such a key's artifact."""
        path = self._lock_path(key)
        try:
            age = time.time() - path.stat().st_mtime
        except OSError:
            return False
        return age < self.lock_stale_s and not self._holder_dead(path)

    def lock_held(self, key: str) -> bool:
        """A *fresh* lock file exists (some live process is computing)."""
        return self.lock_live(key)

    def clear_memory(self):
        """Drop the in-process tier (the disk tier keeps serving)."""
        self._lru.clear()

    # -- disk-tier bookkeeping: GC + manifest -------------------------------

    def _entry_bytes(self, key: str) -> int:
        size = 0
        for p in (self._path(key), self._sidecar(key)):
            try:
                size += p.stat().st_size
            except OSError:
                pass
        return size

    def _disk_entries(self) -> list:
        """(key, npz bytes + sidecar bytes, mtime) per artifact on disk."""
        out = []
        if not self.root.is_dir():
            return out
        for path in self.root.glob("*.npz"):
            try:
                st = path.stat()
            except OSError:
                continue           # evicted by a concurrent process
            size = st.st_size
            side = path.with_suffix(".json")
            try:
                size += side.stat().st_size
            except OSError:
                pass
            out.append((path.stem, size, st.st_mtime))
        return out

    #: `.tmp` files younger than this may belong to a live writer (deleting
    #: one would break its in-flight ``os.replace``); older ones are wreckage.
    _TMP_STALE_S = 3600.0

    def _junk_entries(self) -> list:
        """(path, bytes) of quarantined ``.corrupt`` files, stale ``.tmp``
        wreckage and dead ``.lock`` files — junk that must count against
        the byte budget (it lives in the tier) and that GC deletes before
        touching real artifacts. A lock is junk when it aged past
        ``lock_stale_s`` OR its same-host holder pid is dead; a *live*
        lock is never junk."""
        out = []
        if not self.root.is_dir():
            return out
        now = time.time()
        for pattern, min_age in (("*.corrupt", 0.0),
                                 ("*.tmp", self._TMP_STALE_S),
                                 ("*.lock", self.lock_stale_s),
                                 ("*.lock-break", self._TMP_STALE_S)):
            for path in self.root.glob(pattern):
                try:
                    st = path.stat()
                except OSError:
                    continue
                if now - st.st_mtime >= min_age or (
                        pattern == "*.lock" and self._holder_dead(path)):
                    out.append((path, st.st_size))
        return out

    def disk_bytes(self) -> int:
        """Bytes the disk tier occupies: artifacts + sidecars + junk
        (quarantined/stale files) — the quantity ``gc_bytes`` bounds."""
        return (sum(size for _, size, _ in self._disk_entries())
                + sum(size for _, size in self._junk_entries()))

    def gc(self, max_bytes: Optional[int] = None) -> int:
        """Shrink the disk tier to ``max_bytes`` (default: the store's
        ``gc_bytes`` budget): junk (quarantined ``.corrupt``, stale ``.tmp``)
        is deleted first, then the oldest-mtime artifacts (npz + sidecar)
        until the tier fits. Returns the number of *artifacts* evicted. The
        in-process LRU is untouched — an evicted answer this process already
        holds keeps serving from memory; only the shared disk tier shrinks.
        """
        budget = self.gc_bytes if max_bytes is None else int(max_bytes)
        if budget is None:
            raise ValueError("gc() needs max_bytes or a gc_bytes budget")
        entries = sorted(self._disk_entries(), key=lambda e: e[2])
        junk = self._junk_entries()
        total = sum(size for _, size, _ in entries) \
            + sum(size for _, size in junk)
        if total > budget:
            for path, size in junk:
                try:
                    os.unlink(path)
                    total -= size
                except OSError:
                    pass
        evicted = 0
        for key, size, _ in entries:
            if total <= budget:
                break
            if self.lock_live(key):
                # A live lock marks an in-flight computation (a waiter may
                # be about to serve this key): never evict under it.
                continue
            for p in (self._path(key), self._sidecar(key)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            total -= size
            evicted += 1
        self._count("gc_evictions", evicted)
        self._disk_total = total
        return evicted

    def manifest(self) -> dict:
        """Disk-tier listing: one row per artifact with its content key,
        total bytes (npz + sidecar), mtime and the sha256 of the sidecar's
        canonical question (null when the artifact has no sidecar)."""
        arts = []
        for key, size, mtime in sorted(self._disk_entries()):
            side = self._sidecar(key)
            qd = None
            if side.exists():
                qd = hashlib.sha256(side.read_bytes()).hexdigest()
            arts.append(dict(key=key, bytes=int(size), mtime=float(mtime),
                             question_digest=qd))
        return {"engine_version": eng.ENGINE_VERSION,
                "n_artifacts": len(arts),
                "total_bytes": int(sum(a["bytes"] for a in arts)),
                "artifacts": arts}

    def write_manifest(self) -> Path:
        """Atomically write ``manifest.json`` into the store root."""
        self.root.mkdir(parents=True, exist_ok=True)
        blob = json.dumps(self.manifest(), sort_keys=True, indent=1).encode()
        path = self.root / "manifest.json"
        self._write_atomic(path, lambda f: f.write(blob))
        return path

    def read_manifest(self) -> Optional[dict]:
        path = self.root / "manifest.json"
        if not path.exists():
            return None
        return json.loads(path.read_text())

    def stats(self) -> dict:
        self.metrics.gauge("store.lru_len").set(len(self._lru))
        return dict(hits_mem=self.hits_mem, hits_disk=self.hits_disk,
                    misses=self.misses, puts=self.puts,
                    corrupt=self.corrupt, gc_evictions=self.gc_evictions,
                    locks_broken=self.locks_broken,
                    lru_len=len(self._lru))
