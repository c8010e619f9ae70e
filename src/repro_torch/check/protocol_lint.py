"""Concurrency/protocol lint (AST) over the port's service and core trees.

The JAX package's pass of the same name, re-homed: the same six AST rules
and the same key-purity check, over ``src/repro_torch/``. A finding's rule
and symbol are those the JAX lint gives for the same source.

Rules (each emits ``Finding(pass_name="protocol", rule=...)``):

``lock.unlock_path``
    Any function that calls ``.try_lock(...)`` must release on all paths:
    a ``try/finally`` whose ``finally`` (or the guarded body of a context
    manager) reaches ``.unlock(...)`` or the break-mutex ``._break_lock``.
    The advisory-lock protocol (DESIGN.md §10) tolerates *stale* locks via
    heartbeat-mtime breaking, but a leaked lock still costs a liveness
    timeout on every other process — so acquisition without a structural
    release path is an error, not a warning.

``lock.heartbeat_before_dispatch``
    Any loop that dispatches work (``_dispatch_bucket`` / ``dispatch_resilient``
    / ``.flush(...)`` calls) while lock handles are in scope must call
    ``.heartbeat(...)`` earlier in the same loop body — otherwise a long
    dispatch lets the lock mtime go stale and a peer breaks it mid-write.

``store.atomic_write``
    Inside ``src/repro_torch/service/``, file writes must go through
    ``_write_atomic`` (tmp + ``os.replace``). Direct ``open(..., "w")``,
    ``.write_text`` / ``.write_bytes``, ``os.fdopen(..., "w")`` and
    ``np.savez*`` calls are flagged unless they are lexically inside an
    allowlisted writer (``_write_atomic`` itself, ``try_lock`` — O_EXCL
    lock files are their own protocol — or ``_corrupt_in_place``, the
    deliberate fault-injection writer).

``resilience.retry_nonrecoverable``
    An ``except`` clause inside a loop that names a NON_RECOVERABLE
    exception class (or the tuple itself) must re-``raise`` — wrapping
    programmer errors in a retry loop converts a crash into a hang. The
    class-name list comes from
    :func:`repro_torch.service.resilience.non_recoverable_names` so the
    lint can
    never drift from the runtime tuple.

``socket.close_path``
    Inside ``src/repro_torch/service/``, a local bound from ``.accept()``
    or a
    socket constructor (``socket.socket`` / ``create_connection``) must be
    structurally released: ``.close()`` in a ``finally``, ``.close()`` in
    an ``except`` handler that re-raises (the ownership-transfer idiom —
    close on failure, hand the live socket off on success), or use as a
    ``with`` context. Attribute-held sockets (``self._sock = ...``) are
    exempt — their owner's shutdown path closes them. A leaked accepted
    connection keeps a client blocked in ``recv`` until its RPC timeout,
    so the daemon tree enforces this shape rather than trusting review.

``imports.shadow``
    Bare ``import analysis`` / ``import check`` (or relative-less
    ``from analysis import ...``) anywhere under ``src/repro_torch/``: the
    makespan math is ``repro_torch.core.analysis`` and the checker suite is
    ``repro_torch.check`` — a bare import resolves to whichever shadow is on
    ``sys.path`` first.

``keys.purity``
    Runtime companion to the AST rules: serialize every registered task
    model through ``store.canonical_model`` and require the emitted keys
    to be a subset of ``store.CANONICAL_KEY_WHITELIST`` with none matching
    ``store.FORBIDDEN_KEY_PATTERN`` (backend/device/host/time...). A new
    cfg field changes the store key universe — that must be a reviewed
    whitelist edit, never an accident.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from repro_torch.check import Finding, repo_root

PASS = "protocol"

#: Functions allowed to perform raw writes (see ``store.atomic_write``).
ATOMIC_WRITE_ALLOWLIST = frozenset({
    "_write_atomic",      # the tmp + os.replace primitive itself
    "try_lock",           # O_EXCL lock files: atomicity comes from O_EXCL
    "_corrupt_in_place",  # deliberate fault injection (tests/chaos only)
    "encode_grid",        # wire.py: savez into an in-memory BytesIO, no file
})

#: Call names that count as "dispatching work" for the heartbeat rule.
DISPATCH_CALLS = frozenset({"_dispatch_bucket", "dispatch_resilient"})

#: Names whose presence in a function marks it as holding advisory locks.
LOCK_HANDLE_HINTS = frozenset({"owned", "heartbeat", "try_lock"})

#: Dotted call names that create a socket the caller owns.
SOCKET_CREATORS = frozenset({
    "socket.socket", "socket.create_connection", "socket.socketpair",
})


def _non_recoverable_names() -> frozenset:
    try:
        from repro_torch.service.resilience import non_recoverable_names
        return frozenset(non_recoverable_names()) | {"NON_RECOVERABLE"}
    except Exception:
        # Source-only fallback (e.g. linting a checkout without torch).
        return frozenset({"ValueError", "TypeError", "NotImplementedError",
                          "KeyError", "KeyboardInterrupt", "SystemExit",
                          "NON_RECOVERABLE"})


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _dotted(node: ast.expr) -> str:
    """'np.savez_compressed' for Attribute chains, 'open' for Names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class _Parents(ast.NodeVisitor):
    """Annotate every node with ``._parent`` for ancestor queries."""

    def generic_visit(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            child._parent = node  # type: ignore[attr-defined]
        super().generic_visit(node)


def _ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_parent", None)


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for anc in _ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _inside_allowlisted_writer(node: ast.AST) -> bool:
    """True when the node sits inside an allowlisted function or inside an
    argument to a ``_write_atomic(...)`` call (the lambda-writer idiom)."""
    for anc in _ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and anc.name in ATOMIC_WRITE_ALLOWLIST:
            return True
        if isinstance(anc, ast.Call) \
                and _call_name(anc) in ATOMIC_WRITE_ALLOWLIST:
            return True
    return False


def _mode_opens_for_write(call: ast.Call) -> bool:
    """Literal mode argument of open()/os.fdopen() mentions w/a/x/+."""
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if not isinstance(mode, str):
        return False
    return any(c in mode for c in "wax+")


def _finding(rule: str, path: str, node: ast.AST, symbol: str,
             message: str) -> Finding:
    line = getattr(node, "lineno", 0)
    return Finding(pass_name=PASS, rule=rule, where=f"{path}:{line}",
                   symbol=symbol, message=message)


# ---------------------------------------------------------------------------
# Per-rule checks (each takes the annotated tree + relative path string)
# ---------------------------------------------------------------------------

def _check_lock_release(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        acquires = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and _call_name(n) == "try_lock"
                    and _enclosing_function(n) is fn]
        if not acquires:
            continue
        releases = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and _call_name(n) in ("unlock", "_break_lock")
                    and _enclosing_function(n) is fn]
        in_finally = False
        for rel in releases:
            for anc in _ancestors(rel):
                if isinstance(anc, ast.Try) and any(
                        rel is n or any(rel is m for m in ast.walk(n))
                        for n in anc.finalbody):
                    in_finally = True
        if not in_finally:
            out.append(_finding(
                "lock.unlock_path", path, acquires[0], fn.name,
                f"{fn.name} acquires advisory locks via try_lock but has no "
                f"unlock/_break_lock inside a finally block: a raised "
                f"exception leaks the lock until heartbeat-timeout breaking"))
    return out


def _check_heartbeat(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
        attrs = {_call_name(n) for n in ast.walk(fn)
                 if isinstance(n, ast.Call)}
        if not (names | attrs) & LOCK_HANDLE_HINTS:
            continue  # function never touches lock handles
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call) \
                    or _call_name(call) not in DISPATCH_CALLS:
                continue
            loops = [a for a in _ancestors(call)
                     if isinstance(a, (ast.While, ast.For))]
            if not loops:
                continue  # single-shot dispatch: nothing goes stale
            beaten = any(
                any(isinstance(n, ast.Call) and _call_name(n) == "heartbeat"
                    and n.lineno <= call.lineno for n in ast.walk(loop))
                for loop in loops)
            if not beaten:
                out.append(_finding(
                    "lock.heartbeat_before_dispatch", path, call, fn.name,
                    f"{fn.name}: dispatch loop holds lock handles but does "
                    f"not heartbeat them before dispatching; a long dispatch "
                    f"lets the lock mtime go stale and a peer will break it"))
    return out


def _check_atomic_write(tree: ast.AST, path: str) -> List[Finding]:
    if "/service/" not in path.replace("\\", "/"):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        raw = None
        if dotted in ("open", "os.fdopen") and _mode_opens_for_write(node):
            raw = f"{dotted}(..., mode with w/a/x/+)"
        elif dotted.endswith((".write_text", ".write_bytes")):
            raw = dotted.rsplit(".", 1)[1] + "(...)"
        elif dotted.split(".")[-1].startswith("savez") or \
                dotted in ("np.save", "numpy.save"):
            raw = dotted + "(...)"
        if raw is None or _inside_allowlisted_writer(node):
            continue
        fn = _enclosing_function(node)
        sym = fn.name if fn is not None else "<module>"
        out.append(_finding(
            "store.atomic_write", path, node, sym,
            f"{sym}: raw file write via {raw}; service-tree writes must go "
            f"through _write_atomic (tmp + os.replace) so readers never "
            f"observe a torn artifact"))
    return out


def _check_retry_nonrecoverable(tree: ast.AST, path: str) -> List[Finding]:
    bad_names = _non_recoverable_names()
    out = []
    for handler in ast.walk(tree):
        if not isinstance(handler, ast.ExceptHandler) or handler.type is None:
            continue
        # Only *retry* loops count: while loops, or for loops over range()
        # (attempt counters). A for over a literal collection with per-item
        # tolerance is not retrying anything.
        in_loop = any(
            isinstance(a, ast.While)
            or (isinstance(a, ast.For) and isinstance(a.iter, ast.Call)
                and _dotted(a.iter.func) == "range")
            for a in _ancestors(handler))
        if not in_loop:
            continue
        named = {n.id for n in ast.walk(handler.type)
                 if isinstance(n, ast.Name)}
        hit = sorted(named & bad_names)
        if not hit:
            continue
        reraises = any(isinstance(n, ast.Raise) and n.exc is None
                       for n in ast.walk(handler))
        if reraises:
            continue
        fn = _enclosing_function(handler)
        sym = fn.name if fn is not None else "<module>"
        out.append(_finding(
            "resilience.retry_nonrecoverable", path, handler, sym,
            f"{sym}: except clause naming {', '.join(hit)} inside a loop "
            f"does not re-raise; NON_RECOVERABLE exceptions are programmer "
            f"errors and retrying them turns a crash into a hang"))
    return out


def _socket_released(fn: ast.AST, name: str) -> bool:
    """True when ``name`` (a socket local) is structurally released inside
    ``fn``: closed in a finally, closed in an except handler that
    re-raises (close-on-failure + hand-off-on-success), or used as a
    ``with`` context (directly or via ``contextlib.closing``)."""
    def is_close(n: ast.AST) -> bool:
        return (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "close"
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name)

    for n in ast.walk(fn):
        if isinstance(n, ast.Try):
            if any(is_close(m) for stmt in n.finalbody
                   for m in ast.walk(stmt)):
                return True
        elif isinstance(n, ast.ExceptHandler):
            if any(is_close(m) for m in ast.walk(n)) \
                    and any(isinstance(m, ast.Raise) for m in ast.walk(n)):
                return True
        elif isinstance(n, ast.With):
            for item in n.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name) and ce.id == name:
                    return True
                if isinstance(ce, ast.Call) and any(
                        isinstance(a, ast.Name) and a.id == name
                        for a in ce.args):
                    return True
    return False


def _check_socket_cleanup(tree: ast.AST, path: str) -> List[Finding]:
    if "/service/" not in path.replace("\\", "/"):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign) \
                    or _enclosing_function(node) is not fn \
                    or not isinstance(node.value, ast.Call):
                continue
            call = node.value
            is_accept = isinstance(call.func, ast.Attribute) \
                and call.func.attr == "accept"
            dotted = _dotted(call.func)
            if not is_accept and dotted not in SOCKET_CREATORS:
                continue
            tgt = node.targets[0]
            if is_accept and isinstance(tgt, ast.Tuple) and tgt.elts:
                tgt = tgt.elts[0]        # conn, addr = sock.accept()
            if not isinstance(tgt, ast.Name):
                continue  # attribute-held: owner's shutdown path closes it
            src = ".accept()" if is_accept else dotted + "(...)"
            if not _socket_released(fn, tgt.id):
                out.append(_finding(
                    "socket.close_path", path, node, fn.name,
                    f"{fn.name}: socket {tgt.id!r} from {src} has no "
                    f"structural release (close in finally, close in a "
                    f"re-raising except handler, or with-statement); a "
                    f"leaked connection keeps its peer blocked in recv "
                    f"until the RPC timeout"))
    return out


def _check_import_shadow(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    shadow = {"analysis", "check"}
    for node in ast.walk(tree):
        mod = None
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in shadow:
                    mod = alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module in shadow:
            mod = node.module
        if mod is None:
            continue
        want = "repro_torch.core.analysis" if mod == "analysis" \
            else "repro_torch.check"
        out.append(_finding(
            "imports.shadow", path, node, "<module>",
            f"bare 'import {mod}' is ambiguous between "
            f"repro_torch.core.analysis (paper makespan math) and "
            f"repro_torch.check (checker suite); "
            f"import {want} explicitly"))
    return out


_RULES = (_check_lock_release, _check_heartbeat, _check_atomic_write,
          _check_retry_nonrecoverable, _check_socket_cleanup,
          _check_import_shadow)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, filename: str) -> List[Finding]:
    """Lint one source string (the testable core of the pass)."""
    tree = ast.parse(src, filename=filename)
    _Parents().visit(tree)
    findings: List[Finding] = []
    for rule in _RULES:
        findings.extend(rule(tree, filename))
    return findings


def lint_paths(paths: Iterable[Path], root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for p in sorted(paths):
        rel = str(p.relative_to(root)) if p.is_relative_to(root) else str(p)
        findings.extend(lint_source(p.read_text(), rel))
    return findings


def tiny_models() -> List[Tuple[str, object]]:
    """One tiny configured model per registered task-model kind (the JAX
    package keeps this list in its jaxpr lint, which the port has not)."""
    from repro_torch.core import dag_gen, sweep
    from repro_torch.core.topology import one_cluster

    topo = one_cluster(4, 1)
    return [
        ("divisible", sweep.make_model("divisible", topology=topo,
                                       max_events=256)),
        ("dag", sweep.make_model("dag", topology=topo,
                                 dag=dag_gen.binary_tree(3), max_events=256)),
        ("adaptive", sweep.make_model("adaptive", topology=topo,
                                      max_events=256)),
    ]


def purity_findings() -> List[Finding]:
    """Store-key purity over every registered task model (runtime check)."""
    from repro_torch.service import store

    out: List[Finding] = []
    for name, model in tiny_models():
        try:
            canon = store.canonical_model(model)
        except Exception as e:
            out.append(Finding(
                pass_name=PASS, rule="keys.purity", where="store.canonical_model",
                symbol=name, message=f"canonical_model failed for {name}: "
                f"{type(e).__name__}: {e}"))
            continue
        out.extend(check_canonical(canon, symbol=name))
    return out


def check_canonical(canon: dict, symbol: str) -> List[Finding]:
    """Whitelist + forbidden-pattern check of one canonical-model dict."""
    from repro_torch.service import store

    out: List[Finding] = []
    flat = {k: store.CANONICAL_KEY_WHITELIST for k in canon}
    for sub, wl in (("topology", store.TOPOLOGY_KEY_WHITELIST),
                    ("dag", store.DAG_KEY_WHITELIST)):
        if isinstance(canon.get(sub), dict):
            for k in canon[sub]:
                flat[f"{sub}.{k}"] = wl
    for key in sorted(flat):
        leaf = key.split(".")[-1]
        wl = flat[key]
        if store.FORBIDDEN_KEY_PATTERN.search(leaf):
            out.append(Finding(
                pass_name=PASS, rule="keys.purity",
                where="store.canonical_model", symbol=symbol,
                message=f"canonical key {key!r} matches the forbidden "
                f"pattern ({store.FORBIDDEN_KEY_PATTERN.pattern}); "
                f"backend/host/device/time state must never reach sha256 "
                f"store keys"))
        elif leaf not in wl:
            out.append(Finding(
                pass_name=PASS, rule="keys.purity",
                where="store.canonical_model", symbol=symbol,
                message=f"canonical key {key!r} is not in the store-key "
                f"whitelist; extending the key universe must be an explicit "
                f"whitelist edit in service/store.py"))
    return out


def run(root: Optional[Path] = None) -> List[Finding]:
    root = root or repo_root()
    trees = [root / "src" / "repro_torch" / "service",
             root / "src" / "repro_torch" / "core"]
    files = [p for t in trees if t.exists() for p in t.rglob("*.py")]
    findings = lint_paths(files, root)
    # imports.shadow covers the whole package, not just service/core.
    pkg = root / "src" / "repro_torch"
    extra = [p for p in pkg.rglob("*.py")
             if not any(p.is_relative_to(t) for t in trees)]
    for p in sorted(extra):
        rel = str(p.relative_to(root))
        tree = ast.parse(p.read_text(), filename=rel)
        _Parents().visit(tree)
        findings.extend(_check_import_shadow(tree, rel))
    findings.extend(purity_findings())
    return findings


__all__ = ["PASS", "ATOMIC_WRITE_ALLOWLIST", "SOCKET_CREATORS",
           "lint_source", "lint_paths", "tiny_models",
           "check_canonical", "purity_findings", "run"]
