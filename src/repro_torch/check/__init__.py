"""repro_torch.check — the port's invariant checker suite.

Two passes, one CLI (``python -m repro_torch.check``), one baseline
(``artifacts/check/baseline_torch.json``, absent while there is nothing to
baseline: an absent file reads as empty):

* ``protocol`` — AST lint over ``src/repro_torch/service/`` and
  ``src/repro_torch/core/``: lock discipline, heartbeat-before-dispatch,
  tmp+``os.replace``-only store writes, NON_RECOVERABLE never retried,
  sockets released on every path, no bare ``import analysis``/``check``
  anywhere in the package, and store-key purity (canonical JSON closed over
  a field whitelist).
* ``sanitizer`` — opt-in runtime probes (``REPRO_WS_SANITIZE=1``): steal
  accounting and a bitwise oracle replay of sampled dispatches
  (``backend.result``), the broker's event history (``broker.observe``)
  and the segmented loop (``engine.segment``).

The JAX package's third pass, the jaxpr lint, has no counterpart yet.

Naming note: this package is ``repro_torch.check``; the paper's
makespan-bound analysis lives in :mod:`repro_torch.core.analysis`.

Findings are machine-readable (:class:`Finding`) and fingerprinted without
line numbers, in the same form as the JAX package's, so the two packages'
findings compare directly; new findings fail the CLI, baselined ones only
warn.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PASSES = ("protocol", "sanitizer")

#: Default baseline, relative to the repo root (the JAX package's is
#: ``artifacts/check/baseline.json``).
BASELINE_REL = Path("artifacts") / "check" / "baseline_torch.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker finding.

    ``where`` is ``path:line`` for static passes or a runtime site name for
    the sanitizer; the line is stripped from the fingerprint so baselines
    stay stable across unrelated edits. ``message`` must therefore be
    written value-stable by each rule (no line numbers, no timings).
    """

    pass_name: str          # one of PASSES
    rule: str               # e.g. "replay_mismatch"
    where: str              # a file:line, or a runtime site name
    symbol: str             # enclosing function / model / backend name
    message: str
    severity: str = "error"

    def fingerprint(self) -> str:
        loc = self.where.rsplit(":", 1)[0] if self._has_line() else self.where
        blob = "|".join((self.pass_name, self.rule, loc, self.symbol,
                         self.message))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    def _has_line(self) -> bool:
        tail = self.where.rsplit(":", 1)
        return len(tail) == 2 and tail[1].isdigit()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(pass_name=d["pass_name"], rule=d["rule"], where=d["where"],
                   symbol=d.get("symbol", ""), message=d["message"],
                   severity=d.get("severity", "error"))


def repo_root(start: Optional[Path] = None) -> Path:
    """Walk up from ``start`` (default: this file) to the checkout root."""
    here = (start or Path(__file__)).resolve()
    for cand in (here, *here.parents):
        if (cand / "pyproject.toml").exists():
            return cand
    return here.parent


def default_baseline_path() -> Path:
    return repo_root() / BASELINE_REL


def load_baseline(path: Path) -> Dict[str, dict]:
    """fingerprint -> recorded finding dict; empty when the file is absent."""
    if not path.exists():
        return {}
    doc = json.loads(path.read_text())
    return {f["fingerprint"]: f for f in doc.get("findings", [])}


def write_baseline(findings: Iterable[Finding], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "version": 1,
        "findings": sorted((f.to_dict() for f in findings),
                           key=lambda d: (d["pass_name"], d["rule"],
                                          d["where"], d["fingerprint"])),
    }
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def split_against_baseline(
        findings: Iterable[Finding],
        baseline: Dict[str, dict]) -> Tuple[List[Finding], List[Finding]]:
    """Partition into (new, known) by fingerprint membership."""
    new, known = [], []
    for f in findings:
        (known if f.fingerprint() in baseline else new).append(f)
    return new, known


def run_pass(name: str, device=None) -> List[Finding]:
    """Run one pass by name (lazy imports keep this package import-light).
    ``device`` is where the sanitizer's workload runs (None: the card)."""
    if name == "protocol":
        from repro_torch.check import protocol_lint
        return protocol_lint.run()
    if name == "sanitizer":
        from repro_torch.check import sanitizer
        return sanitizer.run(device=device)
    raise ValueError(f"unknown check pass {name!r}; expected one of {PASSES}")


def run_all(passes: Iterable[str] = PASSES, device=None) -> List[Finding]:
    out: List[Finding] = []
    for name in passes:
        out.extend(run_pass(name, device=device))
    return out


__all__ = [
    "PASSES", "Finding", "repo_root", "default_baseline_path",
    "load_baseline", "write_baseline", "split_against_baseline",
    "run_pass", "run_all",
]
