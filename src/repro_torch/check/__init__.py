"""repro_torch.check — the port's runtime invariant checks.

The JAX package's checker suite has three passes; the port carries the one
that guards its runtime:

* ``sanitizer`` — opt-in runtime probes (``REPRO_WS_SANITIZE=1``): steal
  accounting and a bitwise oracle replay of sampled dispatches
  (``backend.result``), and the broker's event history (``broker.observe``).

The jaxpr lint has no counterpart here (there is no jaxpr), and the protocol
lint over the service's source is not ported yet.

Findings are machine-readable (:class:`Finding`) and fingerprinted without
line numbers, in the same form as the JAX package's, so the two packages'
findings compare directly.
"""
from __future__ import annotations

import dataclasses
import hashlib

PASSES = ("sanitizer",)


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


__all__ = ["PASSES", "Finding"]
