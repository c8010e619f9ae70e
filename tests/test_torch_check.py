"""The port's checker suite (``repro_torch.check``) on the CPU: the protocol
lint runs clean over the port's own tree (no baseline), every seeded
violation gives the rule and symbol that the JAX package's lint gives on the
same source, and the baseline gate and the CLI behave as the JAX package's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.check import protocol_lint as jlint
from repro_torch.check import (BASELINE_REL, PASSES, Finding,
                               default_baseline_path, load_baseline,
                               protocol_lint, run_all, run_pass,
                               split_against_baseline, write_baseline)

ROOT = Path(__file__).resolve().parents[1]
FAKE = "src/repro_torch/service/fake.py"
JFAKE = "src/repro/service/fake.py"

#: seeded violations (the JAX package's own snippets): rule -> source
BAD = {
    "lock.unlock_path": (
        "def f(store, key):\n"
        "    if store.try_lock(key):\n"
        "        work()\n"
        "        store.unlock(key)\n"),
    "lock.heartbeat_before_dispatch": (
        "def g(self, owned, buckets):\n"
        "    while True:\n"
        "        for b in buckets:\n"
        "            self._dispatch_bucket(b, owned)\n"),
    "store.atomic_write": (
        "def save(path, blob):\n"
        "    with open(path, 'wb') as f:\n"
        "        f.write(blob)\n"),
    "resilience.retry_nonrecoverable": (
        "def h():\n"
        "    for attempt in range(3):\n"
        "        try:\n"
        "            op()\n"
        "        except ValueError:\n"
        "            continue\n"),
    "socket.close_path": (
        "def serve(self):\n"
        "    conn, _ = self._sock.accept()\n"
        "    handle(conn)\n"),
    "socket.close_path(dial)": (
        "def dial(path):\n"
        "    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)\n"
        "    s.connect(path)\n"
        "    s.close()\n"),
    "imports.shadow": "import analysis\n",
    "imports.shadow(from)": "from check import sanitizer\n",
}

#: the same shapes written right: both lints find nothing
GOOD = {
    "lock": (
        "def f(store, keys):\n"
        "    owned = [k for k in keys if store.try_lock(k)]\n"
        "    try:\n"
        "        work()\n"
        "    finally:\n"
        "        for k in owned:\n"
        "            store.unlock(k)\n"),
    "heartbeat": (
        "def g(self, owned, buckets):\n"
        "    while True:\n"
        "        for key in owned:\n"
        "            self.store.heartbeat(key)\n"
        "        for b in buckets:\n"
        "            self._dispatch_bucket(b, {})\n"),
    "atomic_write": (
        "def _write_atomic(path, writer):\n"
        "    with open(path, 'wb') as f:\n"
        "        writer(f)\n"
        "def _put(self, path, arrs):\n"
        "    self._write_atomic(path, lambda f: np.savez_compressed(f))\n"),
    "retry": BAD["resilience.retry_nonrecoverable"].replace("continue",
                                                            "raise"),
    "sockets": (
        "def serve(self):\n"
        "    conn, _ = self._sock.accept()\n"
        "    try:\n"
        "        handle(conn)\n"
        "    finally:\n"
        "        conn.close()\n"
        "def dial(path):\n"
        "    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)\n"
        "    try:\n"
        "        s.connect(path)\n"
        "    except BaseException:\n"
        "        s.close()\n"
        "        raise\n"
        "    return s\n"
        "def bind(self):\n"
        "    self._sock = socket.socket(socket.AF_UNIX)\n"
        "def probe(path):\n"
        "    s = socket.create_connection(path)\n"
        "    with contextlib.closing(s):\n"
        "        s.sendall(b'ping')\n"),
    "imports": ("from repro_torch.core import analysis\n"
                "from repro_torch import check\n"),
}


def _rule_symbols(findings):
    return sorted((f.rule, f.symbol) for f in findings)


# ---------------------------------------------------------------------------
# the lint is clean on the port's tree, with no baseline
# ---------------------------------------------------------------------------

def test_protocol_pass_clean_on_the_ports_tree():
    assert protocol_lint.run() == []
    assert run_pass("protocol") == []
    assert not (ROOT / BASELINE_REL).exists()
    assert default_baseline_path() == ROOT / "artifacts" / "check" / \
        "baseline_torch.json"
    assert load_baseline(default_baseline_path()) == {}


def test_the_lint_reads_every_file_of_the_ports_tree(monkeypatch):
    seen = []
    real = protocol_lint.lint_source

    def spy(src, filename):
        seen.append(filename)
        return real(src, filename)

    monkeypatch.setattr(protocol_lint, "lint_source", spy)
    protocol_lint.run()
    for rel in ("service/daemon.py", "service/client.py", "service/wire.py",
                "service/store.py", "service/broker.py", "core/engine.py"):
        assert f"src/repro_torch/{rel}" in seen, rel
    assert not [f for f in seen if not f.startswith("src/repro_torch/")]


def test_finding_fingerprint_is_line_stable():
    a = Finding("protocol", "r", "src/x.py:10", "f", "m")
    b = Finding("protocol", "r", "src/x.py:99", "f", "m")
    c = Finding("protocol", "r", "src/y.py:10", "f", "m")
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()


# ---------------------------------------------------------------------------
# seeded violations: the rule and symbol of the JAX package's lint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BAD))
def test_seeded_violation_is_flagged_as_the_jax_lint_flags_it(name):
    src = BAD[name]
    got = protocol_lint.lint_source(src, FAKE)
    want = jlint.lint_source(src, JFAKE)
    assert name.split("(")[0] in {f.rule for f in got}
    assert _rule_symbols(got) == _rule_symbols(want)
    assert [f.where.replace("repro_torch", "repro") for f in got] == \
        [f.where for f in want]


@pytest.mark.parametrize("name", sorted(GOOD))
def test_clean_source_passes_both_lints(name):
    assert protocol_lint.lint_source(GOOD[name], FAKE) == []
    assert jlint.lint_source(GOOD[name], JFAKE) == []


@pytest.mark.parametrize("rule", ["store.atomic_write", "socket.close_path"])
def test_service_rules_do_not_apply_outside_the_service_tree(rule):
    src = BAD[rule]
    assert rule in {f.rule for f in protocol_lint.lint_source(src, FAKE)}
    assert protocol_lint.lint_source(src, "src/repro_torch/core/fake.py") \
        == []


def test_import_shadow_names_the_ports_modules():
    (f,) = protocol_lint.lint_source("import analysis\n",
                                     "src/repro_torch/core/fake.py")
    assert "import repro_torch.core.analysis explicitly" in f.message
    (f,) = protocol_lint.lint_source("import check\n",
                                     "src/repro_torch/core/fake.py")
    assert "import repro_torch.check explicitly" in f.message


def test_the_lint_guards_the_daemons_sockets():
    """The daemon's accepted connections and the client's sockets are the
    code ``socket.close_path`` exists for: drop a release and it fires."""
    pkg = ROOT / "src" / "repro_torch" / "service"
    daemon = (pkg / "daemon.py").read_text()
    cut = daemon.replace("            except BaseException:         # handler "
                         "never took ownership\n                conn.close()\n",
                         "            except BaseException:\n")
    assert cut != daemon
    assert _rule_symbols(protocol_lint.lint_source(
        cut, "src/repro_torch/service/daemon.py")) == \
        [("socket.close_path", "_accept_loop")]
    client = (pkg / "client.py").read_text()
    cut = client.replace("        except BaseException:\n"
                         "            sock.close()\n            raise\n",
                         "        except BaseException:\n            raise\n")
    assert cut != client
    assert _rule_symbols(protocol_lint.lint_source(
        cut, "src/repro_torch/service/client.py")) == \
        [("socket.close_path", "_connect")]


# ---------------------------------------------------------------------------
# store-key purity
# ---------------------------------------------------------------------------

def test_key_purity_check_canonical():
    dirty = {"kind": "X", "backend": "torch"}
    got = protocol_lint.check_canonical(dirty, symbol="t")
    assert [f.rule for f in got] == ["keys.purity"]
    assert "forbidden" in got[0].message
    unknown = {"kind": "X", "wibble": 1}
    got = protocol_lint.check_canonical(unknown, symbol="t")
    assert [f.rule for f in got] == ["keys.purity"]
    assert "whitelist" in got[0].message


def test_key_purity_over_one_model_of_each_kind():
    names = [n for n, _ in protocol_lint.tiny_models()]
    assert names == ["divisible", "dag", "adaptive"]
    assert protocol_lint.purity_findings() == []


# ---------------------------------------------------------------------------
# CLI / baseline plumbing
# ---------------------------------------------------------------------------

def test_baseline_gate_roundtrip(tmp_path):
    f = Finding("protocol", "unit.rule", "src/x.py:3", "f", "seeded")
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "findings": []}))
    new, known = split_against_baseline([f], load_baseline(base))
    assert new == [f] and known == []
    write_baseline([f], base)
    new, known = split_against_baseline([f], load_baseline(base))
    assert new == [] and known == [f]
    # moving the finding to another line keeps it baselined
    moved = Finding("protocol", "unit.rule", "src/x.py:99", "f", "seeded")
    new, known = split_against_baseline([moved], load_baseline(base))
    assert new == [] and known == [moved]


def test_passes_and_unknown_pass():
    assert PASSES == ("dispatch", "protocol", "sanitizer")
    with pytest.raises(ValueError, match="unknown check pass"):
        run_pass("jaxpr")


def test_every_pass_runs_clean_on_the_cpu_when_asked():
    """``device`` reaches the sanitizer's workload (None is the card)."""
    assert run_all(device="cpu") == []


def test_cli_protocol_pass_exits_0(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--pass", "protocol",
         "--json", str(tmp_path / "f.json")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "check[protocol]: 0 finding(s)" in out.stdout
    doc = json.loads((tmp_path / "f.json").read_text())
    assert doc == {"passes": ["protocol"], "findings": []}
    assert not (ROOT / BASELINE_REL).exists()
