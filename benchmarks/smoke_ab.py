"""Alternated A/B of ``chip_smoke.py``'s end-to-end numbers across checkouts
and phase orders.

Each arm runs named phases of one checkout's ``chip_smoke.py`` in a fresh
process; the arms alternate round by round (A B C, then C B A, ...), and
one JSON line a run gives the language-model path's decode and prefill
walls and the query path's cold and warm rates, so that a drop between two
proof runs can be told apart from the host's spread within one machine::

    python3 benchmarks/smoke_ab.py --arm NAME=DIR:PHASE,PHASE ... \\
        [--rounds 2] [--out DIR]

Phases run in the order given: ``paths`` (the store-backed main-path
sweeps), ``query`` (the query path; needs ``paths`` before it), ``lint``,
``benches``, ``lm`` (the language-model main path), ``lm_moe``
(mixtral-8x7b at full width), ``lm_recurrent`` (xlstm-350m,
jamba-v0.1-52b and phi3-mini-3.8b at full width), ``lm_encdec``
(whisper-large-v3 and internvl2-76b at full width) and ``lm_train``
(qwen3-1.7b trained at full width: ms a steady step, tokens/s, the
checkpoint's save and load seconds). Each run first
builds its checkout's kernels (cached in that checkout's ``build/``). A
checkout's ``chip_smoke.py`` must define the phases its arm names. Needs a
card; ``--out`` keeps each run's full output.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

#: the program each run executes: argv = (checkout, phases)
CHILD = r"""
import importlib.util, json, sys, tempfile, time
from pathlib import Path
tree, phases = Path(sys.argv[1]).resolve(), sys.argv[2].split(",")
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              tree / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
cs._build.build_all()
cs.ws._lib()
with tempfile.TemporaryDirectory(prefix="smoke_ab_") as tmp:
    tmp = Path(tmp)
    for ph in phases:
        t0 = time.perf_counter()
        if ph == "paths":
            for path in cs.MAIN_PATHS:
                cs.drive_path(tmp / path, path)
        elif ph == "query":
            cs.phase_query_main_path(tmp / "query", tmp)
        elif ph in ("lint", "benches"):
            (tmp / ph).mkdir()
            getattr(cs, "phase_" + ph)(tmp / ph)
        elif ph == "lm":
            cs.phase_lm_main_path()
        elif ph == "lm_moe":
            cs.phase_lm_moe()
        elif ph == "lm_recurrent":
            cs.phase_lm_recurrent()
        elif ph == "lm_encdec":
            cs.phase_lm_encdec()
        elif ph == "lm_train":
            cs.phase_lm_train()
        else:
            raise SystemExit("unknown phase " + ph)
        print(json.dumps({"phase": "smoke_ab", "ran": ph,
                          "seconds": time.perf_counter() - t0}), flush=True)
"""

#: what a run reports from the lines of its phases
DECODE_KEYS = ("wall_seconds", "tokens_per_second", "warmup_seconds",
               "capture_seconds", "ms_per_replayed_step",
               "eager_loop_ms_per_step")


#: what a run reports from phase lm_train's step and checkpoint lines
TRAIN_KEYS = ("steady_step_ms", "tokens_per_second", "peak_gib",
              "save_seconds", "load_seconds")


def summarize(lines: list) -> dict:
    """The end-to-end numbers among a run's JSON lines."""
    out: dict = {"phase_seconds": {}}
    for line in lines:
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") == "smoke_ab":
            out["phase_seconds"][d["ran"]] = d["seconds"]
        elif d.get("path") in ("serve.decode_batch",
                               "serve.prefill_and_greedy_steps"):
            key = {"lm_moe": "moe_decode",
                   "lm_recurrent": f"{d.get('arch')} decode",
                   "lm_encdec": f"{d.get('arch')} decode"}.get(
                       d["phase"], "decode")
            out[key] = {k: d.get(k) for k in DECODE_KEYS}
        elif d.get("path") == "steps.build_prefill_step":
            key = {"lm_moe": "moe_prefill",
                   "lm_recurrent": f"{d.get('arch')} prefill",
                   "lm_encdec": f"{d.get('arch')} prefill"}.get(
                       d["phase"], "prefill")
            out[f"{key}_wall_seconds"] = d["wall_seconds"]
        elif d.get("phase") == "lm_train" and d.get("path") in (
                "fault.run_training", "checkpoint"):
            for k in TRAIN_KEYS:
                if k in d:
                    out[f"train_{k}"] = d[k]
        elif d.get("step") == "parity_and_rate":
            out["query_per_second"] = d["queries_per_second"]
            out["query_per_second_without_replay"] = \
                d["queries_per_second_without_replay"]
    return out


def parse_arm(text: str) -> tuple:
    name, rest = text.split("=", 1)
    tree, phases = rest.rsplit(":", 1)
    return name, Path(tree).resolve(), phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", action="append", required=True, type=parse_arm,
                    help="NAME=CHECKOUT:PHASE,PHASE")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for each run's full output")
    args = ap.parse_args(argv)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        sys.exit("smoke_ab.py needs a card: nvidia-smi is not here")
    failed = 0
    for r in range(args.rounds):
        arms = args.arm if r % 2 == 0 else args.arm[::-1]
        for name, tree, phases in arms:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, str(tree), phases], cwd=tree,
                capture_output=True, text=True, timeout=1800)
            if args.out is not None:
                (args.out / f"{name}_round{r}.log").write_text(
                    proc.stdout + proc.stderr)
            failed += proc.returncode != 0
            print(json.dumps({
                "arm": name, "round": r, "phases": phases,
                "exit_code": proc.returncode,
                "process_seconds": time.perf_counter() - t0,
                "card": card.strip(),
                **summarize(proc.stdout.splitlines())}), flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
