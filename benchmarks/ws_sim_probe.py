#!/usr/bin/env python3
"""Where an event of the ``ws_sim`` kernel spends its cycles, on the card.

    python3 benchmarks/ws_sim_probe.py [--slots 8 16] [--p P] [--reps 3]
                                       [--out PATH]

Builds ``src/repro_torch/kernels/csrc/ws_sim.cu`` twice — as it ships and
with ``-DWS_SIM_PROBE``, which stamps ``clock64()`` at the end of each phase
of an event (argmin, dispatch, handler, victim selection, commit) and sums
the stamps per row — and runs the chunks that ``chip_smoke.py`` times at
each count of slots a lane named by ``--slots`` (default: the K that
``ws_sim.variant`` picks; a K too small for p is passed over); ``--p P``
runs each chunk on ``one_cluster(P, 1)`` instead of its sweep's topology.
Per chunk and K it prints one JSON line: the shipped kernel's ms (CUDA
events), ns per event on the row with the most events, and that row's
cycles per event by phase from the probe build; then a line with each
kernel instantiation's SASS instruction count (``cuobjdump -sass``) and
what ``-Xptxas -v`` said. Every K's result is held against the first
one's, leaf for leaf. ``--out PATH`` writes the lines to a file too.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("ws_sim_probe.py needs a CUDA device")

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ws_sim as ws  # noqa: E402

PROBE = ("WS_SIM_PROBE",)
#: (main path, sweep, chunk): the chunks chip_smoke.py times — divisible
#: p=256 at lambda=482, the DAG sweep at lambda=62 — and the adaptive chunk
#: at lambda=2, whose longest row sets most of that path's kernel time
TARGETS = (("divisible", 0, 3), ("dag", 0, 2), ("adaptive", 0, 0))


def say(fh, **kw):
    line = json.dumps(kw)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")


def chunk(path: str, sweep: int, index: int, p=None):
    s = cs.MAIN_PATHS[path]["sweeps"][sweep]
    if p is not None:
        s = dict(s, name=f"{s['name']}@p{p}",
                 topo=lambda: cs.T.one_cluster(p, 1))
    kw = s["kw"]
    rows = cs.sw.grid_rows(kw.get("W_list", (0,)), kw["lam_list"], kw["reps"])
    lo = index * kw["chunk_size"]
    c = rows.slice(lo, lo + kw["chunk_size"])
    scn = cs.sw.scenario_from_rows(c, remote_prob=s["topo"]().remote_prob,
                                   device="cuda")
    return s, cs.sweep_model(s), scn, int(c.lam_remote[0])


def time_ms(model, scn, k: int, reps: int) -> float:
    ws._launch(model, scn, k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ws._launch(model, scn, k)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sass_counts() -> dict:
    """Instructions of each kernel function in the shipped library."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build._target("ws_sim"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, nargs="*", default=None)
    ap.add_argument("--p", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    ws._lib()
    ws._lib(PROBE)
    with (args.out.open("w") if args.out else contextlib.nullcontext()) as fh:
        say(fh, phase="start", card=cs.card_line(),
            device=torch.cuda.get_device_name(0),
            clocks=subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
        for path, sweep, index in TARGETS:
            s, model, scn, lam = chunk(path, sweep, index, args.p)
            slots = args.slots
            if slots is None:
                slots = [ws.variant(model.p)[1]]
            first = None
            for k in slots:
                if model.p > 32 * k:
                    continue
                ms = time_ms(model, scn, k, args.reps)
                res = ws._launch(model, scn, k)
                if first is None:
                    first = res
                else:
                    bad = [f for f in res._fields if not torch.equal(
                        getattr(res, f), getattr(first, f))]
                    if bad:
                        raise AssertionError(f"{path} slots={k}: leaves {bad} "
                                             f"differ from slots={slots[0]}")
                probe = torch.zeros((int(scn.W.shape[0]),
                                     len(ws.PROBE_PHASES) + 1),
                                    dtype=torch.int64, device="cuda")
                pres = ws._launch(model, scn, k, probe=probe, defines=PROBE)
                torch.cuda.synchronize()
                ev = res.n_events.to(torch.int64)
                r = int(ev.argmax())
                n = int(ev[r])
                cyc = probe[r].tolist()
                say(fh, phase="probe", path=path, sweep=s["name"], lam=lam,
                    slots=k,
                    p=model.p, rows=int(ev.shape[0]),
                    events=int(ev.sum()), max_row_events=n, ms=ms,
                    ns_per_event_longest_row=ms * 1e6 / n,
                    probe_equal=bool(torch.equal(pres.n_events,
                                                 res.n_events)),
                    cycles_per_event={ph: cyc[q] / n for q, ph in
                                      enumerate(ws.PROBE_PHASES)},
                    loop_cycles_per_event=cyc[-1] / n,
                    loop_cycles=cyc[-1], card=cs.card_line())
        say(fh, phase="sass", instructions=sass_counts(),
            ptxas=[l.strip() for name, log in _build.build_logs.items()
                   for l in log.splitlines()
                   if "registers" in l or "spill" in l or "Function" in l])


if __name__ == "__main__":
    main()
