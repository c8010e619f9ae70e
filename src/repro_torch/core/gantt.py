"""Log engine (paper §3.5): trace decoding, Gantt chart, Paje + JSON export.

The engine (the plain loop, or the ``ws_sim`` kernel with ``log_trace``)
fills a preallocated int32 trace buffer with rows ``(t, proc, kind, aux)``;
this module turns that buffer into

* per-processor activity intervals (the Gantt chart of Fig 7/8/13),
* a Paje trace file readable by standard trace-analysis tools,
* an ASCII Gantt for terminal inspection,
* a JSON dump of the executed schedule (paper's JSON log, Fig 9 input),
* Chrome-trace/Perfetto events (:func:`to_chrome_events`): the engine's
  *simulated-time* Gantt as its own Perfetto track group, mergeable with
  the service's *wall-time* spans (``repro_torch.obs``) into one timeline —
  ``obs.write_chrome_trace(path, tracer.chrome_events(),
  row_chrome_events(...))`` gives a file with both track groups.
"""
from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import divisible as dv

STATE_RUN = "RUN"
STATE_IDLE = "IDLE"

#: Chrome-trace process id of the simulated-time track group (the service's
#: wall-time spans live on ``obs.HOST_PID``).
SIM_PID = 2
SIM_PROCESS_NAME = "engine (simulated time)"


def _host(x) -> np.ndarray:
    """A numpy array of ``x`` (numpy, or a tensor on any device)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_trace(trace: np.ndarray, n_trace: int, p: int, W: int,
                 makespan: int) -> dict:
    """Reconstruct per-processor RUN intervals + steal arrows from the trace.

    Returns {proc: [(t0, t1), ...]} run intervals and a list of steal arrows
    (t_req, victim, thief, amount_received_at, amount). ``trace`` is a numpy
    array or a tensor on any device, copied to the host once; ``n_trace``
    (an int or a 0-d tensor) is the kernel's saturated count, so a trace cut
    at ``max_trace`` rows decodes as far as it goes.
    """
    trace = _host(trace)[: int(n_trace)]
    runs = {i: [] for i in range(p)}
    arrows = []
    run_start = {0: 0}  # proc 0 starts executing W at t=0
    for t, proc, kind, aux in trace.tolist():
        if kind == dv.EV_IDLE:
            if proc in run_start:
                runs[proc].append((run_start.pop(proc), t))
        elif kind == dv.EV_ANS_OK:
            run_start[proc] = t
            arrows.append({"t": int(t), "thief": int(proc), "amount": int(aux)})
        elif kind == dv.EV_REQ_OK:
            arrows.append({"t": int(t), "victim": int(aux), "thief": int(proc)})
    # close still-running intervals at makespan
    for proc, t0 in run_start.items():
        runs[proc].append((t0, makespan))
    return {"runs": runs, "arrows": arrows}


def ascii_gantt(runs: dict, makespan: int, width: int = 80) -> str:
    """Terminal Gantt chart: '#' while running, '.' while idle."""
    makespan = max(int(makespan), 1)
    lines = []
    for proc in sorted(runs):
        row = ["."] * width
        for t0, t1 in runs[proc]:
            a = int(t0 * width / makespan)
            b = max(int(np.ceil(t1 * width / makespan)), a + 1)
            for k in range(a, min(b, width)):
                row[k] = "#"
        lines.append(f"P{proc:<3d} |{''.join(row)}|")
    lines.append(f"      0{' ' * (width - 12)}t={makespan}")
    return "\n".join(lines)


def to_paje(runs: dict, makespan: int, name: str = "ws") -> str:
    """Minimal Paje trace (header + state changes), paper §3.5 / [12]."""
    out: List[str] = []
    out.append("%EventDef PajeDefineContainerType 1")
    out.append("% Alias string\n% ContainerType string\n% Name string\n%EndEventDef")
    out.append("%EventDef PajeDefineStateType 3")
    out.append("% Alias string\n% ContainerType string\n% Name string\n%EndEventDef")
    out.append("%EventDef PajeCreateContainer 6")
    out.append("% Time date\n% Alias string\n% Type string\n% Container string\n% Name string\n%EndEventDef")
    out.append("%EventDef PajeSetState 10")
    out.append("% Time date\n% Container string\n% Type string\n% Value string\n%EndEventDef")
    out.append('1 CT_Proc 0 "Processor"')
    out.append('3 ST_State CT_Proc "State"')
    events: List[Tuple[float, str]] = []
    for proc in sorted(runs):
        out.append(f'6 0.0 P{proc} CT_Proc 0 "P{proc}"')
        cursor = 0
        for t0, t1 in sorted(runs[proc]):
            if t0 > cursor:
                events.append((float(cursor), f'10 {float(cursor)} P{proc} ST_State "{STATE_IDLE}"'))
            events.append((float(t0), f'10 {float(t0)} P{proc} ST_State "{STATE_RUN}"'))
            events.append((float(t1), f'10 {float(t1)} P{proc} ST_State "{STATE_IDLE}"'))
            cursor = t1
    events.sort(key=lambda e: e[0])
    out.extend(e[1] for e in events)
    return "\n".join(out) + "\n"


def to_chrome_events(decoded: dict, makespan: int, pid: int = SIM_PID,
                     process_name: str = SIM_PROCESS_NAME) -> List[dict]:
    """Chrome-trace events of a decoded engine trace (simulated time).

    One Perfetto thread track per processor: B/E ``RUN`` pairs for its run
    intervals (ts in simulated time units, rendered as µs) plus instant
    events for steal arrows (``steal`` on the thief at answer delivery,
    ``steal_req`` at the granted request). Merge with the service tracer's
    wall-time events via :func:`repro_torch.obs.chrome_trace_doc` — distinct
    pids keep the two time axes in separate track groups.
    """
    events: List[dict] = [{"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": process_name}}]
    runs = decoded["runs"]
    for proc in sorted(runs):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": proc, "args": {"name": f"P{proc}"}})
    for proc in sorted(runs):
        for t0, t1 in sorted(runs[proc]):
            common = dict(cat="engine", pid=pid, tid=int(proc))
            events.append({"ph": "B", "name": STATE_RUN,
                           "ts": float(t0), **common})
            events.append({"ph": "E", "name": STATE_RUN,
                           "ts": float(t1), **common})
    for arrow in decoded["arrows"]:
        thief = int(arrow["thief"])
        name = "steal" if "amount" in arrow else "steal_req"
        events.append({"ph": "i", "name": name, "cat": "engine",
                       "pid": pid, "tid": thief, "ts": float(arrow["t"]),
                       "s": "t", "args": {k: v for k, v in arrow.items()
                                          if k != "t"}})
    return events


def row_chrome_events(trace: np.ndarray, n_trace: int, p: int, W: int,
                      makespan: int, pid: int = SIM_PID,
                      process_name: str = SIM_PROCESS_NAME) -> List[dict]:
    """Decode one traced engine row straight to Chrome-trace events."""
    return to_chrome_events(decode_trace(trace, n_trace, p, W, makespan),
                            makespan, pid=pid, process_name=process_name)


#: Re-exported document helpers so log-engine callers need only this module.
chrome_trace_doc = obs.chrome_trace_doc
write_chrome_trace = obs.write_chrome_trace


def to_json(result, p: int, W: int, extra: Optional[dict] = None) -> str:
    """JSON log of a finished simulation (paper's executed-application dump);
    ``result`` is the port's ``SimResult`` of one row (0-d tensors on any
    device, or numpy)."""
    result = type(result)(*(_host(x) for x in result))
    doc = {
        "W": int(W),
        "p": int(p),
        "makespan": int(result.makespan),
        "n_events": int(result.n_events),
        "n_requests": int(result.n_requests),
        "n_success": int(result.n_success),
        "n_fail": int(result.n_fail),
        "total_idle": int(result.total_idle),
        "startup_end": int(result.startup_end),
        "executed": np.asarray(result.executed).tolist(),
        "overflow": bool(result.overflow),
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2)
