"""Sweep service: query broker + content-addressed result store + adaptive
Monte-Carlo estimation on top of the batched core.

The simulator engine answers questions; this package serves them: repeated
questions are cache hits forever (``store``, with size-based GC, advisory
per-key locks for cross-process in-flight dedup, and a manifest for
fleet-shared tiers), concurrent questions coalesce into shared kernel
launches — across ``max_events`` caps and onto any registered execution
backend (``broker`` + ``repro_torch.core.backend``: oracle / torch / cuda,
all bit-identical, so cached answers are backend-free and shared with the
JAX package's store) — and every estimate carries a statistical guarantee —
mean CIs, streaming P² quantile CIs, or paired common-random-numbers A/B
verdicts — with replication driven by a precision target instead of a
fixed rep count (``estimator``). Failed dispatches heal by retry, bisection
salvage and, on the CPU only, demotion to a bit-identical backend
(``resilience``). ``api.SimulationService`` is the facade callers use;
``daemon.SimulationDaemon`` serves it to other processes over a unix socket
(the JAX package's wire protocol) and ``client.DaemonClient`` asks it,
answering in-process when no daemon is listening.
"""
from repro_torch.service.api import SimulationService  # noqa: F401
from repro_torch.service.client import (  # noqa: F401
    DaemonClient, DaemonUnavailable, WireQuery,
)
from repro_torch.service.daemon import (  # noqa: F401
    PROTOCOL_VERSION, SimulationDaemon, default_socket_path,
)
from repro_torch.service.resilience import (  # noqa: F401
    At, CircuitBreaker, FaultPlan, FaultSpec, InjectedFault, Prob,
    ResilienceConfig, RetryPolicy, fallback_chain, fault_plan, fault_point,
    install, no_faults,
)
from repro_torch.service.broker import (  # noqa: F401
    PairedQuery, PairedResult, QueryBroker, QueryResult, SimQuery,
)
from repro_torch.service.estimator import (  # noqa: F401
    AdaptivePolicy, CellTable, P2Quantiles, PairedCells, PairedPolicy,
    QuantilePolicy, Welford, paired_summary, summarize_cells, z_value,
)
from repro_torch.service.store import (  # noqa: F401
    ResultStore, chunk_key, model_digest, query_key,
)
