"""Sweep service: content-addressed result store + store-backed resumable
sweeps on top of the batched core.

Repeated questions are cache hits forever (``store``, with size-based GC,
advisory per-key locks and a manifest for fleet-shared tiers); every
registered execution backend (``repro_torch.core.backend``: oracle / torch /
cuda) is bit-identical, so cached answers are backend-free.
``api.SimulationService`` is the facade callers use; its query path (broker
and estimators) is not ported yet.
"""
from repro_torch.service.api import SimulationService  # noqa: F401
from repro_torch.service.resilience import (  # noqa: F401
    At, FaultPlan, FaultSpec, InjectedFault, Prob, RetryPolicy, fault_plan,
    fault_point, install, no_faults,
)
from repro_torch.service.store import (  # noqa: F401
    ResultStore, chunk_key, model_digest, query_key,
)
