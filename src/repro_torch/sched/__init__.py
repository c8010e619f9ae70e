"""Simulator-driven scheduling: the planner that picks a work-stealing
policy for a fleet through the sweep service's query path, and the host
scheduler that applies it (``ws_scheduler``)."""
from repro_torch.sched.planner import (  # noqa: F401
    PlannerDecision, default_service, plan, plan_for_mesh,
)
from repro_torch.sched.ws_scheduler import (  # noqa: F401
    SchedulerStats, WorkItem, WorkStealingScheduler, straggler_rebalance,
)
