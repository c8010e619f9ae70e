"""Simulator-driven scheduling: the planner that picks a work-stealing
policy for a fleet through the sweep service's query path."""
from repro_torch.sched.planner import (  # noqa: F401
    PlannerDecision, default_service, plan, plan_for_mesh,
)
