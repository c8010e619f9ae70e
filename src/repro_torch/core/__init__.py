"""Core: the paper's Work-Stealing simulator as composable PyTorch modules.

Engines (paper §3): unified event+processor engine (``engine``) with the
divisible-load task engine (``divisible``), topology engine (``topology``),
simulator engine (``sweep``) over pluggable execution backends (``backend``),
the serial numpy oracle (``oracle``) and array-level constructors
(``interop``).
"""
from repro_torch.core.topology import (  # noqa: F401
    Topology, one_cluster, two_clusters, multi_cluster, tpu_fleet,
    UNIFORM, LOCAL_FIRST, INV_DISTANCE, ROUND_ROBIN, strategy_name,
)
from repro_torch.core import engine  # noqa: F401
from repro_torch.core.engine import TaskModel, resolve_device  # noqa: F401
from repro_torch.core.divisible import (  # noqa: F401
    DivisibleModel, EngineConfig, Scenario, SimResult, make_scenario,
    simulate, simulate_batch, default_max_events,
)
from repro_torch.core.sweep import (  # noqa: F401
    run_grid, run_rows, quick_sim, GridResult, GridRows, make_model, as_model,
)
from repro_torch.core.backend import (  # noqa: F401
    BackendCapabilities, ExecutionBackend, available_backends, backend_names,
    default_backend_name, get_backend, register_backend,
)
from repro_torch.core import interop  # noqa: F401
