"""Core: the paper's Work-Stealing simulator as composable PyTorch modules.

Engines (paper §3): unified event+processor engine (``engine``) with three
task engines (``divisible``, ``dag`` + its generators ``dag_gen``,
``adaptive``), topology engine (``topology``),
log engine (``gantt``), simulator engine (``sweep``) over pluggable execution
backends (``backend``) with the segmented loop of ``engine``, analysis layer
(``analysis``), the serial numpy oracle (``oracle``) and array-level
constructors (``interop``).
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
from repro_torch.core.engine import (  # noqa: F401
    SegmentStats, SegmentedRun, default_segment_len, simulate_segmented,
)
from repro_torch.core.dag import (  # noqa: F401
    DagEngineConfig, DagModel, DagSimResult, simulate_dag, simulate_dag_batch,
)
from repro_torch.core.adaptive import (  # noqa: F401
    AdaptiveEngineConfig, AdaptiveModel, AdaptiveSimResult, simulate_adaptive,
    simulate_adaptive_batch,
)
from repro_torch.core import dag_gen  # noqa: F401
from repro_torch.core.dag_gen import TaskDag  # noqa: F401
from repro_torch.core.sweep import (  # noqa: F401
    run_grid, run_rows, quick_sim, GridResult, GridRows, make_model, as_model,
)
from repro_torch.core.backend import (  # noqa: F401
    BackendCapabilities, ExecutionBackend, available_backends, backend_names,
    default_backend_name, get_backend, register_backend,
)
from repro_torch.core import interop  # noqa: F401
from repro_torch.core import analysis  # noqa: F401
