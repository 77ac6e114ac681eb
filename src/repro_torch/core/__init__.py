"""QuickSched core: task-based parallelism with dependencies and conflicts.

The port's copy of ``repro.core``: the scheduler, the plan lowering, the
host executors and the backend registry, with nothing of ``repro``
imported.  ``simulator``, ``static_sched`` and ``weights`` are not on the
tiled-QR path and are not ported yet (ROADMAP.md, Queue 1).
"""

from .graph import (
    FLAG_NONE,
    FLAG_VIRTUAL,
    OWNER_NONE,
    RES_NONE,
    TASK_NONE,
    QSched,
    Resource,
    Task,
)
from .arrays import CompiledGraph
from .locks import SeqLockManager, ThreadedLockManager, make_lock_manager
from .plan import (BatchSpec, ExecutionPlan, PlanRound, TypedBatch,
                   clear_plan_cache, color_phases, lower, plan_cache_info)
from .queue import TaskQueue
from .executors import SequentialExecutor, ThreadedExecutor, registry_fun
from .backends import (Backend, BackendUnsupported, EngineHooks,
                       available_backends, get_backend, register_backend,
                       run_plan)

__all__ = [
    "QSched", "Task", "Resource", "TaskQueue", "CompiledGraph",
    "FLAG_NONE", "FLAG_VIRTUAL", "TASK_NONE", "RES_NONE", "OWNER_NONE",
    "SeqLockManager", "ThreadedLockManager", "make_lock_manager",
    "BatchSpec", "ExecutionPlan", "PlanRound", "TypedBatch",
    "lower", "clear_plan_cache", "color_phases", "plan_cache_info",
    "SequentialExecutor", "ThreadedExecutor", "registry_fun",
    "Backend", "BackendUnsupported", "EngineHooks",
    "get_backend", "register_backend", "available_backends", "run_plan",
]
