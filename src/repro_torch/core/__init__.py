"""QuickSched core: task-based parallelism with dependencies and conflicts.

The port's copy of ``repro.core``: the scheduler, the plan lowering, the
host executors, the backend registry and the discrete-event simulator
(which the pipeline's schedule synthesis runs on), the static
conflict rounds (``static_sched``) and the critical-path weights
(``weights``), with nothing of ``repro`` imported.
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
from .simulator import (SimResult, TimelineEvent, replay_item_times,
                        replay_round_times, scaling_curve, simulate)
from .static_sched import Round, conflict_rounds, list_schedule, validate_rounds
from .weights import critical_path_length, critical_path_weights, toposort
from .executors import SequentialExecutor, ThreadedExecutor, registry_fun
from .backends import (Backend, BackendUnsupported, EngineHooks,
                       available_backends, get_backend, register_backend,
                       run_plan)

__all__ = [
    "QSched", "Task", "Resource", "TaskQueue", "CompiledGraph",
    "FLAG_NONE", "FLAG_VIRTUAL", "TASK_NONE", "RES_NONE", "OWNER_NONE",
    "SeqLockManager", "ThreadedLockManager", "make_lock_manager",
    "SimResult", "TimelineEvent", "simulate", "scaling_curve",
    "replay_round_times", "replay_item_times",
    "Round", "conflict_rounds", "validate_rounds", "list_schedule",
    "BatchSpec", "ExecutionPlan", "PlanRound", "TypedBatch",
    "lower", "clear_plan_cache", "color_phases", "plan_cache_info",
    "toposort", "critical_path_weights", "critical_path_length",
    "SequentialExecutor", "ThreadedExecutor", "registry_fun",
    "Backend", "BackendUnsupported", "EngineHooks",
    "get_backend", "register_backend", "available_backends", "run_plan",
]
