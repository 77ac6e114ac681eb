"""repro_torch.engine: device-resident ExecutionPlan execution.

Lower a prepared plan into ragged CSR task tables with write-colored
sub-phases (``descriptors``), walk them with the family's CUDA kernel
(``megakernel``), and drive the whole plan from one call with the state
updated in place (``runner``).  All three families are ported: the tiled
QR and the pipeline F/B/U walks each take a whole plan in one cooperative
launch, Barnes-Hut launches once per launch group
(``descriptors.launch_groups``).  ``measure_round_times`` times a plan
round by round (and item by item) for the simulator's replay.
"""

from .descriptors import (LaunchGroups, TaskTable, count_host_dispatches,
                          launch_groups, lower_tables, table_from_arrays)
from .megakernel import (BH_ARG_WIDTH, BH_COM_INNER, BH_COM_LEAF,
                         BH_MAX_CHILDREN, BH_NOOP, BH_PC, BH_PP, BH_SELF,
                         PIPE_ARG_WIDTH, PIPE_B, PIPE_F,
                         PIPE_LAUNCHES_PER_PLAN, PIPE_NOOP, PIPE_U,
                         QR_ARG_WIDTH, QR_GEQRF, QR_LARFT,
                         QR_LAUNCHES_PER_PLAN, QR_NOOP, QR_SSRFT, QR_TSQRF,
                         bh_round_fn, bh_row_access, bh_row_keys,
                         bh_walk_plain, check_qr_table, pipe_round_fn,
                         pipe_row_access, pipe_walk_plain, qr_round_fn,
                         qr_row_access, qr_walk_plain)
from .runner import (ENGINE_DISPATCHES_PER_PLAN, Phases, RoundTimings,
                     execute_plan, measure_round_times, upload_phases)

__all__ = [
    "TaskTable", "LaunchGroups", "lower_tables", "launch_groups",
    "count_host_dispatches", "table_from_arrays",
    "qr_round_fn", "qr_row_access", "qr_walk_plain", "check_qr_table",
    "bh_round_fn", "bh_row_access", "bh_row_keys", "bh_walk_plain",
    "pipe_round_fn", "pipe_row_access", "pipe_walk_plain",
    "execute_plan", "Phases", "upload_phases",
    "ENGINE_DISPATCHES_PER_PLAN", "RoundTimings", "measure_round_times",
    "QR_GEQRF", "QR_LARFT", "QR_TSQRF", "QR_SSRFT", "QR_NOOP",
    "QR_ARG_WIDTH", "QR_LAUNCHES_PER_PLAN",
    "BH_COM_LEAF", "BH_COM_INNER", "BH_SELF", "BH_PP", "BH_PC", "BH_NOOP",
    "BH_ARG_WIDTH", "BH_MAX_CHILDREN",
    "PIPE_F", "PIPE_B", "PIPE_U", "PIPE_NOOP", "PIPE_ARG_WIDTH",
    "PIPE_LAUNCHES_PER_PLAN",
]
