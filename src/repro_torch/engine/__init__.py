"""repro_torch.engine: device-resident ExecutionPlan execution.

Lower a prepared plan into ragged CSR task tables with write-colored
sub-phases (``descriptors``), walk them with the family's CUDA kernel, one
launch per phase (``megakernel``), and drive the whole plan from one call
with the tile stack updated in place (``runner``).  This slice carries the
tiled-QR family; Barnes-Hut and the pipeline walks are still to be ported
(ROADMAP.md).
"""

from .descriptors import (TaskTable, count_host_dispatches, lower_tables,
                          table_from_arrays)
from .megakernel import (QR_ARG_WIDTH, QR_GEQRF, QR_LARFT, QR_NOOP,
                         QR_SSRFT, QR_TSQRF, qr_round_fn, qr_row_access,
                         qr_walk_plain)
from .runner import execute_plan

__all__ = [
    "TaskTable", "lower_tables", "count_host_dispatches",
    "table_from_arrays", "qr_round_fn", "qr_row_access", "qr_walk_plain",
    "execute_plan",
    "QR_GEQRF", "QR_LARFT", "QR_TSQRF", "QR_SSRFT", "QR_NOOP",
    "QR_ARG_WIDTH",
]
