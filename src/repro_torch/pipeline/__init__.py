"""Pipeline-parallel value-and-grad through the scheduler: the port of
``repro.pipeline``.  The schedule emerges from a QuickSched graph
(``qsched_pipeline``); ``exec`` runs it on any backend, the ``engine``
backend through the K9 walk (``kernels/pipe_walk``)."""

from .qsched_pipeline import (PipelineSchedule, build_pipeline_graph,
                              bubble_fraction, lower_pipeline_plan,
                              one_f_one_b_bubble, synthesize_schedule)
from .exec import (dense_stage, mse_loss, pipelined_value_and_grad,
                   pipelined_value_and_grad_plan)
from .convert import pipeline_inputs

__all__ = ["build_pipeline_graph", "synthesize_schedule", "PipelineSchedule",
           "bubble_fraction", "one_f_one_b_bubble", "lower_pipeline_plan",
           "pipelined_value_and_grad", "pipelined_value_and_grad_plan",
           "dense_stage", "mse_loss", "pipeline_inputs"]
