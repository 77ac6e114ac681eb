"""Continuous-batching serving tier on the QuickSched execution stack.

``blockpool`` owns paged cache memory (pages as hierarchical resources,
admission as a conflict round), ``service`` runs the persistent
prefill/decode loop through the core backends, ``traffic`` generates
open-loop synthetic request streams for the serving benchmark, and
``faults`` is the deterministic chaos-injection harness behind the
service's robustness layer (deadlines, preemption with page
reclamation, guarded decode with a degrade ladder — DESIGN.md
§Robustness).

Port note: the port of ``repro.serve``.  As the reference's, the service
takes the dense and MoE families (GQA or MLA attention, paged) and the
SSM family (unpaged, O(1) state), and refuses the hybrid, enc-dec and VLM
families, which serve through ``models.serving`` (the static launcher).
"""

from .blockpool import AdmissionConflict, BlockPool, TT_PREFILL
from .faults import FAULT_KINDS, FaultEvent, FaultPlan
from .service import (DECODE_PATHS, ENG_DECODE, GenerateService, KernelFault,
                      QueueFull, Request, SamplingParams, ServiceStalled,
                      TT_DECODE)
from .traffic import SyntheticRequest, open_loop_trace

__all__ = [
    "AdmissionConflict", "BlockPool", "TT_PREFILL",
    "FAULT_KINDS", "FaultEvent", "FaultPlan",
    "DECODE_PATHS", "ENG_DECODE", "GenerateService", "KernelFault",
    "QueueFull", "Request", "SamplingParams", "ServiceStalled", "TT_DECODE",
    "SyntheticRequest", "open_loop_trace",
]
