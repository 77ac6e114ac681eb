"""Multi-pod dry run.  The port of ``repro/launch/dryrun.py``.

For every (architecture × input shape × mesh) cell:
  open torch's ``fake`` process group at the mesh's world size (this
  process plays rank 0 of 256 or 512; a collective moves no data), build
  the full-size step on ``meta`` tensors with the production placements
  (``dist.sharding``; nothing is allocated), run it once, and record per
  device
    * argument / output / alias bytes: rank 0's local shards of the
      parameters, the optimizer state, the batch and the cache (an output
      that is an argument updated in place is an alias),
    * FLOPs, counted on the local shards: ``torch.utils.flop_counter``'s
      formulas applied to the operators each device runs,
    * the collective schedule: counts and operand bytes under the
      reference's five names, from the collectives DTensor issues,
    * the depth extrapolation, as the reference has it (its probes at two
      reduced depths, extrapolated to the full depth).  Eager PyTorch runs
      and counts every layer, so here the full-depth count is exact and
      the extrapolation is held to it (``rel_err``).
  Left out, with the reason in the record (``not_computed``): the peak and
  temporary bytes (a ``meta`` tensor has no allocator to measure) and the
  bytes accessed (no cost model counts them); neither is estimated.

These are predictions over the reference's mesh shapes, not times or
sizes of any device.  ``analyse_step`` is the twin of the reference's
``analyse_compiled``.  Results are written as JSON, one file per cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.sharding import local_nbytes
from repro_torch.optim.tree import leaves

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# operator-name fragments → the reference's collective names
_OP_NAMES = (("reduce_scatter", "reduce-scatter"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
             ("send", "collective-permute"), ("recv", "collective-permute"))

NOT_COMPUTED = {
    "peak_bytes": "meta tensors have no allocator: the live set is not "
                  "measured",
    "temp_bytes": "meta tensors have no allocator: the live set is not "
                  "measured",
    "bytes_accessed_per_device": "no cost model counts the bytes each "
                                 "operator reads and writes",
}


def collective_name(op_name: str) -> Optional[str]:
    """The reference's name of the collective an operator issues, or None
    for an operator that is not a collective (``wait_tensor`` included)."""
    if "c10d" not in op_name and "_dtensor" not in op_name:
        return None
    for frag, name in _OP_NAMES:
        if frag in op_name:
            return name
    return None


def collective_stats(events: List[Tuple[str, int, int]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per-collective op counts and operand / result bytes (per device:
    the events are one device's), from ``(name, operand bytes, result
    bytes)`` events under the reference's names."""
    stats = {c: {"count": 0, "operand_bytes": 0.0, "result_bytes": 0.0}
             for c in _COLLECTIVES}
    for name, operand, result in events:
        stats[name]["count"] += 1
        stats[name]["operand_bytes"] += operand
        stats[name]["result_bytes"] += result
    return stats


def total_collective_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(v["operand_bytes"] for v in stats.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepCounter(TorchDispatchMode):
    """FLOPs and collectives of the operators one device runs.

    A DTensor operator is handed on (``NotImplemented``) to DTensor, which
    redistributes its inputs and runs the operator on the local shards
    with this mode still active, so what is counted is each device's own
    work.  Operators on DTensor's own fake tensors (its shape propagation
    at the global shape) run uncounted.  On plain tensors (a step on one
    device) it counts the whole step.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.events: List[Tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        name = collective_name(str(func))
        if name is not None:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.events.append((name, _nbytes(args[0]),
                                sum(_nbytes(o) for o in outs)))
        return out


@contextlib.contextmanager
def fake_world(size: int):
    """torch's ``fake`` process group as the default group, this process
    rank 0 of ``size``, for the duration of the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -----------------------------------------------------------------------------

def input_specs(cfg, shape_name: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell."""
    from repro_torch.data import batch_specs
    p = SHAPES[shape_name]
    return batch_specs(cfg, p["seq_len"], p["global_batch"], mode=p["kind"])


def depth_variants(cfg) -> Tuple:
    """Two reduced-depth configs preserving family structure, plus the
    per-unit layer count for extrapolation: returns
    (cfg1, cfg2, units1, units2, units_full).  ``scan_layers=False`` as
    the reference's (eager PyTorch runs every layer either way)."""
    cfg = dataclasses.replace(cfg, scan_layers=False)
    fam = cfg.family
    if fam == "moe":
        fd = cfg.first_dense_layers
        c1 = dataclasses.replace(cfg, n_layers=fd + 1)
        c2 = dataclasses.replace(cfg, n_layers=fd + 2)
        return c1, c2, 1, 2, cfg.n_layers - fd
    if fam == "hybrid":
        e = cfg.shared_attn_every
        c1 = dataclasses.replace(cfg, n_layers=e)
        c2 = dataclasses.replace(cfg, n_layers=2 * e)
        return c1, c2, 1, 2, cfg.n_layers / e
    if fam == "encdec":
        c1 = dataclasses.replace(cfg, n_layers=1, enc_layers=1)
        c2 = dataclasses.replace(cfg, n_layers=2, enc_layers=2)
        return c1, c2, 1, 2, cfg.n_layers  # enc and dec scale together
    c1 = dataclasses.replace(cfg, n_layers=1)
    c2 = dataclasses.replace(cfg, n_layers=2)
    return c1, c2, 1, 2, cfg.n_layers


def skip_reason(cfg, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 500k decode needs sub-quadratic "
                "attention (DESIGN.md §Arch-applicability)")
    return None


def build_cell(cfg, shape: Union[str, Dict[str, Any]], mesh,
               multi_pod: bool):
    """Returns (step function, its arguments (DTensors on ``meta``, placed
    with the production shardings), a description).  ``shape`` is a name
    in ``SHAPES`` or a dict like its entries (``seq_len``,
    ``global_batch``, ``kind``)."""
    from repro_torch.data import batch_specs
    from repro_torch.dist.sharding import (batch_pspecs, cache_pspecs,
                                           opt_pspecs, param_pspecs, place,
                                           shardings_for)
    from repro_torch.models import lm, serving
    from repro_torch.optim import default_optimizer_for, make_optimizer
    from repro_torch.trainer.steps import (make_prefill_step, make_serve_step,
                                           make_train_step)

    p = SHAPES[shape] if isinstance(shape, str) else shape
    kind = p["kind"]
    param_shapes = lm.param_shapes(cfg)
    pspecs = param_pspecs(param_shapes, mesh, multi_pod)
    params = place(param_shapes, shardings_for(pspecs, mesh))

    if kind == "train":
        opt_name = default_optimizer_for(cfg)
        train_step, _ = make_train_step(cfg, optimizer=opt_name)
        opt_init, _ = make_optimizer(opt_name, 0.0)
        opt_shapes = opt_init(param_shapes)
        opt = place(opt_shapes, shardings_for(
            opt_pspecs(pspecs, opt_shapes, mesh), mesh))
        bspecs = batch_specs(cfg, p["seq_len"], p["global_batch"], "train")
        batch = place(bspecs, shardings_for(
            batch_pspecs(bspecs, mesh, multi_pod), mesh))
        return train_step, (params, opt, batch), {"optimizer": opt_name}

    if kind == "prefill":
        bspecs = batch_specs(cfg, p["seq_len"], p["global_batch"], "prefill")
        batch = place(bspecs, shardings_for(
            batch_pspecs(bspecs, mesh, multi_pod), mesh))
        return make_prefill_step(cfg), (params, batch), {}

    # decode
    cache_shapes = serving.init_cache(cfg, p["global_batch"], p["seq_len"],
                                      torch.device("meta"))
    cache = place(cache_shapes, shardings_for(
        cache_pspecs(cache_shapes, cfg, mesh, multi_pod), mesh))
    io = batch_specs(cfg, p["seq_len"], p["global_batch"], "decode")
    io = place(io, shardings_for(batch_pspecs(io, mesh, multi_pod), mesh))
    return (make_serve_step(cfg), (params, cache, io["tokens"], io["pos"]),
            {})


def analyse_step(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``CommDebugMode`` and the per-device
    :class:`StepCounter`; the per-device record (the twin of the
    reference's ``analyse_compiled``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    arg_leaves = leaves(args)
    with CommDebugMode() as comm, StepCounter() as counter:
        out = fn(*args)
    out_leaves = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
    held = {id(t) for t in arg_leaves}
    colls = collective_stats(counter.events)
    return {
        "flops_per_device": float(counter.flops),
        "memory": {
            "argument_bytes": sum(local_nbytes(t) for t in arg_leaves),
            "output_bytes": sum(local_nbytes(t) for t in out_leaves),
            "alias_bytes": sum(local_nbytes(t) for t in out_leaves
                               if id(t) in held),
        },
        "collectives": colls,
        "collective_operand_bytes_per_device": total_collective_bytes(colls),
        "comm_debug_counts": {str(k): v for k, v
                              in comm.get_comm_counts().items()},
    }


def mesh_device_type() -> str:
    """The device type of the dry run's meshes (their shards are ``meta``
    tensors either way): ``cuda`` where torch has it, else ``cpu``, on
    which DTensor lowers a shard-to-shard redistribution (an all-to-all)
    to an all-gather and a local chunk, so it is counted as an all-gather
    of the same operand bytes."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(mesh_kind: str):
    """The reference's production mesh of ``mesh_kind`` ("single" or
    "multi") over the open world."""
    from repro_torch.launch.mesh import make_production_mesh
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device_type=mesh_device_type())


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str, extrapolate: bool = True,
             act_shard: bool = False) -> Dict[str, Any]:
    from repro_torch.configs import get_config
    from repro_torch.dist.act_sharding import activation_sharding

    multi_pod = mesh_kind == "multi"
    cfg = get_config(arch)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": 512 if multi_pod else 256,
        "seq_len": SHAPES[shape_name]["seq_len"],
        "global_batch": SHAPES[shape_name]["global_batch"],
        "kind": SHAPES[shape_name]["kind"],
        "mesh_device_type": mesh_device_type(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        return _save(rec, out_dir)

    dp = ("pod", "data") if multi_pod else "data"

    def ctx_factory():
        return (activation_sharding(dp, "model") if act_shard
                else contextlib.nullcontext())

    rec["act_shard"] = act_shard
    try:
        with fake_world(rec["chips"]):
            mesh = make_mesh(mesh_kind)
            t0 = time.time()
            fn, args, meta = build_cell(cfg, shape_name, mesh, multi_pod)
            rec["build_seconds"] = round(time.time() - t0, 1)
            t1 = time.time()
            with ctx_factory():
                rec["full"] = analyse_step(fn, args)
            rec["run_seconds"] = round(time.time() - t1, 1)
            del fn, args
            rec.update(meta)
            rec["not_computed"] = dict(NOT_COMPUTED)
            if extrapolate:
                with ctx_factory():
                    rec["extrapolated"] = _depth_extrapolate(
                        cfg, shape_name, mesh, multi_pod)
                full = rec["full"]["flops_per_device"]
                rec["extrapolated"]["rel_err_flops"] = (
                    abs(rec["extrapolated"]["flops_per_device"] - full)
                    / full if full else None)
        rec["status"] = "ok"
    except Exception as e:  # record the failure — these are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _save(rec, out_dir)


def _depth_extrapolate(cfg, shape_name, mesh, multi_pod) -> Dict[str, Any]:
    """Per-layer delta from two reduced-depth runs, extrapolated to the
    full depth (the reference's correction for a scanned body counted
    once; here every layer is counted, so it is held to the full count)."""
    c1, c2, u1, u2, u_full = depth_variants(cfg)
    out = {}
    for label, c in (("d1", c1), ("d2", c2)):
        fn, args, _ = build_cell(c, shape_name, mesh, multi_pod)
        a = analyse_step(fn, args)
        out[label] = {
            "flops": a["flops_per_device"],
            "coll_bytes": a["collective_operand_bytes_per_device"],
        }
    du = u2 - u1
    scale = (u_full - u2) / du
    flops = out["d2"]["flops"] + (out["d2"]["flops"] - out["d1"]["flops"]) * scale
    coll = out["d2"]["coll_bytes"] + (
        out["d2"]["coll_bytes"] - out["d1"]["coll_bytes"]) * scale
    return {
        "probe": out, "units_full": u_full,
        "flops_per_device": flops,
        "collective_operand_bytes_per_device": coll,
    }


def _save(rec: Dict[str, Any], out_dir: str) -> Dict[str, Any]:
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(
        out_dir, f"{rec['mesh']}_{rec['arch']}_{rec['shape']}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        mem = rec["full"]["memory"]
        extra = (f" flops/dev={rec['full']['flops_per_device']:.3e}"
                 f" args={mem['argument_bytes'] / 2**30:.2f}GiB"
                 f" coll={rec['full']['collective_operand_bytes_per_device'] / 2**20:.1f}MiB"
                 f" ({rec.get('build_seconds', 0)}s build,"
                 f" {rec.get('run_seconds', 0)}s run)")
    elif status == "error":
        extra = " " + rec["error"][:160]
    print(f"[{status}] {rec['mesh']}/{rec['arch']}/{rec['shape']}{extra}",
          flush=True)
    return rec


def main() -> None:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-extrapolate", action="store_true")
    ap.add_argument("--act-shard", action="store_true",
                    help="activation sharding constraints "
                         "(dist.activation_sharding) around each step")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    n_ok = n_err = n_skip = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                fn = os.path.join(args.out, f"{mesh_kind}_{arch}_{shape}.json")
                if args.skip_existing and os.path.exists(fn):
                    with open(fn) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[cached] {mesh_kind}/{arch}/{shape}")
                            continue
                rec = run_cell(arch, shape, mesh_kind, args.out,
                               extrapolate=not args.no_extrapolate,
                               act_shard=args.act_shard)
                n_ok += rec["status"] == "ok"
                n_err += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
