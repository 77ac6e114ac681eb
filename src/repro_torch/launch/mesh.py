"""Production mesh construction.  The port of ``repro/launch/mesh.py``.

FUNCTIONS (not module-level constants), so importing this module opens no
process group and touches no device.  A mesh builds over whatever world
is open: the ``fake`` process group for the dry run (``launch/dryrun.py``,
no device, ``meta`` shards), gloo ranks for the CPU tests, NCCL on the
card.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production meshes: 16×16 = 256 devices a pod
    (``("data", "model")``), 2 pods = 512 multi-pod (``"pod"`` added in
    front).  The open world's size must be the mesh's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small ``("data", "model")`` mesh over the open world (tests,
    examples, one card)."""
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
