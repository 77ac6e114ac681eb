"""repro_torch: the QuickSched reproduction on PyTorch and CUDA (Hopper).

A second package beside ``repro`` (the JAX/Pallas reference), with the
same subpackage layout and module names so each module's counterpart is
easy to find.  It imports ``torch`` and numpy, never ``jax`` and nothing
of ``repro``.  Inside, it uses PyTorch idiom: plain functions on tensors,
an explicit ``device``, and in-place updates of the state (the QR tile
stack, the Barnes-Hut accelerations) where the reference rebuilt
immutable arrays.  Ported so far: the scheduler core and the device
engine (``core``, ``engine``), the tiled QR (``apps.qr``), the Barnes-Hut
tree code (``apps.barneshut``), the pipeline (``pipeline``), the
model stack of every family the reference runs (dense, MoE, SSM,
hybrid, enc-dec and VLM: ``models``), its training stack (``optim``,
``trainer``, ``checkpoint``, ``launch``) and the continuous-batching
serving tier for the dense, MoE and SSM families (``serve``; the hybrid,
enc-dec and VLM families serve through the static launcher, as in the
reference).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than quietly run on the CPU.  On a CPU
tensor every kernel wrapper takes its plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.

Precision: TF32 is off, so no float32 product in the port (or in a plain
version it is compared with) is rounded to TF32; and bf16 matrix products
keep a float32 accumulation throughout (no reduced-precision split-K
reduction), the nearest to the reference's float32 accumulation of bf16
products.  All three switches are set when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
