"""mlff_tpu_torch — the PyTorch/CUDA port of ``mlff_tpu`` for one NVIDIA H100.

Same system as the JAX package beside it (sGDML Matérn-5/2 Hessian-kernel
ridge regression solved by preconditioned conjugate gradients), written in
PyTorch: f64 tensors on the solve path, cuBLAS for the large f64 matrix
products, and hand-written CUDA kernels (``csrc/``) where the JAX package
wrote Pallas kernels for the TPU.

Device policy: the entry points (``Trainer``, ``Predictor``, ``build_cache``)
run on ``cuda`` unless the caller passes ``device="cpu"``.  A missing GPU is an
error, never a silent move to the CPU.  Every solve-path tensor is created
with an explicit ``torch.float64``; torch's global default dtype is left
alone.  TF32 is switched off where a CUDA device is resolved: the f32
prediction kernel's plain version and every f32 product must run in full f32.

Importing the package builds nothing: CUDA sources compile at first use.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when the caller asks for it.  Raises when CUDA is requested (explicitly or
    by default) and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mlff_tpu_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def require_full_f32(t: torch.Tensor) -> None:
    """Raise if an f32 matrix product on ``t``'s device would run in TF32.
    The f32 products of the precision engines (``ops/ozaki.py``, the mixed
    and f32 matvecs, IR-CG) are exact or error-budgeted only in full f32;
    ``resolve_device`` switches TF32 off, but a caller can reach them
    without it."""
    if t.device.type == "cuda" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "an f32 product of the precision engines would run in TF32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (resolve_device "
            "does)")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU); timers around
    device work end with this."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
