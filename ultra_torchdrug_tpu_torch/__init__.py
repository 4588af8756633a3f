"""PyTorch/CUDA port of ultra_torchdrug_tpu for one NVIDIA Hopper card.

Mirrors the JAX package's module layout (data/, nn/, ops/, models/, tasks/,
engine/, utils/) so that every module has a counterpart of the same name. The hand-written
CUDA kernels live in csrc/ and are built with nvcc at first use
(ops/cuda_build.py). Numerics are fp32 end to end with TF32 off, as in the
reference; a config's ``compute_dtype: bfloat16`` opts the entity tower's
sparse sums into bf16 operands with fp32 sums (kernels K1h and K2h). The
config-driven entry point is ``python -m ultra_torchdrug_tpu_torch.run_full``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one. Asking for the card where there is none raises; there is
    no silent fall back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
