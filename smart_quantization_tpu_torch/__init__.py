"""SmaQ compression-in-training on PyTorch and CUDA (NVIDIA H100).

The PyTorch port of ``smart_quantization_tpu``: same module layout and names,
PyTorch idiom inside (``nn.Module``s, explicit devices, ``torch.Generator``s
in place of JAX keys).  The SmaQ quantizer runs as hand-written CUDA kernels
(``csrc/smaq.cu``) on CUDA tensors and as plain PyTorch on CPU tensors.

Importing the package builds nothing: the CUDA library is compiled with
``nvcc`` at first use on a CUDA tensor (``ops/cuda/build.py``).
"""

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for (or defaulted to) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
