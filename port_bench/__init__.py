"""The benchmark of ``smart_quantization_tpu_torch`` on NVIDIA cards (see
``README.md``); it imports nothing of the JAX package."""
