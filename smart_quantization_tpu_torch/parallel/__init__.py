"""Data parallelism and the fused FSDP path on ``torch.distributed``
(NCCL on the card, gloo on the CPU): the counterpart of
``smart_quantization_tpu/parallel/`` less its XLA-managed ``train_fsdp.py``."""
