"""Data parallelism and the two FSDP paths on ``torch.distributed`` (NCCL
on the card, gloo on the CPU): the counterpart of
``smart_quantization_tpu/parallel/``.  ``train_dp.py`` and
``train_fsdp_q.py`` are its ``shard_map`` steps (each rank's own
statistics, int8 payloads); ``train_fsdp.py`` its XLA-managed float32 FSDP
step (the whole batch's statistics, ``whole_batch.py``)."""
