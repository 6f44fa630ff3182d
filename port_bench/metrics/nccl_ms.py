"""``nccl_ms``: device ms a step of NCCL's kernels (``kernels/nccl.json``),
waits for the other ranks included; nothing on one chip."""


def read(rec):
    return rec.kernel_ms_per_step(lambda fam: fam == "nccl")
