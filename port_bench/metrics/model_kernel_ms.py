"""``model_kernel_ms``: device ms a step of the kernels that are neither
the program's own (``kernels/port_*.json``) nor NCCL's: the models'
convolutions, GEMMs and elementwise work (cuDNN, cuBLAS, PyTorch)."""


def read(rec):
    return rec.kernel_ms_per_step(lambda fam: fam is None)
