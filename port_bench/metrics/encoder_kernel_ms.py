"""``encoder_kernel_ms``: device ms a step of the program's own kernels
(``kernels/port_*.json``: SmaQ, the float formats, S2FP8, the Philox
fill); nothing where none runs."""


def read(rec):
    return rec.kernel_ms_per_step(lambda fam: fam is not None and fam.startswith("port_"))
