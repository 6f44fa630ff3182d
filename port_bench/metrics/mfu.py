"""``mfu``: the whole step's share of the chips' peak, in %.

The model's FLOPs a sample (``work/<config>.py``) times the traced
window's samples a second, over the chips' dense peak at the cell's GEMM
precision (``peaks.json``; float32 outside the tensor cores, since the
program trains with TF32 off)."""


def read(rec):
    peak = rec.card["flops"][rec.mix["compute_dtype"]]
    rate = rec.samples / rec.window_s
    return 100.0 * rec.work.flops_per_sample(rec.cfg) * rate / (peak * rec.chips)
