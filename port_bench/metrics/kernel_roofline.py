"""``kernel_roofline``: the program's own kernels' share of their bound,
in %: the least time the step's compression work needs on the card, each
element read once and written once at its type's size (random words
written once) at the card's memory bandwidth, over ``encoder_kernel_ms``.
The work comes from ``work/<config>.py``, counted from the published
shapes."""

from port_bench.metrics import encoder_kernel_ms


def read(rec):
    work = rec.work.compression(rec.cfg, rec.mix)
    kernel_ms = encoder_kernel_ms.read(rec)
    if not work or kernel_ms is None:
        return None
    size = rec.element_bytes
    least_ms = sum(n * size[dt] * passes for _, n, dt, passes in work) / rec.card["bytes_per_s"] * 1e3
    return 100.0 * least_ms / kernel_ms
