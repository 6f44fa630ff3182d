"""``device_idle_share``: the share of the traced window, in %, in which no
operation ran on the device (the union of kernel, copy and fill
intervals, from the same trace)."""


def read(rec):
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
