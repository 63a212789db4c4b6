"""The card's idle share of the traced passes: 1 - the union of its
kernel, copy and set intervals over the host clock's window, in %."""


def read(r):
    if r.device is None or r.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)
