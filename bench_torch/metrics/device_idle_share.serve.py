"""The device's idle share of the traced window, in %: 1 less the union
of its kernel, copy and memset intervals (CUDA graphs' included) over
the window."""


def read(out):
    tr = out["trace"]
    if not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
