"""SegResNet's served step as a share of the card's peak in the traced
window: each chunk forward's convs at the dense peak of the type each runs
in (K1's int8 1979 TOP/s; the float32 stem and head, and the int8 path's
stride-2 and 1x1 convs, which multiply their codes as float32, 67
TFLOP/s), summed over every chunk the window served, over the traced
window."""
from bench_torch import segresnet_model


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    if not chunks:
        return None
    at_peak = {b: segresnet_model.peak_s(out["cfg"], b) for b in set(chunks)}
    return 100.0 * sum(at_peak[b] for b in chunks) / tr.window_s
