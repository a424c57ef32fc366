"""The served step's share of the card's peak in the traced window: each
chunk forward's convs at the dense peak of the type each runs in (K1's
int8, the float32 stem, head and int8 1x1 convs), summed over every chunk
the window served, over the traced window."""
from bench_torch import costs


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    if not chunks:
        return None
    at_peak = {b: costs.peak_s(out["cfg"], b) for b in set(chunks)}
    return 100.0 * sum(at_peak[b] for b in chunks) / tr.window_s
