"""SwinUNETR's served step as a share of the card's peak in the traced
window: each chunk forward's convs and linears at the dense peak of the
type each runs in (K1's and K3's int8, 1979 TOP/s; the float32 patch
embedding, encoder1's conv1 and conv3 and the head, 67 TFLOP/s) and its
window attentions' q k^T and p v at the float32 peak
(``swinunetr_model.peak_s``), summed over every chunk the window served,
over the traced window."""
from bench_torch import swinunetr_model


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    if not chunks:
        return None
    at_peak = {b: swinunetr_model.peak_s(out["cfg"], b) for b in set(chunks)}
    return 100.0 * sum(at_peak[b] for b in chunks) / tr.window_s
