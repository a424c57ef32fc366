"""K7's share of its roofline at SwinUNETR's shapes in the traced window:
per chunk the least time of the eight window attentions (per attention
the larger of its bytes over the memory rate, q, k and v read once, the
output written once and the bias table, and its float32 operations over
the float32 peak, q k^T and p v of every query on the unpadded grid
against its window's keys: ``swinunetr_model.attention_least_s``), summed
over the window's chunks, over the device time of the kernels whose name
holds ``effq_window_attention`` (K7's)."""
from bench_torch import swinunetr_model

KERNEL = "effq_window_attention"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = {b: swinunetr_model.attention_least_s(out["cfg"], b)
             for b in set(chunks)}
    return 100.0 * sum(least[b] for b in chunks) / device_s
