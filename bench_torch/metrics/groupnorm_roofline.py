"""The served GroupNorms' share of their roofline in the traced window:
per chunk the least time of the serving graph's GroupNorms, each reading
its float32 input once and writing its output once (the next conv's int8
codes, or the head's float32) over the memory rate
(``segresnet_model.group_norm_bytes``), summed over the window's chunks,
over the device time of the kernels whose name holds ``effq_group_norm``
(K6's three; a later implementation is timed against the same work under
the same name)."""
from bench_torch import costs, segresnet_model

KERNEL = "effq_group_norm"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = segresnet_model.group_norm_bytes(out["cfg"]) / costs.HBM_BPS
    return 100.0 * least * sum(chunks) / device_s
