"""The served InstanceNorms' share of their roofline in the traced window,
by ``groupnorm_roofline``'s rule: per chunk the least time of SwinUNETR's
26 InstanceNorms (K6 at one channel a group), each reading its float32
input once and writing its output once (conv2's int8 codes, or float32)
over the memory rate (``swinunetr_model.instance_norm_bytes``), summed
over the window's chunks, over the device time of the kernels whose name
holds ``effq_group_norm``."""
from bench_torch import costs, swinunetr_model

KERNEL = "effq_group_norm"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = swinunetr_model.instance_norm_bytes(out["cfg"]) / costs.HBM_BPS
    return 100.0 * least * sum(chunks) / device_s
