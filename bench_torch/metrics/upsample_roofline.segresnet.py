"""K5's share of its roofline at SegResNet's shapes in the traced window:
per chunk the least time of the decoder's three upsamples, each reading
its up-projection's float32 output once and writing the upsampled float32
once over the memory rate (``segresnet_model.upsample_elements``; the
skip that K5 adds in its epilogue left out, as ``upsample_roofline``
leaves it out, so the share cannot pass 100 %), summed over the window's
chunks, over the device time of the kernels whose name holds
``upsample_trilinear3d``."""
from bench_torch import costs, segresnet_model

KERNEL = "upsample_trilinear3d"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = 4 * segresnet_model.upsample_elements(out["cfg"]) / costs.HBM_BPS
    return 100.0 * least * sum(chunks) / device_s
