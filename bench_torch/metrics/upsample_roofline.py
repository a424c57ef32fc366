"""The served upsamples' share of their roofline in the traced window: per
chunk the least time of the serving graph's trilinear upsamples (the
decoder's TransUps and the final head's; the aux heads are not served),
each reading its float32 input once and writing its float32 output once
over the memory rate, summed over the window's chunks, over the device
time of the kernels whose name holds ``upsample_trilinear3d``: aten's on a
port that runs ``F.interpolate``, K5's on one that runs K5.  The skip that
K5 adds in its epilogue is left out of the bytes, so the share cannot pass
100 % whichever kernel does the work."""
from bench_torch import costs
from bench_torch.model import _triple

KERNEL = "upsample_trilinear3d"


def patch_elements(cfg, patch=None) -> int:
    """float32 elements the served upsamples of one patch read and write:
    each TransUp from its stage's extent at the next stage's width to the
    next stage's extent, and the head's classes from the stem's extent to
    the patch."""
    patch = _triple(patch or cfg["patch"])
    init = _triple(cfg["init_stride"])
    base = tuple(p // s for p, s in zip(patch, init))
    widths = cfg["widths"]
    nd = len(widths) // 2

    def vox(depth):
        d, h, w = (e >> depth for e in base)
        return d * h * w

    n = sum(widths[i + 1] * (vox(2 * nd - i) + vox(2 * nd - i - 1))
            for i in range(nd, 2 * nd))
    if init != (1, 1, 1):
        n += cfg["num_classes"] * (vox(0) + patch[0] * patch[1] * patch[2])
    return n


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = 4 * patch_elements(out["cfg"]) / costs.HBM_BPS
    return 100.0 * least * sum(chunks) / device_s
