"""K1's share of its roofline at SwinUNETR's shapes in the traced window:
the least time of every K1 call (per call the larger of its bytes over the
memory rate and its int8 operations over the int8 peak, by ``costs``'
per-call rule, from the call's shapes and epilogue flags) over the device
time of K1's kernel in the trace."""
from bench_torch import swinunetr_model

KERNEL = "qconv3d_int8_kernel"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or not out.get("k1_flags") or device_s <= 0:
        return None
    least = {b: swinunetr_model.k1_least_s(out["cfg"], out["k1_flags"], b)
             for b in set(chunks)}
    return 100.0 * sum(least[b] for b in chunks) / device_s
