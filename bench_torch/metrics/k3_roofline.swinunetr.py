"""K3's share of its roofline at SwinUNETR's shapes in the traced window:
the least time of every K3 conv (the 32 block linears, 4 merge
reductions, 5 conv3 and 5 transposed convs; per conv the larger of its
bytes over the memory rate, its float32 x read once, the int8 weights,
the bias and its float32 y written once, and its int8 operations over the
int8 peak: ``swinunetr_model.k3_least_s``) over the device time of K3's
kernel in the trace."""
from bench_torch import swinunetr_model

KERNEL = "qmatmul_int8_kernel"


def read(out):
    tr, chunks = out["trace"], out.get("chunks")
    device_s = tr.kernel_s(KERNEL)
    if not chunks or device_s <= 0:
        return None
    least = {b: swinunetr_model.k3_least_s(out["cfg"], b)
             for b in set(chunks)}
    return 100.0 * sum(least[b] for b in chunks) / device_s
