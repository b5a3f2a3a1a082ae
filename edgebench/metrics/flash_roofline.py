"""flash_roofline: the least time the card could take for the flash
attention problems of the waves the traced interval holds whole (the
benchmark's own count, ``flops.wave_attention``: 4 Tq Tk Dh FLOPs a head,
q, k, v and o read or written once; the larger of FLOPs over the peak
at the configuration's precision and bytes over 3.35 TB/s), over those
kernels' traced device time, in percent.  A flash kernel's name holds
KERNEL."""
from edgebench import flops

KERNEL = "flash_attention_kernel"


def read(r):
    return flops.attention_roofline(r.traced_waves(), r.sizes, r.dtype,
                                    r.mix["beta"], r.peaks, KERNEL, "flash")
