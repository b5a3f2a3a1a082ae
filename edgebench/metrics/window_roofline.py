"""window_roofline: as ``flash_roofline``, for the window attention
kernel, counting the windows each row computes (before the restoration
point a mixed row's valid windows only: pad windows write zeros and are
not counted).  A window kernel's name holds KERNEL."""
from edgebench import flops

KERNEL = "window_attention_kernel"


def read(r):
    return flops.attention_roofline(r.traced_waves(), r.sizes, r.dtype,
                                    r.mix["beta"], r.peaks, KERNEL,
                                    "window")
