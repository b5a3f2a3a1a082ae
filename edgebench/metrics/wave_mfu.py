"""wave_mfu: the useful FLOPs of the real frames served in the measured
window, at each plan's exact window count (``flops.frame_flops``: the
blocks, the patch embedding of the transmitted tokens and the head),
over the window's seconds times the card's peak at the configuration's
precision (``peaks.json``), in percent."""
from edgebench import flops
from edgebench.traffic_gen import FULL, LOW


def read(r):
    if not r.waves:
        return None
    sz, beta = r.sizes, r.mix["beta"]
    total = 0.0
    for w in r.waves:
        for o in w.offloads:
            total += flops.frame_flops(sz, int((o.states == FULL).sum()),
                                       int((o.states == LOW).sum()),
                                       o.n_windows, 0 if w.full_res
                                       else beta)
    return 100.0 * total / (r.window_s * r.peaks["flops"][r.dtype])
