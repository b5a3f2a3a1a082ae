"""latency_p50_ms: the 50th percentile of the offload latency (due
arrival at the server to detections decoded on the host) over every
offload due in the measured window.  Where a cell's tails swing with the
host's speed they are read here, beside the cell's throughput, and held
to no bound."""
import numpy as np


def read(r):
    lat = [o.done - o.due for o in r.offloads if o.dets is not None]
    return float(np.percentile(lat, 50)) * 1e3 if lat else None
