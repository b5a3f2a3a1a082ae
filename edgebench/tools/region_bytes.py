"""Measure the payload bytes of one FULL and one LOW decision region.

The ``phones-mixed`` traffic file fixes these two sizes; this script is
how they were measured, and it is not run by the benchmark.  It encodes
the port's synthetic clips (every scenario, 1024 x 1024 frames) with the
port's codec size model (``MixedResCodec.encode_size_only``) at the
ViTDet-L partition, once with every region FULL and once with every
region LOW, and divides each total, less the header, by the region
count.  A 1024 x 1024 frame stands for a 1080p capture, so the sizes are
scaled by (1920 * 1080) / (1024 * 1024), as ``offload.simulator`` scales
its 512 x 512 codec by SIZE_SCALE.

    PYTHONPATH=src python edgebench/tools/region_bytes.py
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.partition import make_partition
from repro_torch.data.synthetic_video import SCENARIOS, make_clip
from repro_torch.offload.codec import MixedResCodec

SIZE = 1024
PATCH = 16
QUALITY = 90
FRAMES = 4
SCALE = (1920 * 1080) / (SIZE * SIZE)


def main() -> None:
    part = make_partition(SIZE // PATCH, SIZE // PATCH, 8, 2)
    codec = MixedResCodec(part, PATCH, 2)
    nR = part.n_regions
    full, low = [], []
    for name in SCENARIOS:
        frames, _ = make_clip(name, FRAMES, size=SIZE, seed=0)
        for f in frames:
            for mask, out in ((np.zeros(nR, np.int32), full),
                              (np.ones(nR, np.int32), low)):
                head = codec._header_bytes(mask, None)
                total = codec.encode_size_only(f, mask, QUALITY)
                out.append((total - head) / nR * SCALE)
    print(json.dumps({"full": round(float(np.mean(full))),
                      "low": round(float(np.mean(low))),
                      "header": codec._header_bytes(np.zeros(nR), None),
                      "quality": QUALITY, "frames": len(full)}))


if __name__ == "__main__":
    main()
