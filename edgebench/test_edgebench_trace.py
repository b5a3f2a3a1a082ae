"""Reading a device trace: busy time, idle gaps by host phase, and each
wave's kernels by the host call that launched them."""
from __future__ import annotations

import json

import pytest

from edgebench import trace_read as tr


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """Host: mark at 100; wave 0 dispatched over 100-110 (two launches),
    waits 110-160, completes 160-165; wave 1 over 170-180 (one launch);
    mark at 300.  Device: wave 0's kernels 105-130 and 132-150, wave 1's
    190-250, a copy 255-260 launched from no wave."""
    return [
        ev("user_annotation", tr.MARK_START, 100, 0),
        ev("user_annotation", "edgebench.wave.0", 100, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 101, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 103, 1, correlation=2),
        ev("user_annotation", "edgebench.wait", 110, 50),
        ev("user_annotation", "edgebench.complete", 160, 5),
        ev("user_annotation", "edgebench.wave.1", 170, 10),
        ev("cuda_driver", "cuLaunchKernelEx", 171, 1, correlation=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 200, 1, correlation=4),
        ev("user_annotation", tr.MARK_END, 300, 0),
        ev("kernel", "void flash_attention_kernel_half<64>", 105, 25,
           correlation=1),
        ev("kernel", "sm90_xmma_gemm_f16", 132, 18, correlation=2),
        ev("kernel", "void window_attention_kernel<8>", 190, 60,
           correlation=3),
        ev("gpu_memcpy", "Memcpy DtoH", 255, 5, correlation=4),
        ev("cpu_op", "aten::mm", 101, 1),
    ]


def test_summary(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": synthetic()}))
    s = tr.summarize(tr.load_events(p))
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx((25 + 18 + 60 + 5) * 1e-6)
    assert sorted(s.wave_ops) == [0, 1]
    assert [o.name for o in s.wave_ops[0]] == [
        "void flash_attention_kernel_half<64>", "sm90_xmma_gemm_f16"]
    assert len(s.wave_ops[1]) == 1
    # 100-105 dispatch; 130-132 and 150-160 wait; 160-165 complete,
    # 165-170 poll, 170-180 dispatch, 180-190 poll; 250-255 and 260-300
    # poll
    phases = {}
    for _, secs, ph in s.gaps:
        phases[ph] = phases.get(ph, 0) + secs
    assert phases == pytest.approx({"dispatch": 15e-6, "wait": 12e-6,
                                    "complete": 5e-6, "poll": 60e-6})
    assert sum(phases.values()) == pytest.approx(s.window_s - s.busy_s)
    b = tr.breakdown(s)
    assert b["device_ops"][0] == ["void window_attention_kernel<8>",
                                  pytest.approx(60e-6)]
    assert len(b["idle_gaps"]) <= 10


def test_empty_trace_reads_as_none():
    events = [e for e in synthetic() if e["cat"] not in
              ("kernel", "gpu_memcpy")]
    assert tr.summarize(events) is None
    assert tr.summarize([]) is None
