"""dispatch_ms: host milliseconds a wave spends inside
``ServerModel.infer_wave(..., defer=True)``, the mean over the waves
dispatched in the measured window, from the harness's own spans around
the call (tracing off)."""


def read(r):
    ws = [w.dispatch_s for w in r.waves]
    return 1e3 * sum(ws) / len(ws) if ws else None
