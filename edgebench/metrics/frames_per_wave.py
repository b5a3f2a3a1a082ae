"""frames_per_wave: real frames a wave carries, the mean over the waves
dispatched in the measured window (pad rows not counted)."""


def read(r):
    ws = [w.B for w in r.waves]
    return sum(ws) / len(ws) if ws else None
