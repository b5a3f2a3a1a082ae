"""The wave-formation pass of the scheduling plane (the
``repro.serve.scheduler.form_wave`` the LM serving engine uses; the edge
schedulers follow with the offload plane)."""
from __future__ import annotations

from typing import Callable, Sequence


def form_wave(items: Sequence, key_fn: Callable, cap: int):
    """Form one wave from an ordered queue.

    The head item seeds the wave; each later item joins iff the wave
    has room (``cap``) and its key matches the head's.  Returns
    ``(wave, rest, head_key)``; ``rest`` preserves queue order.  (The
    reference's ``admit`` and ``promote`` hooks come with the edge
    schedulers that pass them.)
    """
    head = items[0]
    hk = key_fn(head)
    wave, rest = [head], []
    for it in items[1:]:
        if len(wave) < cap and key_fn(it) == hk:
            wave.append(it)
        else:
            rest.append(it)
    return wave, rest, hk
