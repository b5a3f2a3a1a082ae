"""Serving request/response types, replica telemetry and per-client
feature-cache sessions (the ``repro.serve.request`` types the edge
detector's serving path and the LM serving engine use).

:class:`FeatureCache` is the session state behind temporal region reuse:
one cache per client stream, holding the per-region backbone-feature
tiles captured at the restoration point of that client's previous
offload, plus the bookkeeping that bounds staleness — a region may be
reused at most ``max_age`` (K) CONSECUTIVE offloads before it must be
transmitted again.  Tiles stay on the card: reuse gathers are device
index ops and a refresh overwrites the cached buffer in place.  The LM
engine (``serve/engine.py``) uses the same bookkeeping without tiles to
gate and bucket reuse spans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import mixed_res as mr


class StaleCacheEpoch(RuntimeError):
    """A REUSE plan tried to splice tiles captured under a cache epoch
    that died with a restarted replica.  The server refuses the splice;
    the client must invalidate its FeatureCache and bootstrap FULL."""


@dataclass
class ServingStats:
    """Replica-side serving telemetry.

    PyTorch runs eagerly, so a "compile" here is the first run of an
    executable-grid key ``(length bucket, beta, capture, B bucket)``.
    ``warmed`` flips once :meth:`finish_warmup` closes the warmup pass;
    every first use after that is a steady-state stall, which callers
    treat as a failure (``steady_compiles > 0``).
    """
    compiles: int = 0
    steady_compiles: int = 0
    steady_compile_keys: List[Tuple] = field(default_factory=list)
    warmed: bool = False
    warmup_wall_s: float = 0.0
    offloads: int = 0
    # crash-restarts of this replica (ServerModel.restart), reuse splices
    # served, and splices refused because the client's tiles came from a
    # pre-restart epoch (StaleCacheEpoch)
    restarts: int = 0
    reuse_splices: int = 0
    stale_epoch_rejects: int = 0

    def note_compile(self, key: Tuple) -> None:
        """Record the first use of a grid key; after warmup it counts as
        a steady-state stall."""
        self.compiles += 1
        if self.warmed:
            self.steady_compiles += 1
            self.steady_compile_keys.append(key)

    def finish_warmup(self, t0: float, compiles_before: int,
                      now: float) -> int:
        """Close a warmup pass: flip ``warmed``, account its wall time,
        return the number of keys it warmed."""
        self.warmed = True
        self.warmup_wall_s += now - t0
        return self.compiles - compiles_before


@dataclass
class FeatureCache:
    """Per-client cached restoration-point feature tiles + reuse ages.

    ``tiles``: (n_regions, d^2, w^2, D) device tensor (None until the
    first capture).  ``beta``: the restoration point the tiles were
    captured at — reuse is only valid at the SAME point.  ``age[j]``:
    consecutive offloads region j has been reused.  ``epoch``: the
    replica generation the tiles were captured under.
    """
    n_regions: int
    max_age: int = 4
    beta: int = -1
    tiles: Optional[torch.Tensor] = None
    age: np.ndarray = None
    frame: int = -1
    warm: bool = False
    epoch: int = 0

    def __post_init__(self):
        if self.age is None:
            self.age = np.zeros((self.n_regions,), np.int32)

    def eligible(self, beta: int) -> np.ndarray:
        """(n_regions,) bool: regions whose cached tile may be reused for
        an offload restoring at ``beta`` (cache warm, same restoration
        point, staleness bound not yet hit)."""
        if not self.warm or beta < 1 or beta != self.beta:
            return np.zeros((self.n_regions,), bool)
        return self.age < self.max_age

    def gather(self, reuse_ids: np.ndarray) -> torch.Tensor:
        """(n_reuse, d^2, w^2, D) tiles of the plan's reuse set, gathered
        on the card."""
        assert self.tiles is not None, "cache holds no tiles yet"
        return mr.gather_tiles(self.tiles, torch.as_tensor(
            np.asarray(reuse_ids, np.int64), device=self.tiles.device))

    def expire(self, ids) -> None:
        """Force regions out of the reuse-eligible set (age pinned to
        ``max_age``) without dropping their tiles: used for regions the
        degradation ladder transmitted at LOW fidelity.  They re-enter
        reuse only after a FULL re-transmission resets their age."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        self.age[ids] = self.max_age

    def invalidate(self) -> None:
        """Drop every cached tile and the warm flag (the edge replied
        StaleCacheEpoch); the next offload must be a FULL bootstrap."""
        self.tiles = None
        self.age = np.zeros((self.n_regions,), np.int32)
        self.beta = -1
        self.frame = -1
        self.warm = False

    def note(self, reuse_ids: np.ndarray, beta: int, frame: int,
             epoch: Optional[int] = None) -> None:
        """Bookkeeping refresh: regions in ``reuse_ids`` were reused this
        offload (age + 1), every other region was transmitted (age 0)."""
        ids = np.asarray(reuse_ids, np.int64).reshape(-1)
        new_age = np.zeros((self.n_regions,), np.int32)
        new_age[ids] = self.age[ids] + 1
        self.age = new_age
        self.beta = int(beta)
        self.frame = int(frame)
        self.warm = True
        if epoch is not None:
            self.epoch = int(epoch)

    def update(self, tiles: torch.Tensor, reuse_ids: np.ndarray, beta: int,
               frame: int, epoch: Optional[int] = None) -> None:
        """Full refresh after a forward that captured tiles.  A cached
        buffer of the same shape, type and device is overwritten in
        place; otherwise the cache takes its own copy, so it never pins
        the whole wave's capture."""
        if (self.tiles is not None and self.tiles.shape == tiles.shape
                and self.tiles.dtype == tiles.dtype
                and self.tiles.device == tiles.device):
            mr.refresh_tiles(self.tiles, tiles)
        else:
            self.tiles = tiles.clone()
        self.note(reuse_ids, beta, frame, epoch=epoch)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (T,) int32 token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    # paper technique: spans of the prompt that may be pooled at prefill
    low_span_mask: Optional[np.ndarray] = None
    beta: int = 0
    arrival_time: float = 0.0
    # temporal reuse: the client's session identity and the spans it
    # claims unchanged since its previous request (serve/engine.py gates
    # them against the per-client FeatureCache staleness bound)
    client_id: int = -1
    reuse_span_mask: Optional[np.ndarray] = None

    def _spans(self, mask: Optional[np.ndarray],
               n: Optional[int]) -> np.ndarray:
        if mask is None or self.beta <= 0:
            return np.zeros((0,), np.int32)
        sel = np.nonzero(np.asarray(mask).reshape(-1) != 0)[0]
        if n is not None:
            sel = sel[:n]
        return sel.astype(np.int32)

    def low_spans(self, n_low: Optional[int] = None) -> np.ndarray:
        """Span indices actually pooled, in selection order.  ``n_low``:
        the bucket — extra selections beyond it are dropped (the trimming
        rule of ``seq_mixed_res.build_seq_pack``), so two requests with
        equal ``low_spans(n_low)`` get byte-identical packs and may share
        a wave."""
        return self._spans(self.low_span_mask, n_low)

    def reuse_spans(self, n_reuse: Optional[int] = None) -> np.ndarray:
        """Span indices the client marked temporally reusable, trimmed
        like :meth:`low_spans`."""
        return self._spans(self.reuse_span_mask, n_reuse)

    def mask_key(self, n_low: Optional[int] = None,
                 reuse_ids: Optional[np.ndarray] = None) -> bytes:
        """Canonical wave-key bytes of the (bucket-trimmed) span layout;
        ``reuse_ids`` are the EFFECTIVE reuse spans (after the engine's
        staleness gate), part of the identity because co-batched requests
        share one pack."""
        key = self.low_spans(n_low).tobytes()
        if reuse_ids is not None and len(reuse_ids):
            key += b"|" + np.asarray(reuse_ids, np.int32).tobytes()
        return key


@dataclass
class Response:
    rid: int
    tokens: List[int] = field(default_factory=list)
    prefill_done: float = 0.0
    finished: float = 0.0
    slot: int = -1

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)
