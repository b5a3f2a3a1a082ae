"""Serving request/response types, replica telemetry and per-client
feature-cache sessions (the ``repro.serve.request`` types the edge
detector's serving path and the LM serving engine use).

:class:`FeatureCache` is the session state behind temporal region reuse:
one cache per client stream, holding the per-region backbone-feature
tiles captured at the restoration point of that client's previous
offload, plus the bookkeeping that bounds staleness — a region may be
reused at most ``max_age`` (K) CONSECUTIVE offloads before it must be
transmitted again.  Tiles stay on the server's device by default: reuse
gathers are device index ops and a refresh overwrites the cached buffer
in place, unless the cache is a speculative clone that shares the live
session's buffer.  A host-resident cache (``ServerModel(device_cache=
False)``) keeps them in host memory, pinned on a CUDA server, and
gathers there.  The LM
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
    treat as a failure (``steady_compiles > 0``).  The tile byte counters
    account the host<->device traffic of the temporal-reuse FeatureCache
    (zero with a device-resident cache).
    """
    compiles: int = 0
    steady_compiles: int = 0
    steady_compile_keys: List[Tuple] = field(default_factory=list)
    warmed: bool = False
    warmup_wall_s: float = 0.0
    offloads: int = 0
    tile_bytes_d2h: int = 0
    tile_bytes_h2d: int = 0
    # crash-restarts of this replica (ServerModel.restart), reuse splices
    # served, and splices refused because the client's tiles came from a
    # pre-restart epoch (StaleCacheEpoch)
    restarts: int = 0
    reuse_splices: int = 0
    stale_epoch_rejects: int = 0

    @property
    def tile_bytes(self) -> int:
        return self.tile_bytes_d2h + self.tile_bytes_h2d

    def tile_bytes_per_offload(self) -> float:
        return self.tile_bytes / max(self.offloads, 1)

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

    ``tiles``: (n_regions, d^2, w^2, D) tensor (None until the first
    capture) on the server's device, or in host memory when
    ``host_tiles`` (the host-resident mode).  ``beta``: the restoration
    point the tiles were
    captured at — reuse is only valid at the SAME point.  ``age[j]``:
    consecutive offloads region j has been reused.  ``epoch``: the
    replica generation the tiles were captured under.

    Speculative REUSE execution also keeps a **prediction source** per
    session: the last payload the edge decoded for this client
    (``pred_frame`` at ``pred_frame_idx``, decoded under ``pred_epoch``).
    A speculative forward substitutes the in-flight LOW/FULL regions'
    pixels with this frame's; :meth:`pred_ok` gates it on the same
    staleness bound K (``max_age``, counted in offloads by ``pred_age``)
    and on the epoch.
    """
    n_regions: int
    max_age: int = 4
    beta: int = -1
    tiles: Optional[torch.Tensor] = None
    age: np.ndarray = None
    frame: int = -1
    warm: bool = False
    epoch: int = 0
    # speculative-prediction source (edge side): the last decoded canvas
    # served for this session and the replica generation that decoded it
    pred_frame: Optional[np.ndarray] = None
    pred_frame_idx: int = -1
    pred_age: int = 0
    pred_epoch: int = -1
    # False on speculative clones: ``tiles`` is the live session's buffer,
    # so update() must not overwrite it in place (the clone owns a buffer
    # again after its first refresh)
    owns_tiles: bool = True
    # True when ``tiles`` is the host copy (ServerModel(device_cache=False))
    host_tiles: bool = False

    def __post_init__(self):
        if self.age is None:
            self.age = np.zeros((self.n_regions,), np.int32)

    @property
    def tiles_on_device(self) -> bool:
        return self.tiles is not None and not self.host_tiles

    def eligible(self, beta: int) -> np.ndarray:
        """(n_regions,) bool: regions whose cached tile may be reused for
        an offload restoring at ``beta`` (cache warm, same restoration
        point, staleness bound not yet hit)."""
        if not self.warm or beta < 1 or beta != self.beta:
            return np.zeros((self.n_regions,), bool)
        return self.age < self.max_age

    def gather(self, reuse_ids: torch.Tensor) -> torch.Tensor:
        """(n_reuse, d^2, w^2, D) tiles of the plan's reuse set, gathered
        where the tiles reside; ``reuse_ids`` is an index tensor there
        (the server copies it to the card without blocking)."""
        assert self.tiles is not None, "cache holds no tiles yet"
        return mr.gather_tiles(self.tiles, reuse_ids)

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
        self.pred_frame = None
        self.pred_frame_idx = -1
        self.pred_age = 0
        self.pred_epoch = -1

    # ------------------------------------------------------------------
    # speculative-prediction source

    def note_pred(self, frame: np.ndarray, frame_idx: int,
                  epoch: int) -> None:
        """Record a served offload's decoded canvas as the session's
        prediction source (resets the prediction-staleness clock)."""
        self.pred_frame = frame
        self.pred_frame_idx = int(frame_idx)
        self.pred_age = 0
        self.pred_epoch = int(epoch)

    def pred_ok(self, epoch: int) -> bool:
        """May the prediction source seed a speculative forward?  It must
        exist, be younger than K (``max_age``) offloads, and come from
        the live replica generation."""
        return (self.pred_frame is not None
                and self.pred_age < self.max_age
                and self.pred_epoch == int(epoch))

    def speculative_clone(self) -> "FeatureCache":
        """A session clone for a speculative forward to capture into.
        It shares the tile buffer (gathers never write it) but does not
        own it, so its first refresh takes a copy and a discarded
        speculation leaves the live session byte-identical.  Commit with
        :meth:`commit_speculative`."""
        return FeatureCache(self.n_regions, max_age=self.max_age,
                            beta=self.beta, tiles=self.tiles,
                            age=self.age.copy(), frame=self.frame,
                            warm=self.warm, epoch=self.epoch,
                            owns_tiles=False, host_tiles=self.host_tiles)

    def commit_speculative(self, clone: "FeatureCache",
                           reuse_ids: np.ndarray, beta: int, frame: int,
                           epoch: int) -> None:
        """Adopt a resolved speculation's tiles into the live session.
        ``reuse_ids``: the regions whose content derives from reuse or the
        converged prediction; they age by one from this cache's own
        pre-speculation ages, so K still forces a re-transmission."""
        self.tiles = clone.tiles
        self.host_tiles = clone.host_tiles
        self.note(reuse_ids, beta, frame, epoch=epoch)

    # ------------------------------------------------------------------
    def note(self, reuse_ids: np.ndarray, beta: int, frame: int,
             epoch: Optional[int] = None) -> None:
        """Bookkeeping refresh: regions in ``reuse_ids`` were reused this
        offload (age + 1), every other region was transmitted (age 0).
        The prediction source, if any, ages by one offload."""
        ids = np.asarray(reuse_ids, np.int64).reshape(-1)
        new_age = np.zeros((self.n_regions,), np.int32)
        new_age[ids] = self.age[ids] + 1
        self.age = new_age
        self.beta = int(beta)
        self.frame = int(frame)
        self.warm = True
        if epoch is not None:
            self.epoch = int(epoch)
        if self.pred_frame is not None:
            self.pred_age += 1

    def update(self, tiles: torch.Tensor, reuse_ids: np.ndarray, beta: int,
               frame: int, epoch: Optional[int] = None,
               host: bool = False) -> None:
        """Full refresh after a forward that captured tiles.  A buffer
        this cache owns, of the same shape, type and residence, is
        overwritten in place; otherwise (first capture, or a speculative
        clone still sharing the live session's buffer) the cache takes
        its own copy, so it never pins the whole wave's capture and never
        writes a buffer it shares.  ``host``: keep the tiles in host
        memory (pinned when they come from the card) instead of on their
        device; the copy there blocks until the forward has written
        them."""
        dev = torch.device("cpu") if host else tiles.device
        if (self.owns_tiles and self.tiles is not None
                and self.host_tiles == host
                and self.tiles.shape == tiles.shape
                and self.tiles.dtype == tiles.dtype
                and self.tiles.device == dev):
            mr.refresh_tiles(self.tiles, tiles)
        elif host:
            self.tiles = torch.empty(tiles.shape, dtype=tiles.dtype,
                                     pin_memory=tiles.is_cuda)
            self.tiles.copy_(tiles)
        else:
            self.tiles = tiles.clone()
        self.owns_tiles = True
        self.host_tiles = host
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
