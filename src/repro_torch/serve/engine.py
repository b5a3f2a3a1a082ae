"""Batched KV-cache serving engine for decoder LMs (wave scheduling,
bucketed shapes) — the port of ``repro.serve.engine``.

Every request is a full *prefill* followed by a bounded greedy decode.
The engine batches requests into **waves**:

  * requests are grouped by (bucketed prompt length, bucketed n_low,
    bucketed n_reuse, beta, span-layout identity), so co-batched requests
    share the SAME span layout and one pack serves the whole wave;
  * one prefill per pooled-length key ``("prefill", T, n_pool, beta, B)``
    — the paper's mixed-granularity prefill plugs in through
    ``low_span_mask`` and ``beta`` on the request
    (``core.seq_mixed_res``) — and one decode per ``("decode", B)``;
  * temporal reuse is SESSIONFUL: requests carrying a ``client_id`` get a
    per-client bookkeeping-only ``FeatureCache`` that gates
    ``reuse_span_mask`` (a span rides reuse at most K consecutive
    requests).  Tokens are always transmitted on this path, so effective
    reuse spans are POOLED like low spans;
  * waves are padded up to a batch bucket (slot 0 replicated; pad slots
    are done from step 0), and greedy decode runs the wave in lock-step
    at ``pos = T + step - 1``.

PyTorch runs eagerly, so a key's "compile" is its first run; ``warmup``
runs every key of the grid once and ``stats.steady_compiles`` counts a
first run after it.  Every decoder family the registry serves runs here:
dense, MoE and VLM decoders (a VLM serves its text decoder: a request
carries no image embeddings, as in the reference), the pure SSM LM and
the Mamba-2 hybrid (plain waves only for the last two,
:data:`NO_MIXED_FAMILIES`).  The encoder-decoder family is refused at
construction (:func:`check_servable`).  On the card a GQA
prefill's causal attention runs the flash kernel and every decode step's
cache read the decode kernel, once per layer (MLA's attention runs
einsums, as in the reference); a mamba layer's prefill runs the
``ssd_scan`` kernel (``kernels.dispatch``).  Caches and states are
updated in place.  A MoE wave's pad slots copy slot 0 and compete for
expert capacity, as in the reference.  On the card ``warmup`` first
sweeps the decode kernel's cluster size at every B bucket's cache
(``kernels.autotune``), as the reference's sweeps its block size.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import seq_mixed_res as smr
from repro_torch.core.partition import batch_bucket, bucket_n_low
from repro_torch.kernels import autotune, dispatch
from repro_torch.models import registry
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt
from repro_torch.serve.request import (FeatureCache, Request, Response,
                                       ServingStats)
from repro_torch.serve.scheduler import form_wave


# Families whose mixed-granularity prefill the engine refuses: the
# reference runs it through transformer.run_blocks, which walks dense and
# MoE stacks only, so on these configs it runs no layer at all and serves
# the packed-and-restored embeddings with zero SSM states (its launcher
# turns --mixed off for them).  The port refuses rather than copy that.
NO_MIXED_FAMILIES = ("ssm", "hybrid")


def check_servable(cfg: ModelConfig) -> None:
    """Raise for an encoder-decoder config: a request is a token prompt
    and carries no encoder frames.  The reference's engine passes only
    ``{"tokens": ...}`` to ``registry.prefill``
    (``src/repro/serve/engine.py``), which raises ``KeyError: 'frames'``
    at the first prefill of such a config; the port refuses it up
    front."""
    if cfg is not None and cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: ServeEngine serves token prompts and passes no "
            f"encoder frames (neither does the reference's engine, whose "
            f"first prefill raises KeyError: 'frames'); serve the "
            f"encoder-decoder family through registry.prefill with "
            f"batch['frames'] and registry.decode_step")


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512                 # prompt + generated
    buckets: Tuple[int, ...] = (64, 128, 256)
    # n_low / n_reuse are rounded down to one of this many bucket edges
    # so the prefill key set stays bounded (partition.bucket_n_low)
    n_low_buckets: int = 4
    # staleness bound K for per-client reuse sessions
    reuse_max_age: int = 4
    # wave sizes are padded UP to these edges (padded slots replicate
    # slot 0 and are masked out of the responses)
    b_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    device: str = "cuda"
    # the type of the KV caches and of the conv states (the SSM states
    # stay float32, as in the reference): fp16 / bf16 halve their bytes
    cache_dtype: torch.dtype = torch.float32


class ServeEngine:
    """Single-replica engine over one model's params."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig = None):
        check_servable(cfg)
        self.cfg = cfg
        self.sc = sc or ServeConfig()
        self.device = torch.device(self.sc.device)
        # a float or an int8 tree (quant.ptq.quantize_lm_params): its
        # QuantTensor projections run the int8 GEMM through qtensor.matmul
        self.params = qt.to_device(params, self.device)
        self.queue: List[Request] = []
        self.responses: Dict[int, Response] = {}
        self._prefill_fns: Dict = {}
        self._decode_fns: Dict = {}
        self.wave_latencies: List[float] = []
        self.stats = ServingStats()
        if self.sc.max_batch > max(self.sc.b_buckets):
            warnings.warn(
                f"ServeConfig.max_batch={self.sc.max_batch} exceeds the "
                f"largest batch bucket {max(self.sc.b_buckets)}; waves "
                f"are capped at the bucket — raise b_buckets to serve "
                f"bigger waves", stacklevel=2)
        # per-client reuse sessions (bookkeeping only: the sequence
        # prefill transmits every token)
        self.sessions: Dict[int, FeatureCache] = {}
        dispatch.disable_tf32()

    def batch_bucket(self, b: int) -> int:
        return batch_bucket(b, self.sc.b_buckets)

    # ------------------------------------------------------------------
    def _refuse_mixed(self) -> None:
        raise ValueError(
            f"{self.cfg.name}: family {self.cfg.family!r} has no "
            f"mixed-granularity prefill.  The reference's mixed_prefill runs "
            f"its layers through transformer.run_blocks, which knows no "
            f"mamba layer: it would run zero layers and leave every SSM "
            f"state at zero.  Serve this family with beta 0 or without span "
            f"masks")

    def submit(self, req: Request) -> None:
        """Queue a request.  A pooling request for an SSM or hybrid config
        raises ValueError (see :data:`NO_MIXED_FAMILIES`): beta > 0 and a
        low count that stays above 0 once bucketed, as :meth:`_wave_key`
        buckets it, or any reuse span (a session may make it effective
        before the wave forms).  Low spans that bucket away run the plain
        prefill, as in the reference."""
        if (self.cfg is not None and self.cfg.family in NO_MIXED_FAMILIES
                and req.beta > 0 and (self._bucketed_n_low(req)
                                      or req.reuse_spans().shape[0])):
            self._refuse_mixed()
        self.queue.append(req)

    def _bucketed_n_low(self, r: Request) -> int:
        n = int(r.low_spans().shape[0])
        if n == 0:
            return 0
        n_spans = int(np.asarray(r.low_span_mask).reshape(-1).shape[0])
        return bucket_n_low(n, n_spans, self.sc.n_low_buckets)

    def session(self, client_id: int, n_spans: int) -> FeatureCache:
        sess = self.sessions.get(client_id)
        if sess is None or sess.n_regions != n_spans:
            sess = FeatureCache(n_spans, max_age=self.sc.reuse_max_age)
            self.sessions[client_id] = sess
        return sess

    def _effective_reuse(self, r: Request) -> np.ndarray:
        """Reuse spans that survive the per-client staleness gate.

        Read-only: keying never creates or replaces sessions.  Anonymous
        requests, cold or stale sessions and span-geometry mismatches get
        no reuse; spans also claimed low stay low; the survivors are
        bucketed like low spans."""
        spans = r.reuse_spans()
        if spans.shape[0] == 0 or r.client_id < 0 or \
                r.reuse_span_mask is None:
            return np.zeros((0,), np.int32)
        low = set(r.low_spans().tolist())
        spans = np.array([s for s in spans if s not in low], np.int32)
        n_spans = int(np.asarray(r.reuse_span_mask).reshape(-1).shape[0])
        sess = self.sessions.get(r.client_id)
        if sess is None or sess.n_regions != n_spans:
            return np.zeros((0,), np.int32)
        ok = sess.eligible(r.beta)
        spans = spans[ok[spans]] if spans.shape[0] else spans
        n_reuse = bucket_n_low(int(spans.shape[0]), n_spans,
                               self.sc.n_low_buckets)
        return spans[:n_reuse]

    def _bucket(self, n: int) -> int:
        for b in self.sc.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.sc.buckets[-1]}")

    # ------------------------------------------------------------------
    def _state(self, batch: int):
        return registry.init_decode_state(self.cfg, batch, self.sc.max_len,
                                          self.sc.cache_dtype, self.device)

    def _build_prefill(self, beta: int, mixed: bool) -> Callable:
        cfg, params = self.cfg, self.params

        def fn(tokens, state, pack=None):
            if mixed:
                hidden, state, _ = smr.mixed_prefill(cfg, params, tokens,
                                                     pack, beta, state)
            else:
                hidden, state, _ = registry.prefill(
                    cfg, params, {"tokens": tokens}, state)
            return tfm.logits_from_hidden(cfg, params,
                                          hidden[:, -1:, :]), state
        return fn

    def _get_prefill(self, T: int, n_pool: int, beta: int,
                     batch: int = 1) -> Callable:
        """The prefill of the POOLED-LENGTH key: the pack's shapes depend
        on ``T - n_pool * (span - window)`` only, so every (n_low,
        n_reuse) split of ``n_pool`` shares one key; which spans are
        pooled is data (the pack arrays)."""
        key = ("prefill", T, n_pool, beta, batch)
        if key not in self._prefill_fns:
            self._prefill_fns[key] = self._build_prefill(
                beta, n_pool > 0 and beta > 0)
            self.stats.note_compile(key)
        return self._prefill_fns[key]

    def _get_decode(self, batch: int = 1) -> Callable:
        """The decode step of a batch bucket; ``pos`` is an argument, so
        one key serves every position."""
        key = ("decode", batch)
        if key not in self._decode_fns:
            cfg, params = self.cfg, self.params

            def fn(token, pos, state):
                return registry.decode_step(cfg, params, token, pos, state)
            self._decode_fns[key] = fn
            self.stats.note_compile(key)
        return self._decode_fns[key]

    # ------------------------------------------------------------------
    def _pack_for(self, T: int, n_low: int, n_reuse: int,
                  mask: Optional[np.ndarray] = None
                  ) -> Dict[str, torch.Tensor]:
        """The (shared) seq pack of a wave as index tensors on the
        engine's device — or, with no mask, a representative pack of the
        same shapes (warmup)."""
        part = smr.seq_partition(self.cfg, T)
        if mask is None:
            mask = np.zeros((part.n_spans,), np.int32)
            mask[:n_low + n_reuse] = 1
        pack = smr.build_seq_pack(mask, n_low + n_reuse, part)
        return {k: torch.as_tensor(pack[k].astype(np.int64),
                                   device=self.device)
                for k in ("mix_idx", "pos_mix", "restore_idx")}

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.int64), device=self.device)

    def warmup(self, prompt_lens: Optional[Tuple[int, ...]] = None,
               plan_space: Optional[List[Tuple[int, int, int]]] = None,
               batch_buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Run every serving key once, off the critical path.

        ``prompt_lens``: prompt buckets (default ``sc.buckets``);
        ``plan_space``: (n_low, n_reuse, beta) mixed-prefill shapes on top
        of the plain prefill; ``batch_buckets``: wave sizes (default the
        buckets up to the one covering ``max_batch``).  Returns the number
        of keys run; afterwards ``stats.steady_compiles`` counts every
        further first run.
        """
        t0 = time.perf_counter()
        before = self.stats.compiles
        sc = self.sc
        lens = tuple(prompt_lens or sc.buckets)
        if batch_buckets is None:
            cover = self.batch_bucket(min(sc.max_batch, max(sc.b_buckets)))
            batch_buckets = tuple(b for b in sc.b_buckets if b <= cover)
        # plan_space holds wave-key counts, bucketed as _wave_key buckets
        # them: a pooled key of an SSM or hybrid config is one it refuses
        pools = dict.fromkeys(
            (n_low + n_reuse, beta)
            for (n_low, n_reuse, beta) in (plan_space or ())
            if (n_low + n_reuse) > 0 and beta > 0)
        if pools and self.cfg.family in NO_MIXED_FAMILIES:
            self._refuse_mixed()
        if self.device.type == "cuda" and self._decodes_on_kernel():
            # sweep the decode kernel's cluster size at every B bucket's
            # cache shape before any key runs, as the reference does
            cfg = self.cfg
            for B in batch_buckets:
                autotune.tune_decode(B, sc.max_len, cfg.n_heads,
                                     cfg.head_dim, KV=cfg.n_kv_heads,
                                     dtype=sc.cache_dtype, device=self.device)
        with torch.no_grad():
            for B in batch_buckets:
                self._get_decode(B)(self._tokens(np.zeros((B, 1))), lens[0],
                                    self._state(B))
                for T in lens:
                    toks = self._tokens(np.zeros((B, T)))
                    self._get_prefill(T, 0, 0, B)(toks, self._state(B))
                    for (n_pool, beta) in pools:
                        self._get_prefill(T, n_pool, beta, B)(
                            toks, self._state(B),
                            self._pack_for(T, n_pool, 0))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.stats.finish_warmup(t0, before, time.perf_counter())

    def _decodes_on_kernel(self) -> bool:
        """Whether a decode step reads its caches through the decode
        kernel: every family with GQA attention layers (an SSM LM has
        none; MLA attends with einsums, as in the reference)."""
        return self.cfg.family != "ssm" and self.cfg.mla is None

    # ------------------------------------------------------------------
    def _form_wave(self) -> Optional[List[Request]]:
        if not self.queue:
            return None
        # waves are capped at the largest batch bucket: padding only
        # rounds up, so a larger wave would have no key
        cap = min(self.sc.max_batch, max(self.sc.b_buckets))
        wave, rest, _ = form_wave(self.queue, self._wave_key, cap)
        self.queue = rest
        return wave

    def _wave_key(self, r: Request) -> Tuple[int, int, int, int, bytes]:
        """(prompt bucket, bucketed n_low, bucketed n_reuse, beta,
        span-layout identity).  The mask CONTENT is part of the key:
        requests with equal counts but different span layouts need
        different packs and must not share a wave."""
        T = self._bucket(len(r.prompt))
        spans = r.low_spans()
        reuse = self._effective_reuse(r)
        n_reuse = int(reuse.shape[0])
        if spans.shape[0] == 0 and n_reuse == 0:
            return (T, 0, 0, 0, b"")
        n_low = self._bucketed_n_low(r)
        if n_low == 0 and n_reuse == 0:   # bucketed away: plain prefill
            return (T, 0, 0, 0, b"")
        return (T, n_low, n_reuse, r.beta, r.mask_key(n_low, reuse))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_wave(self, now: float = 0.0) -> List[Response]:
        """Serve one wave to completion.  Returns finished responses."""
        wave = self._form_wave()
        if wave is None:
            return []
        t0 = time.perf_counter()
        sc = self.sc
        T, n_low, n_reuse, beta, _ = self._wave_key(wave[0])
        B = len(wave)
        Bp = self.batch_bucket(B)

        toks = np.zeros((Bp, T), np.int32)
        for i, r in enumerate(wave):
            p = np.asarray(r.prompt, np.int32)
            toks[i, :len(p)] = p
            if len(p) < T:          # right-pad with the last prompt token
                toks[i, len(p):] = p[-1] if len(p) else 0
        toks[B:] = toks[0]

        state = self._state(Bp)
        if (n_low > 0 or n_reuse > 0) and beta > 0:
            r0 = wave[0]
            span_mask = (r0.low_span_mask if r0.low_span_mask is not None
                         else r0.reuse_span_mask)
            n_spans = int(np.asarray(span_mask).reshape(-1).shape[0])
            # effective reuse spans are POOLED alongside the low spans
            # (tokens are always transmitted on the sequence path)
            mask = np.zeros((n_spans,), np.int32)
            mask[r0.low_spans(n_low)] = 1
            mask[self._effective_reuse(r0)] = 1
            fn = self._get_prefill(T, n_low + n_reuse, beta, Bp)
            logits, state = fn(self._tokens(toks), state,
                               self._pack_for(T, n_low, n_reuse, mask))
        else:
            fn = self._get_prefill(T, 0, 0, Bp)
            logits, state = fn(self._tokens(toks), state)

        # refresh reuse sessions: effective reuse spans age by one, every
        # other span of a sessionful request resets (it was transmitted)
        for r in wave:
            if r.client_id >= 0 and r.reuse_span_mask is not None:
                n_sp = int(np.asarray(r.reuse_span_mask).reshape(-1)
                           .shape[0])
                self.session(r.client_id, n_sp).note(
                    self._effective_reuse(r), r.beta, int(now))

        decode = self._get_decode(Bp)
        resp = {r.rid: Response(rid=r.rid, slot=i, prefill_done=now)
                for i, r in enumerate(wave)}
        done = np.zeros((Bp,), bool)
        done[B:] = True                   # padded slots never emit tokens
        max_new = max(r.max_new_tokens for r in wave)
        tok = logits[:, -1, :].argmax(-1, keepdim=True)          # (Bp, 1)
        host = tok.cpu().numpy()
        for i, r in enumerate(wave):
            resp[r.rid].tokens.append(int(host[i, 0]))
            if r.eos_id is not None and host[i, 0] == r.eos_id:
                done[i] = True

        for step in range(1, max_new):
            pos = T + step - 1
            if pos >= sc.max_len or done.all():
                break
            logits, state = decode(tok, pos, state)
            tok = logits[:, -1, :].argmax(-1, keepdim=True)
            host = tok.cpu().numpy()
            for i, r in enumerate(wave):
                if done[i] or len(resp[r.rid].tokens) >= r.max_new_tokens:
                    done[i] = True
                    continue
                resp[r.rid].tokens.append(int(host[i, 0]))
                if r.eos_id is not None and host[i, 0] == r.eos_id:
                    done[i] = True

        wall = time.perf_counter() - t0
        self.wave_latencies.append(wall)
        out = []
        for r in wave:
            resp[r.rid].finished = now + wall
            self.responses[r.rid] = resp[r.rid]
            out.append(resp[r.rid])
        return out

    def run(self, now: float = 0.0) -> List[Response]:
        """Drain the queue."""
        out = []
        while self.queue:
            out.extend(self.run_wave(now))
        return out
