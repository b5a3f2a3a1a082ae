"""Mixed-resolution frame codec (device-side encode, server-side decode).

JPEG-like pipeline, reproducible in pure numpy (DESIGN.md hardware
adaptation: libjpeg -> 8x8 DCT + quality-scaled quantization + zlib
entropy stage, so compressed sizes are content- and quality-dependent
exactly as the paper's MLP^size estimator requires).

Encoding a mixed-resolution frame (paper Fig. 3): full-resolution regions
are coded at their native pixels; regions marked for downsampling are
average-pooled by ``d`` first.  The payload is the concatenation of both
streams plus the binary region mask, mirroring the single mixed-res image
the prototype transmits.

Temporal region reuse (core.partition.RegionPlan): regions marked REUSE
(``reuse_mask``) are skipped ENTIRELY — zero payload bytes, no DCT work,
and their canvas area is filled with neutral gray on the decoded frame
(the server restores them from cached backbone features, never from
pixels).  The delay models scale with transmitted regions only.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.partition import Partition

# JPEG luminance quantization table
_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)


def _quality_table(quality: int) -> np.ndarray:
    q = max(1, min(int(quality), 100))
    s = 5000 / q if q < 50 else 200 - 2 * q
    tbl = np.floor((_Q50 * s + 50) / 100)
    return np.clip(tbl, 1, 255).astype(np.float32)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.sqrt(2.0 / 8.0) * np.cos((2 * k[None, :] + 1) * k[:, None]
                                    * np.pi / 16.0)
    c[0] *= 1.0 / np.sqrt(2.0)
    return c.astype(np.float32)


_DCT = _dct_matrix()
_ZIG = np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                 (i // 8 + i % 8) % 2 == 0
                                                 and i % 8 or -(i % 8))))


def _blockify(img: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8 * W/8, 8, 8)."""
    H, W = img.shape
    x = img.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)
    return x.reshape(-1, 8, 8)


def _unblockify(blocks: np.ndarray, H: int, W: int) -> np.ndarray:
    x = blocks.reshape(H // 8, W // 8, 8, 8).transpose(0, 2, 1, 3)
    return x.reshape(H, W)


def _quantize_plane(plane: np.ndarray, quality: int) -> np.ndarray:
    """DCT-quantize one plane -> zigzag-scanned int16 coefficients."""
    tbl = _quality_table(quality)
    blocks = _blockify(plane * 255.0 - 128.0)
    coef = np.einsum("ij,njk,lk->nil", _DCT, blocks, _DCT)
    q = np.round(coef / tbl).astype(np.int16)
    # zigzag scan improves run-length behaviour for zlib
    return q.reshape(-1, 64)[:, _ZIG]


def _plane_payload(zz: np.ndarray) -> bytes:
    return zlib.compress(zz.astype(np.int16).tobytes(), level=6)


def _encode_plane(plane: np.ndarray, quality: int
                  ) -> Tuple[bytes, np.ndarray]:
    """DCT-quantize one plane; returns (compressed bytes, dequantized)."""
    tbl = _quality_table(quality)
    zz = _quantize_plane(plane, quality)
    payload = _plane_payload(zz)
    deq = (zz[:, np.argsort(_ZIG)].reshape(-1, 8, 8) * tbl)
    rec = np.einsum("ji,njk,kl->nil", _DCT, deq, _DCT)
    rec = (rec + 128.0) / 255.0
    return payload, _unblockify(rec, *plane.shape)


@dataclass
class EncodedFrame:
    payload_bytes: int
    mask: np.ndarray                 # (n_regions,) int32
    quality: int
    streams: List[bytes]
    shapes: Dict


class MixedResCodec:
    def __init__(self, part: Partition, patch_px: int, downsample: int):
        self.part = part
        self.patch_px = patch_px
        self.d = downsample

    def region_px(self) -> int:
        return self.part.region * self.patch_px

    # ------------------------------------------------------------------
    def _header_bytes(self, mask: np.ndarray,
                      reuse_mask: Optional[np.ndarray]) -> int:
        """Mask bits + header; the three-state plan costs one extra bit
        row when any region is reused."""
        total = len(mask) // 8 + 1 + 16
        if reuse_mask is not None and np.asarray(reuse_mask).any():
            total += len(mask) // 8 + 1
        return total

    def _region_plane(self, gray: np.ndarray, j: int,
                      low: bool) -> np.ndarray:
        rpx = self.region_px()
        ry, rx = divmod(j, self.part.regions_w)
        region = gray[ry * rpx:(ry + 1) * rpx, rx * rpx:(rx + 1) * rpx]
        if low:
            region = region.reshape(rpx // self.d, self.d,
                                    rpx // self.d, self.d).mean(axis=(1, 3))
        return region

    def encode(self, frame: np.ndarray, mask: np.ndarray, quality: int,
               reuse_mask: Optional[np.ndarray] = None
               ) -> Tuple[EncodedFrame, np.ndarray]:
        """Encode with region mask; also returns the server-side decoded
        mixed frame (full canvas with low regions decoded-upsampled) for
        accuracy evaluation.  Regions set in ``reuse_mask`` transmit
        nothing (empty stream, gray canvas fill)."""
        rpx = self.region_px()
        gray = frame.mean(axis=-1)          # luma-only codec (3x cheaper)
        decoded = frame.copy()
        streams: List[bytes] = []
        total = self._header_bytes(mask, reuse_mask)
        chroma_factor = 1.5                 # subsampled chroma cost model
        reuse = (np.zeros(len(mask), bool) if reuse_mask is None
                 else np.asarray(reuse_mask).astype(bool))

        for j, low in enumerate(np.asarray(mask).astype(bool)):
            ry, rx = divmod(j, self.part.regions_w)
            y0, x0 = ry * rpx, rx * rpx
            if reuse[j]:
                # REUSE: zero payload; the server never reads these pixels
                streams.append(b"")
                decoded[y0:y0 + rpx, x0:x0 + rpx] = 0.5
                continue
            r = self._region_plane(gray, j, low)
            payload, rec = _encode_plane(r, quality)
            streams.append(payload)
            total += int(len(payload) * chroma_factor)
            if low:
                rec = np.repeat(np.repeat(rec, self.d, axis=0), self.d,
                                axis=1)
            # luma-corrected reconstruction: scale rgb by luma ratio
            patch = frame[y0:y0 + rpx, x0:x0 + rpx]
            luma = patch.mean(axis=-1, keepdims=True)
            ratio = np.clip(rec[..., None] / np.maximum(luma, 1e-3),
                            0.25, 4.0)
            decoded[y0:y0 + rpx, x0:x0 + rpx] = np.clip(patch * ratio, 0, 1)

        enc = EncodedFrame(payload_bytes=total, mask=np.asarray(mask),
                           quality=quality, streams=streams,
                           shapes={"rpx": rpx})
        return enc, decoded

    def encode_size_only(self, frame: np.ndarray, mask: np.ndarray,
                         quality: int,
                         reuse_mask: Optional[np.ndarray] = None) -> int:
        """Payload size of :meth:`encode` without the decode work.

        Runs only the forward half of the pipeline (pool + DCT + quantize
        + entropy length) — no dequantize, no inverse DCT, no
        reconstruction — so estimator profiling can sweep configs at a
        fraction of ``encode``'s cost.  Byte-for-byte identical totals.
        """
        gray = frame.mean(axis=-1)
        total = self._header_bytes(mask, reuse_mask)
        chroma_factor = 1.5
        reuse = (np.zeros(len(mask), bool) if reuse_mask is None
                 else np.asarray(reuse_mask).astype(bool))
        for j, low in enumerate(np.asarray(mask).astype(bool)):
            if reuse[j]:
                continue
            payload = _plane_payload(
                _quantize_plane(self._region_plane(gray, j, low), quality))
            total += int(len(payload) * chroma_factor)
        return total


# ---------------------------------------------------------------------------
# codec delay model (the paper profiles T_enc(N_d, lambda) offline on the
# device and uses a mean T_dec; we do the same with a calibrated analytic
# model of our codec on the reference mobile SoC)


@dataclass(frozen=True)
class CodecDelayModel:
    """Delays in seconds.  Calibrated against the paper's Fig. 10 medians
    (total codec delay ~30 ms for full-res 1080p at q95 on the Jetson).

    Costs scale with TRANSMITTED regions only: a LOW region costs
    ``1/d^2`` of a full region, a REUSE region costs nothing (it is
    skipped before the DCT stage)."""
    enc_base: float = 0.0145          # full-res encode at q<=95
    dec_base: float = 0.0150          # full-res decode
    quality_slope: float = 0.004      # extra cost toward q100 (entropy len)
    mixed_overhead: float = 0.004     # mask + dual-stream preprocessing

    def _work_frac(self, part: Partition, n_low: int, n_reuse: int) -> float:
        frac = (1.0 - n_low * (1 - 1 / (part.downsample ** 2))
                / part.n_regions - n_reuse / part.n_regions)
        return max(frac, 0.0)

    def encode_delay(self, part: Partition, n_low: int,
                     quality: int, n_reuse: int = 0) -> float:
        q_extra = self.quality_slope * max(quality - 95, 0) / 5.0
        over = self.mixed_overhead if (n_low > 0 or n_reuse > 0) else 0.0
        return ((self.enc_base + q_extra)
                * self._work_frac(part, n_low, n_reuse) + over)

    def decode_delay(self, part: Partition, n_low: int,
                     n_reuse: int = 0) -> float:
        return self.dec_base * self._work_frac(part, n_low, n_reuse)
