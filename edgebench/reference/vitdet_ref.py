"""Plain float32 ViTDet with mixed-resolution restoration: the yardstick
that decides ``correct``.

It follows Li et al., "Exploring Plain ViT Backbones for Object
Detection" (ECCV 2022) as ViTMAlis serves it (§III): pre-norm ViT blocks
in N subsets of M, the first M-1 of each with window attention and the
last with global attention; a frame tiled into decision regions of
(w*d)^2 patches, each FULL (its d^2 windows at full resolution), LOW
(one window of the frame pooled by d, positions the mean of each d x d
group) or REUSE (no tokens; the tile the client's session captured
before is spliced in).  Before the global block of subset ``beta`` the
sequence is restored to full resolution (LOW windows upsampled nearest
neighbour), and the tokens there are the region tiles a session keeps.
A simple feature pyramid and an FCOS-style head give per-position class
probabilities and boxes.

Every operation is a plain ``torch`` call in float32, one frame at a
time, with no kernel, cache or padding: window attention runs on the
windows a plan transmits, global attention on every transmitted token.
The forward turns TF32 off for matmuls and cuDNN convolutions itself
(``float32_products``) and puts the flags back after, so it keeps
float32 products whatever the process set before.
``Arith(tf32=True)`` rounds the operands of every product (matmul and
convolution) to TF32 (10 explicit mantissa bits, round to nearest even)
and accumulates in float32, as the tensor cores' TF32 mode does: the
lower-precision control of a float32 configuration.

Weights are the tree ``edgebench/weights.py`` draws (q, k, v
projections side by side in ``w_qkv``; convolutions OIHW); anything
derived from them (the position layouts) is worked out here again.  This
module imports nothing of the program.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

FULL, LOW, REUSE = 0, 1, 2
STRIDES = (8, 16, 32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32, finite) rounded to TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


@contextlib.contextmanager
def float32_products() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions inside, the flags as
    they were after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (cuda.allow_tf32, cudnn.allow_tf32)
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = was


@dataclass(frozen=True)
class Arith:
    """The precision of the products: float32, or TF32 operands."""
    tf32: bool = False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.r(a), self.r(b))

    def conv(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        w = p["w"]
        return F.conv2d(self.r(x), self.r(w), p["b"], padding=w.shape[-1] // 2)


@dataclass(frozen=True)
class Geometry:
    """Sizes of the configuration file's ``sizes``."""
    n_layers: int
    d_model: int
    n_heads: int
    head_dim: int
    img: int
    patch: int
    window: int
    n_subsets: int
    down: int
    eps: float

    @classmethod
    def from_sizes(cls, s: Dict) -> "Geometry":
        return cls(s["n_layers"], s["d_model"], s["n_heads"], s["head_dim"],
                   s["img_size"], s["patch_size"], s["window_size"],
                   s["n_subsets"], s["downsample"], s["norm_eps"])

    @property
    def grid(self) -> int:              # patches a side
        return self.img // self.patch

    @property
    def region(self) -> int:            # patches a region side
        return self.window * self.down

    @property
    def regions_w(self) -> int:
        return self.grid // self.region

    @property
    def n_regions(self) -> int:
        return self.regions_w ** 2

    @property
    def per_subset(self) -> int:
        return self.n_layers // self.n_subsets


@dataclass
class Outputs:
    """One frame's head, decoded densely: ``probs`` (N, classes) are
    sigmoid(class) * sigmoid(centerness) at each of the N positions of
    the three levels (stride 8, 16, 32; row-major), ``boxes`` (N, 4)
    xyxy in pixels; ``tiles`` (n_regions, d^2, w^2, D) the restored
    tokens entering the global block of subset beta, or None."""
    probs: torch.Tensor
    boxes: torch.Tensor
    tiles: Optional[torch.Tensor] = None

    def top_k(self, k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        best, cls = self.probs.max(dim=-1)
        s, i = torch.topk(best, k)
        return self.boxes[i], s, cls[i]


class ViTDetRef:
    """The plain forward over weights ``w`` of geometry ``g``."""

    def __init__(self, g: Geometry, w: Dict, arith: Arith = Arith()):
        self.g, self.w, self.ar = g, w, arith
        pos = w["pos_emb"].float()
        self.pos = pos
        self.pos_low = pool_grid(pos, g.down)

    # -- tokens ---------------------------------------------------------

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) pixels -> (H/p, W/p, D) patch embeddings."""
        g, p = self.g, self.g.patch
        H, W, C = img.shape
        x = img.reshape(H // p, p, W // p, p, C).permute(0, 2, 1, 3, 4)
        x = x.reshape(H // p, W // p, p * p * C)
        pe = self.w["patch_embed"]
        return self.ar.mm(x, pe["w"].float()) + pe["b"].float()

    def transmitted_windows(self, img: torch.Tensor, states
                            ) -> Tuple[torch.Tensor, list]:
        """The plan's windows (n, w^2, D), positions added, and for each
        its (region, kind, sub-window)."""
        g, w, R = self.g, self.g.window, self.g.region
        full = self.embed(img) + self.pos
        low = None
        if (states == LOW).any():
            low = self.embed(pool_grid(img, g.down)) + self.pos_low
        wins, meta = [], []
        for r in range(g.n_regions):
            ry, rx = divmod(r, g.regions_w)
            if states[r] == FULL:
                for k in range(g.down * g.down):
                    wy, wx = divmod(k, g.down)
                    y, x = ry * R + wy * w, rx * R + wx * w
                    wins.append(full[y:y + w, x:x + w].reshape(w * w, -1))
                    meta.append((r, FULL, k))
            elif states[r] == LOW:
                wins.append(low[ry * w:(ry + 1) * w,
                                rx * w:(rx + 1) * w].reshape(w * w, -1))
                meta.append((r, LOW, 0))
        return torch.stack(wins), meta

    def restore(self, x: torch.Tensor, meta: list,
                reuse: Dict[int, torch.Tensor]) -> torch.Tensor:
        """Windows (n, w^2, D) -> region tiles (nR, d^2, w^2, D): FULL
        windows in place, LOW windows upsampled, REUSE tiles spliced."""
        g, w, d = self.g, self.g.window, self.g.down
        D = x.shape[-1]
        tiles = x.new_zeros((g.n_regions, d * d, w * w, D))
        for i, (r, kind, k) in enumerate(meta):
            if kind == FULL:
                tiles[r, k] = x[i]
            else:
                up = x[i].reshape(w, w, D).repeat_interleave(d, 0)
                up = up.repeat_interleave(d, 1)          # (d w, d w, D)
                up = up.reshape(d, w, d, w, D).permute(0, 2, 1, 3, 4)
                tiles[r] = up.reshape(d * d, w * w, D)
        for r, t in reuse.items():
            tiles[r] = t.float()
        return tiles

    # -- blocks ---------------------------------------------------------

    def layer_norm(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), p["w"].float(),
                            p["b"].float(), self.g.eps)

    def attention(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        """h: (G, T, D) groups of tokens attending within each group."""
        G, T, D = h.shape
        H, Dh = self.g.n_heads, self.g.head_dim
        qkv = self.ar.mm(h, p["w_qkv"].float()) + p["b_qkv"].float()
        q, k, v = qkv.split(H * Dh, dim=-1)
        q, k, v = (t.reshape(G, T, H, Dh).transpose(1, 2) for t in (q, k, v))
        s = self.ar.mm(q, k.transpose(-1, -2)) * Dh ** -0.5
        o = self.ar.mm(torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(G, T, H * Dh)
        return self.ar.mm(o, p["w_o"].float()) + p["b_o"].float()

    def block(self, p: Dict, x: torch.Tensor, is_global: bool
              ) -> torch.Tensor:
        """x: (n windows, w^2, D); global blocks attend over all."""
        n, T, D = x.shape
        h = self.layer_norm(x, p["ln1"])
        h = h.reshape(1, n * T, D) if is_global else h
        x = x + self.attention(p["attn"], h).reshape(n, T, D)
        h = self.layer_norm(x, p["ln2"])
        f = p["ffn"]
        u = F.gelu(self.ar.mm(h, f["w_up"].float()) + f["b_up"].float(),
                   approximate="tanh")
        return x + self.ar.mm(u, f["w_down"].float()) + f["b_down"].float()

    # -- whole frames ---------------------------------------------------

    def forward(self, img: torch.Tensor, states, beta: int,
                reuse: Optional[Dict[int, torch.Tensor]] = None,
                stop_at_restore: bool = False) -> Outputs:
        """One frame under a plan (``states`` (n_regions,) FULL / LOW /
        REUSE) restoring at ``beta`` (1..N; an all-FULL plan restores
        nothing, so its ``beta`` only says where ``tiles`` is read).
        ``reuse`` maps each REUSE region to its tile.  With
        ``stop_at_restore`` only ``tiles`` is computed."""
        with float32_products():
            return self._forward(img, states, beta, reuse, stop_at_restore)

    def _forward(self, img, states, beta, reuse, stop_at_restore
                 ) -> Outputs:
        g = self.g
        M = g.per_subset
        x, meta = self.transmitted_windows(img.float(), states)
        tiles = None
        restore_at = beta * M - 1
        for i in range(g.n_layers):
            if i == restore_at:
                tiles = self.restore(x, meta, reuse or {})
                if stop_at_restore:
                    return Outputs(None, None, tiles)
                x = tiles.reshape(-1, *tiles.shape[2:])
            x = self.block(self.w["blocks"][i], x, i % M == M - 1)
        x = self.layer_norm(x, self.w["final_norm"])
        probs, boxes = self.head(self.to_grid(x))
        return Outputs(probs, boxes, tiles)

    def to_grid(self, x: torch.Tensor) -> torch.Tensor:
        """Region-major windows (nR d^2, w^2, D) -> (Hp, Wp, D)."""
        g, w, d = self.g, self.g.window, self.g.down
        n = g.regions_w
        x = x.reshape(n, n, d, d, w, w, -1).permute(0, 2, 4, 1, 3, 5, 6)
        return x.reshape(g.grid, g.grid, -1)

    def head(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pyramid (stride 8 by nearest 2x, 16, 32 by 2x mean pool), the
        shared head, and the dense decode."""
        hp, ar = self.w["head"], self.ar
        x16 = feats.permute(2, 0, 1)[None]
        levels = [x16.repeat_interleave(2, 2).repeat_interleave(2, 3), x16,
                  F.avg_pool2d(x16, 2)]
        probs, boxes = [], []
        for i, x in enumerate(levels):
            x = ar.conv(x, hp["lateral"][i])
            x = torch.relu(ar.conv(x, hp["smooth"][i]))
            t = torch.relu(ar.conv(x, hp["tower"]))
            cls = ar.conv(t, hp["cls"])[0].permute(1, 2, 0)
            ctr = ar.conv(t, hp["ctr"])[0].permute(1, 2, 0)
            ltrb = F.softplus(ar.conv(t, hp["box"]))[0].permute(1, 2, 0)
            H, W = cls.shape[:2]
            s = STRIDES[i]
            ys, xs = torch.meshgrid(torch.arange(H, device=x.device),
                                    torch.arange(W, device=x.device),
                                    indexing="ij")
            cx, cy = (xs.float() + 0.5) * s, (ys.float() + 0.5) * s
            ltrb = ltrb * s
            box = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                               cx + ltrb[..., 2], cy + ltrb[..., 3]], -1)
            probs.append((torch.sigmoid(cls) * torch.sigmoid(ctr))
                         .reshape(H * W, -1))
            boxes.append(box.reshape(H * W, 4))
        return torch.cat(probs), torch.cat(boxes)


def pool_grid(x: torch.Tensor, d: int) -> torch.Tensor:
    """Mean over d x d groups of an (H, W, C) grid."""
    H, W, C = x.shape
    return x.reshape(H // d, d, W // d, d, C).mean(dim=(1, 3))


def reuse_sources(history, k: int) -> Dict[int, int]:
    """Session replay: for each REUSE region of offload ``k`` of a
    client's ``history`` (plans in the order sent, the first a FULL
    bootstrap), the offload that last transmitted it, whose tile the
    session holds."""
    src = {}
    for r in (history[k] == REUSE).nonzero()[0].tolist():
        j = k - 1
        while history[j][r] == REUSE:
            j -= 1
        if j < 0:
            raise ValueError(f"offload {k}: region {r} never transmitted")
        src[r] = j
    return src
