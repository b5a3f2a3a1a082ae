"""Dense prediction head (simple ViTDet feature pyramid + FCOS-lite head)
and the top-k decode; port of ``repro.core.det_head`` forward and decode.

The pyramid is built from the backbone's stride-16 map: stride 8 by 2x
nearest upsample, stride 16 identity, stride 32 by 2x average pool, each
followed by a 1x1 lateral conv and a 3x3 conv; the shared head predicts
class logits, ltrb box offsets (in stride units) and centerness.

The reference's SAME convolutions are NHWC with HWIO weights; here they
are ``F.conv2d`` in NCHW with OIHW weights (converted once in
``repro_torch.convert``).  Inputs and outputs stay NHWC.  cuDNN runs
float32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32``
is False; ``core.vit_backbone.forward_det`` clears it (and the matmul
flag) so the head keeps the reference's float32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.quant import qtensor as qt

STRIDES = (8, 16, 32)


def conv2d(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """NCHW SAME conv (odd square kernel), OIHW weight ``p["w"]``.  An
    int8 QuantTensor weight (scales per output channel O) dequantizes at
    entry, as the reference's does: the int8 gain in the head is the
    smaller resident weight, not an int8 convolution."""
    w = qt.asarray(p["w"])
    return F.conv2d(x, w, p["b"], padding=w.shape[-1] // 2)


def det_head_forward(cfg: ModelConfig, p, feats: torch.Tensor
                     ) -> List[Dict[str, torch.Tensor]]:
    """feats: (B, Hp, Wp, D) stride-16 map -> per-level head outputs
    (``cls`` (B, H, W, n_classes), ``box`` (B, H, W, 4), ``ctr``
    (B, H, W, 1), NHWC, and the level's ``stride``)."""
    x16 = feats.permute(0, 3, 1, 2)
    levels = [x16.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3),
              x16, F.avg_pool2d(x16, 2)]
    outs = []
    for i, x in enumerate(levels):
        x = conv2d(x, p["lateral"][i])
        x = torch.relu(conv2d(x, p["smooth"][i]))
        t = torch.relu(conv2d(x, p["tower"]))
        outs.append({
            "cls": conv2d(t, p["cls"]).permute(0, 2, 3, 1),
            "box": F.softplus(conv2d(t, p["box"])).permute(0, 2, 3, 1),
            "ctr": conv2d(t, p["ctr"]).permute(0, 2, 3, 1),
            "stride": STRIDES[i],
        })
    return outs


def decode_detections(cfg: ModelConfig, outputs, top_k: int = 64,
                      score_thresh: float = 0.3
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns boxes (B,K,4) xyxy in pixels, scores (B,K), classes (B,K).
    Slots below ``score_thresh`` have score 0 (static shapes, no NMS)."""
    all_scores, all_boxes, all_cls = [], [], []
    for out in outputs:
        B, H, W, _ = out["cls"].shape
        stride = out["stride"]
        dev = out["cls"].device
        prob = torch.sigmoid(out["cls"].float()) * \
            torch.sigmoid(out["ctr"].float())
        ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        cx = (xs.float() + 0.5) * stride
        cy = (ys.float() + 0.5) * stride
        ltrb = out["box"].float() * stride
        boxes = torch.stack([cx[None] - ltrb[..., 0], cy[None] - ltrb[..., 1],
                             cx[None] + ltrb[..., 2], cy[None] + ltrb[..., 3]],
                            dim=-1)                     # (B,H,W,4)
        score, cls = prob.max(dim=-1)                   # (B,H,W)
        all_scores.append(score.reshape(B, H * W))
        all_boxes.append(boxes.reshape(B, H * W, 4))
        all_cls.append(cls.reshape(B, H * W))
    scores = torch.cat(all_scores, dim=1)
    boxes = torch.cat(all_boxes, dim=1)
    classes = torch.cat(all_cls, dim=1)
    top_s, top_i = torch.topk(scores, top_k, dim=1)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    top_c = torch.gather(classes, 1, top_i)
    top_s = torch.where(top_s >= score_thresh, top_s, torch.zeros_like(top_s))
    return top_b, top_s, top_c
