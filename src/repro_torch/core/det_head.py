"""Dense prediction head (simple ViTDet feature pyramid + FCOS-lite
head), the FCOS-lite training loss and the top-k decode; port of
``repro.core.det_head``.

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
    smaller resident weight, not an int8 convolution.  ``x`` takes the
    weight's type (the half lanes: cuDNN's fp16 / bf16 convolution)."""
    w = qt.asarray(p["w"])
    return F.conv2d(x.to(w.dtype), w, p["b"], padding=w.shape[-1] // 2)


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


# ---------------------------------------------------------------------------
# loss (FCOS-lite): focal BCE on class, L1 on ltrb at positives, BCE ctr


def _focal_bce(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    # stable form: log-sigmoid everywhere and pt = exp(-ce); the naive
    # log(p + eps) form is finite in value but its backward gives NaN
    # for saturated logits (0 * inf in the chain rule)
    x = logits.float()
    log_p = F.logsigmoid(x)
    log_1mp = F.logsigmoid(-x)
    ce = -(targets * log_p + (1 - targets) * log_1mp)
    pt = torch.exp(-ce)
    w = (targets * alpha + (1 - targets) * (1 - alpha)) * (1 - pt) ** gamma
    return w * ce


def det_loss(cfg: ModelConfig, outputs, targets
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-level head outputs and targets -> (loss, metrics).  targets:
    per-level dicts ``{"cls": (B,H,W,nc), "box": (B,H,W,4), "pos":
    (B,H,W,1)}`` (``data.synthetic_video.render_targets``, stacked);
    an optional ``"ctr"`` replaces ``pos`` as the centerness target."""
    total_cls = total_box = total_ctr = 0.0
    n_pos = 0.0
    for out, tgt in zip(outputs, targets):
        total_cls = total_cls + torch.sum(_focal_bce(out["cls"], tgt["cls"]))
        pos = tgt["pos"].float()
        n_pos = n_pos + torch.sum(pos)
        total_box = total_box + torch.sum(
            torch.abs(out["box"] - tgt["box"]) * pos)
        ctr_t = tgt.get("ctr", pos)
        total_ctr = total_ctr + torch.sum(
            _focal_bce(out["ctr"], ctr_t, alpha=0.5, gamma=0.0) * pos)
    # clamp the normaliser at 1: a frame whose objects all fall outside
    # the stride bands has no positives, and dividing by ~0 explodes the
    # focal term (one such frame poisons the step with NaN gradients)
    n_pos = torch.clamp(n_pos, min=1.0)
    loss = (total_cls + total_box + total_ctr) / n_pos
    return loss, {"cls": total_cls / n_pos, "box": total_box / n_pos,
                  "n_pos": n_pos}


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
