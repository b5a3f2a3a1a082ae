"""Plain PyTorch oracle of ``csrc/ssd_scan.cu``, and the Mamba-2 training
route: ``ssd_chunked`` is the port of ``repro.models.mamba2.ssd_chunked``
(the function the reference trains through and its serving prefill
computes), differentiable by autograd; ``models.mamba2`` re-exports it.
``ssd_scan_plain`` is the same function with the ``ssd_ops.ssd``
arguments."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]), init_state,
                       return_final_state=True)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                return_final_state: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """SSD over a full sequence.  x: (b, T, H, P); dt: (b, T, H)
    post-softplus step sizes; A: (H,) negative decay rates; Bm/Cm:
    (b, T, G, N).  Returns y (b, T, H, P) and, with
    ``return_final_state``, the final state (b, H, N, P)."""
    b, T, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    T0 = T
    if T % chunk:
        # zero-pad to a chunk multiple: dt = 0 rows are state-neutral
        # (dA = 0 -> decay 1, xbar = 0), so the recurrence is unaffected
        pad = chunk - T % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        T = T + pad
    nc = T // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, H, Pd).to(f32)
    dtc = dt.reshape(b, nc, chunk, H).to(f32)
    Bh = Bm.reshape(b, nc, chunk, G, N).to(f32).repeat_interleave(hpg, 3)
    Ch = Cm.reshape(b, nc, chunk, G, N).to(f32).repeat_interleave(hpg, 3)

    dA = dtc * A.to(f32)[None, None, None, :]        # (b,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                    # within-chunk log decay
    xbar = xc * dtc[..., None]

    # intra-chunk: Y[i] = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) xbar_j
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=x.device))
    ldec = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,i,j,H)
    ldec = ldec.masked_fill(~lmask[None, None, :, :, None], float("-inf"))
    scores = torch.einsum("bnihd,bnjhd->bnijh", Ch, Bh)
    Y = torch.einsum("bnijh,bnjhp->bnihp", scores * torch.exp(ldec), xbar)

    # chunk-local end states: S_loc = sum_j exp(cum_Q - cum_j) B_j xbar_j^T
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b,nc,Q,H)
    S_loc = torch.einsum("bnjhd,bnjhp->bnhdp", Bh * dec_to_end[..., None],
                         xbar)

    # inter-chunk recurrence over nc
    chunk_dec = torch.exp(cum[:, :, -1, :])                  # (b,nc,H)
    s = (torch.zeros((b, H, N, Pd), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_dec[:, c, :, None, None] + S_loc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                    # (b,nc,H,N,P)

    Y = Y + torch.einsum("bnihd,bnhdp->bnihp",
                         Ch * torch.exp(cum)[..., None], s_prevs)
    Y = Y.reshape(b, T, H, Pd)[:, :T0]
    return (Y, s) if return_final_state else Y
