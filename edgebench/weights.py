"""The weights a run serves, drawn by the benchmark from the seed.

Both sides get this one tree: the program (which derives its position
layouts from ``pos_emb`` itself) and the plain reference (which derives
its own).  Nothing of it comes from the program, so a program that
drops or misplaces a bias, or whose layer norm ignores its scale or
shift, serves other answers than the reference.

Layout (the one ``ServerModel`` and ``reference.vitdet_ref`` read): dense
weights (in, out), q, k and v side by side in ``w_qkv``; convolutions
(out, in, k, k).  Distributions: dense and convolution weights
truncated normal in (-2, 2), std 1 / sqrt(fan_in); the positional grid
normal, std 0.02; every bias and norm shift normal, std ``BIAS_STD``;
every norm scale 1 plus normal, std ``BIAS_STD``; the class bias around
-4 (the focal prior), so scores stay in the range a detector starts at.

Each kind of leaf is drawn in one call on the device, in float32, and
the leaves are views of those few buffers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BIAS_STD = 0.1
POS_STD = 0.02
CLS_PRIOR = -4.0


def shapes(s: Dict) -> Tuple[List, List, List]:
    """The tree's leaves by kind, as (path, shape, fan_in) for the
    weights and (path, shape) for the biases and the norm scales."""
    D, F_, C = s["d_model"], s["d_ff"], s["out_channels"]
    Q = s["n_heads"] * s["head_dim"]
    dense, bias, scale = [], [], []

    def norm(path):
        scale.append((path + ("w",), (D,)))
        bias.append((path + ("b",), (D,)))

    def conv(path, k, cin, cout):
        dense.append((path + ("w",), (cout, cin, k, k), k * k * cin))
        bias.append((path + ("b",), (cout,)))

    p = s["patch_size"]
    dense.append((("patch_embed", "w"), (p * p * 3, D), p * p * 3))
    bias.append((("patch_embed", "b"), (D,)))
    for i in range(s["n_layers"]):
        b = ("blocks", i)
        norm(b + ("ln1",))
        norm(b + ("ln2",))
        dense += [(b + ("attn", "w_qkv"), (D, 3 * Q), D),
                  (b + ("attn", "w_o"), (Q, D), Q),
                  (b + ("ffn", "w_up"), (D, F_), D),
                  (b + ("ffn", "w_down"), (F_, D), F_)]
        bias += [(b + ("attn", "b_qkv"), (3 * Q,)),
                 (b + ("attn", "b_o"), (D,)),
                 (b + ("ffn", "b_up"), (F_,)),
                 (b + ("ffn", "b_down"), (D,))]
    norm(("final_norm",))
    h = ("head",)
    for i in range(3):
        conv(h + ("lateral", i), 1, D, C)
        conv(h + ("smooth", i), 3, C, C)
    conv(h + ("tower",), 3, C, C)
    conv(h + ("cls",), 3, C, s["n_classes"])
    conv(h + ("box",), 3, C, 4)
    conv(h + ("ctr",), 3, C, 1)
    return dense, bias, scale


def _put(tree: Dict, path: tuple, leaf: torch.Tensor) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def _views(buf: torch.Tensor, leaves) -> List[torch.Tensor]:
    out, at = [], 0
    for leaf in leaves:
        n = math.prod(leaf[1])
        out.append(buf[at:at + n].view(leaf[1]))
        at += n
    return out


def draw(sizes: Dict, seed: int, device) -> Dict:
    """The raw tree of ``sizes`` (a configuration file's ``sizes``) from
    ``seed``, in float32 on ``device``."""
    dense, bias, scale = shapes(sizes)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def buffer(leaves):
        return torch.empty(sum(math.prod(x[1]) for x in leaves), device=dev)

    w = buffer(dense)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    b = buffer(bias).normal_(0.0, BIAS_STD, generator=g)
    sc = buffer(scale).normal_(1.0, BIAS_STD, generator=g)
    grid = sizes["img_size"] // sizes["patch_size"]
    pos = torch.empty((grid, grid, sizes["d_model"]), device=dev)
    pos.normal_(0.0, POS_STD, generator=g)

    tree: Dict = {"pos_emb": pos}
    for leaf, v in zip(dense, _views(w, dense)):
        v.mul_(1.0 / math.sqrt(leaf[2]))
        _put(tree, leaf[0], v)
    for leaf, v in zip(bias, _views(b, bias)):
        if leaf[0] == ("head", "cls", "b"):
            v.add_(CLS_PRIOR)
        _put(tree, leaf[0], v)
    for leaf, v in zip(scale, _views(sc, scale)):
        _put(tree, leaf[0], v)
    return tree
