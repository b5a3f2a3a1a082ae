"""Parameter / activation / cache sharding specs for every arch family,
and the storage they describe; port of ``repro.distributed.sharding``.

Layout (the reference's):
  * ``model`` axis: attention heads and FFN hidden, vocab-parallel
    embedding / logits, expert-parallel MoE slabs.
  * ``data`` axis: FSDP, the other dim of every large matrix.
  * ``pod`` axis (multi-pod): pure data parallelism; the batch shards
    over ("pod", "data") and parameters are replicated across pods.

Specs.  A :class:`Spec` is a tuple of per-dim entries, each ``None``, an
axis name, or a tuple of names, so that a spec tree compares with the
reference's ``PartitionSpec`` trees entry for entry.  ``fix_spec`` works
from the mesh's axis sizes alone (a ``DeviceMesh`` or a plain
``{axis: size}`` mapping), so spec trees for the production meshes are
built without devices.

Storage.  :func:`to_placements` turns a spec into
``torch.distributed.tensor`` placements (``Shard(i)`` on each mesh dim
that splits tensor dim i, ``Replicate()`` elsewhere), and
:func:`shard_leaf` keeps the rank's local piece of a full tensor, the
``DTensor.to_local()`` of ``distribute_tensor`` under those placements.
:func:`gather_leaf` all-gathers a local piece back to full size (or to a
partly sharded target); its backward reduce-scatters the gradient, a sum,
to the piece's layout.  :class:`Gathered` is a read-only view of a local
tree that gathers each leaf where the model code reads it, so a block
holds its full weights only while it runs (and again when remat
recomputes it).

Gradient convention on a mesh: every rank's loss is its term of a sum
whose total is the global loss, and every collective's backward is its
adjoint (all-gather <-> reduce-scatter, all-reduce <-> all-reduce).  So
a leaf's local gradient is its share of the global gradient summed over
the ranks that gather it; a leaf replicated over an axis sums its
gradient over that axis afterwards (``train.trainer``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig

STACK_KEYS = ("dense_blocks", "moe_blocks", "mamba_blocks", "enc_blocks",
              "dec_blocks", "blocks")
# the port fuses q / k / v (and their biases) into one leaf; its spec is
# the reference's for w_q (b_q): the three share it
REF_NAMES = {"w_qkv": "w_q", "b_qkv": "b_q"}

Entry = Union[None, str, Tuple[str, ...]]


class Spec:
    """Per-dim sharding entries, as ``jax.sharding.PartitionSpec(*e)``:
    iterates, indexes and compares as the tuple of its entries, a
    one-name tuple entry read as the name (as ``PartitionSpec`` reads
    it).  Not a tuple itself, so that tree walks
    (``checkpoint.flatten``) keep a spec as one leaf."""
    __slots__ = ("entries",)

    def __init__(self, *entries: Entry):
        self.entries = tuple(e[0] if isinstance(e, (tuple, list))
                             and len(e) == 1 else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Spec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"Spec{self.entries!r}"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: Spec


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of a mapping that stands for
    one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axis(mesh) -> str:
    return "data"


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the global batch."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh_shape(mesh)[a]
    return n


# ---------------------------------------------------------------------------
# parameter specs


def _leaf_spec(names: Tuple[str, ...], ndim: int, cfg: ModelConfig) -> Spec:
    """Spec for an UNSTACKED leaf identified by its reference path names
    (the reference's table, entry for entry)."""
    nm = names[-1]
    ctx = names[:-1]
    F, D_ = "data", "model"          # fsdp axis / tensor axis shorthands

    if ndim <= 1:
        if nm in ("conv_b",):
            return Spec(D_)
        return Spec()

    if "moe" in ctx or nm == "router" or ndim == 3:
        # MoE expert slabs (E, D, F') / (E, F', D): experts over model
        if nm == "router":
            return Spec(F, None)
        if nm == "w_down":
            return Spec(D_, None, F)
        if nm in ("w_gate", "w_up"):
            return Spec(D_, F, None)

    if "shared" in ctx:              # deepseek shared experts = dense TP FFN
        if nm == "w_down":
            return Spec(D_, F)
        return Spec(F, D_)

    table = {
        "tok": Spec(D_, F),                     # vocab-parallel
        "dec_pos": Spec(None, F),
        "pos_emb": Spec(None, None, None),
        "w_q": Spec(F, D_), "w_k": Spec(F, D_), "w_v": Spec(F, D_),
        "w_o": Spec(D_, F),
        "w_dq": Spec(F, None), "w_uq": Spec(None, D_),
        "w_dkv": Spec(F, None), "w_uk": Spec(None, D_), "w_uv": Spec(None, D_),
        "w_gate": Spec(F, D_), "w_up": Spec(F, D_), "w_down": Spec(D_, F),
        "w_in": Spec(F, D_), "w_out": Spec(D_, F), "conv_w": Spec(None, D_),
        "w": Spec(F, D_),                       # lm_head.w (D, V)
        "w1": Spec(None, D_), "w2": Spec(D_, F),
        "b": Spec(),
    }
    if nm in table:
        spec = table[nm]
        return spec if len(spec) == ndim else Spec(*([None] * ndim))
    return Spec(*([None] * ndim))


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axes_size(sizes: Dict[str, int], entry: Entry) -> int:
    n = 1
    for a in _axes(entry):
        n *= sizes[a]
    return n


def fix_spec(mesh, spec: Spec, shape: Tuple[int, ...]) -> Spec:
    """Make ``spec`` valid for ``shape``: every sharded dim divisible by
    its axis size.  Offending axes move to another (unsharded, divisible)
    dim, trailing dims first and never dim 0 of a >= 4-d leaf, else they
    are dropped (the reference's rule)."""
    sizes = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    homeless = []
    for i, e in enumerate(entries):
        if e is not None and shape[i] % _axes_size(sizes, e):
            homeless.append(e)
            entries[i] = None
    for e in homeless:
        lo = 1 if len(shape) >= 4 else 0
        for i in reversed(range(lo, len(entries))):
            n = _axes_size(sizes, e)
            if entries[i] is None and shape[i] % n == 0 and shape[i] >= n:
                entries[i] = e
                break
    return Spec(*entries)


def _map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists,
    tuples and named tuples (``rest`` trees share its structure)."""
    if not isinstance(tree, (dict, list, tuple)):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, *(getattr(r, f) for r in rest),
                                 path=path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return type(tree)(_map(fn, v, *(r[i] for r in rest), path=path + (i,))
                      for i, v in enumerate(tree))


def fix_specs(mesh, spec_tree: Any, shape_tree: Any) -> Any:
    return _map(lambda _, s, leaf: fix_spec(mesh, s, tuple(leaf.shape)),
                spec_tree, shape_tree)


def param_specs(cfg: ModelConfig, params: Any, mesh=None) -> Any:
    """Spec tree matching the port's ``params`` (tensors, meta tensors
    included: shapes are all it reads).

    Each port leaf takes the spec of the reference leaf it stands for:
    its path's dict keys name it (list indices dropped), with the fused
    ``w_qkv`` / ``b_qkv`` standing for ``w_q`` / ``b_q`` (the reference's
    q, k and v share one spec).  The reference stacks a family's layers
    on a leading axis (``STACK_KEYS``: ``dense_blocks`` / ``moe_blocks``,
    ``mamba_blocks``, ``enc_blocks`` / ``dec_blocks``) and gives that
    axis ``None``; the port keeps a list of per-layer trees, so its
    per-layer leaf's spec is the reference's without that leading
    ``None``.  ViT's ``blocks`` are a list in both packages, unstacked.
    With a mesh each spec is fixed for the leaf's own shape; where the
    reference would park an axis on the layer axis (a per-layer dim not
    divisible by it), the port's leaf stays replicated over that axis.
    """
    def walk(path, leaf):
        names = tuple(REF_NAMES.get(k, k) for k in path
                      if isinstance(k, str))
        spec = _leaf_spec(names, leaf.ndim, cfg)
        if mesh is not None:
            spec = fix_spec(mesh, spec, tuple(leaf.shape))
        return spec

    return _map(walk, params)


# ---------------------------------------------------------------------------
# batch / cache specs


def batch_specs(cfg: ModelConfig, mesh, batch: Dict[str, Any],
                shard_batch: bool = True) -> Dict[str, Spec]:
    bspec = dp_axes(mesh) if shard_batch else None
    return {k: Spec(bspec, *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


def decode_state_specs(cfg: ModelConfig, mesh, state: Any,
                       shard_batch: bool = True) -> Any:
    """Specs for KV caches / SSM states (the reference's rules): (L, B,
    S, KV, Dh) GQA; (L, B, S, rank) MLA; mamba states (L, B, H, N, P) /
    conv (L, B, K-1, C).  Batch over the dp axes, or (``shard_batch``
    False, B = 1) the sequence axis of attention caches over data
    (context-parallel decode); SSM states shard heads / channels over
    model."""
    bspec = dp_axes(mesh) if shard_batch else None
    seq_spec = None if shard_batch else "data"

    def walk(path, leaf):
        names = tuple(k if isinstance(k, str) else "" for k in path)
        nd = leaf.ndim
        if "ssm" in names and nd == 5:
            return Spec(None, bspec, "model", None, None)
        if "conv" in names and nd == 4:
            return Spec(None, bspec, None, "model")
        if names and names[-1] in ("k", "v") and nd == 5:
            return Spec(None, bspec, seq_spec, "model", None)
        if names and names[-1] == "c_kv" and nd == 4:
            return Spec(None, bspec, seq_spec, "model")
        if names and names[-1] == "k_rope" and nd == 4:
            return Spec(None, bspec, seq_spec, None)
        if nd == 3:
            return Spec(bspec, None, None)
        return Spec(*([None] * nd))

    return _map(walk, state)


def to_named(mesh, spec_tree: Any) -> Any:
    return _map(lambda _, s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# storage: placements, local pieces, gathers


def to_placements(mesh, spec: Spec) -> List[Any]:
    """``spec`` as DTensor placements on ``mesh``: ``Shard(i)`` on every
    mesh dim whose axis splits tensor dim i (a dim split over two axes,
    ``("pod", "data")``, gets a ``Shard`` on each, major first, in the
    mesh's order), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for i, e in enumerate(spec):
        idx = [names.index(a) for a in _axes(e)]
        if idx != sorted(idx):
            raise ValueError(f"axes {e} of dim {i} are not in the mesh's "
                             f"order {names}")
        for j in idx:
            out[j] = Shard(i)
    return out


def _dim_index(mesh, entry: Entry) -> Tuple[int, int]:
    """(this rank's block index, block count) of a dim split over
    ``entry``'s axes, the first axis major."""
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def local_slices(mesh, spec: Spec, shape: Tuple[int, ...]
                 ) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a full ``shape`` under ``spec``
    (sharded dims must divide evenly: store with ``fix_spec``)."""
    out = []
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        idx, n = _dim_index(mesh, e)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {e} ({n} ways); fix the spec first")
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _is_whole(mesh, spec: Spec) -> bool:
    return all(_dim_index(mesh, e)[1] == 1 for e in spec)


def shard_leaf(mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's piece of the full tensor ``x``: ``x`` itself where
    nothing splits it (no copy), else a contiguous copy of the piece."""
    if _is_whole(mesh, spec):
        return x
    return x[local_slices(mesh, spec, tuple(x.shape))].contiguous()


def shard_tree(mesh, tree: Any, specs: Any) -> Any:
    """Each rank keeps its local piece of every leaf of ``tree``."""
    return _map(lambda _, x, s: shard_leaf(mesh, x, s)
                if isinstance(x, torch.Tensor) else x, tree, specs)


# the single-tensor collectives under their newer names where this
# torch has them
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = g.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=g.dtype, device=g.device)
    _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _gather_plan(mesh, spec: Spec, keep: Tuple[str, ...]
                 ) -> List[Tuple[int, str]]:
    """(tensor dim, axis) gathers in order: within a dim the minor axis
    first, so each gather concatenates whole blocks of the next."""
    sizes = mesh_shape(mesh)
    plan = []
    for d, e in enumerate(spec):
        for a in reversed(_axes(e)):
            if a not in keep and sizes[a] > 1:
                plan.append((d, a))
    return plan


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        for d, a in plan:
            x = _gather_dim(x, d, mesh.get_group(a))
        return x

    @staticmethod
    def backward(ctx, g):
        for d, a in reversed(ctx.plan):
            g = _reduce_scatter_dim(g, d, ctx.mesh.get_group(a))
        return g, None, None


def gather_leaf(x: torch.Tensor, mesh, spec: Spec,
                keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """All-gather this rank's piece ``x`` (stored under ``spec``) over
    every axis of ``spec`` not in ``keep``: the full leaf by default.
    Where no axis of size > 1 is gathered it returns ``x`` itself (at
    world size 1 the leaf, not a copy).  The backward reduce-scatters the
    gradient (a sum over the gathering ranks) to ``x``'s layout."""
    plan = _gather_plan(mesh, spec, keep)
    if not plan:
        return x
    return _GatherLeaf.apply(x, mesh, plan)


def reshard_leaf(x: torch.Tensor, mesh, spec: Spec, target: Spec
                 ) -> torch.Tensor:
    """This rank's piece of the leaf under ``target`` from its piece
    under ``spec``: a gather over the axes ``target`` drops where each of
    its entries is ``spec``'s or ``None``, else a full gather and the
    target's slice (differentiable both ways)."""
    entries = list(spec) + [None] * (x.ndim - len(spec))
    tgt = list(target) + [None] * (x.ndim - len(target))
    if all(t is None or t == s for t, s in zip(tgt, entries)):
        keep = tuple(a for t in tgt for a in _axes(t))
        return gather_leaf(x, mesh, spec, keep)
    full = gather_leaf(x, mesh, spec)
    if _is_whole(mesh, target):
        return full
    return full[local_slices(mesh, target, tuple(full.shape))]


def gather_tree(mesh, tree: Any, specs: Any) -> Any:
    return _map(lambda _, x, s: gather_leaf(x, mesh, s)
                if isinstance(x, torch.Tensor) else x, tree, specs)


class Gathered(Mapping):
    """Read-only view of a local tree (dict level) that gathers a leaf
    each time the model code reads it; sub-dicts and lists come back as
    views.  ``reshard(key, target)`` gives a leaf in a partly sharded
    layout instead (the expert-parallel MoE keeps its slabs split over
    ``model``)."""

    def __init__(self, local: Dict, specs: Dict, mesh):
        self._local, self._specs, self.mesh = local, specs, mesh

    def __getitem__(self, key):
        return _view(self._local[key], self._specs[key], self.mesh)

    def __iter__(self):
        return iter(self._local)

    def __len__(self) -> int:
        return len(self._local)

    def __contains__(self, key) -> bool:      # no gather to test a key
        return key in self._local

    def reshard(self, key, target: Spec) -> torch.Tensor:
        return reshard_leaf(self._local[key], self.mesh, self._specs[key],
                            target)


class GatheredList(Sequence):
    """The list level of :class:`Gathered`."""

    def __init__(self, local: List, specs: List, mesh):
        self._local, self._specs, self.mesh = local, specs, mesh

    def __getitem__(self, i):
        return _view(self._local[i], self._specs[i], self.mesh)

    def __len__(self) -> int:
        return len(self._local)


def _view(x, spec, mesh):
    if isinstance(x, dict):
        return Gathered(x, spec, mesh)
    if isinstance(x, (list, tuple)):
        return GatheredList(x, spec, mesh)
    return gather_leaf(x, mesh, spec)


# ---------------------------------------------------------------------------
# autograd-aware reductions


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; its adjoint is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Autograd-aware sum over ``group``: ``x`` itself on a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def reduce_over(x: torch.Tensor, mesh, axes: Tuple[str, ...],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place reduction of a tensor over each of ``axes`` in turn (no
    gradient)."""
    sizes = mesh_shape(mesh)
    for a in axes:
        if sizes[a] > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in _axes(e))
