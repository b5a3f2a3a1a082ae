"""Cost accounting for the dry-run: a counting dispatch mode (the port's
``cost_analysis`` and ``memory_analysis``) and the reference's
probe-and-extrapolate API; port of ``repro.launch.costing``.

The counter.  :func:`trace_cost` runs a step once under
:class:`Counter`, a ``TorchDispatchMode`` that sees every aten and c10d
op the step dispatches, on fake tensors (``FakeTensorMode``) or real
ones alike, and counts four things:

  * FLOPs: ``torch.utils.flop_counter``'s registry (mm, bmm, addmm,
    baddbmm, convolutions, SDPA), an op outside it decomposed first as
    ``FlopCounterMode`` does, so the two agree op for op.  Elementwise
    FLOPs, which XLA's ``cost_analysis`` also counts, are left out.
  * Bytes: per non-view op, the bytes of each distinct storage it reads
    or writes (the largest view of it the op touches), an in-place
    op's buffer once.  Views and aliases move nothing, allocation alone
    neither.  This is the traffic of the eager program the port runs,
    not XLA's fused count.
  * Collectives: every ``c10d`` op, with its group's size and whether
    its ranks lie on one node (``roofline.collectives``).
  * Memory: the bytes of the argument storages, of the output storages
    (those that are argument storages too are aliases), and the peak of
    the live storages, a storage counted from the op that creates it to
    the moment it is freed.

The step's layers are Python lists, not a ``lax.scan``: the direct count
is exact in trip counts (layers, microbatches, remat's second forward,
each inside ``torch.utils.checkpoint``), and the dry-run records it
alone.  :func:`probe_costs` keeps the reference's probe-and-extrapolate
API, which the tests hold to the direct count where the model is linear
in its layer and microbatch counts.

On fake tensors a data-dependent output size has no value: ``nonzero``
(and a boolean index, which takes it) is counted at its upper bound,
every element selected, and ``bincount`` at ``minlength`` (the MoE
router's expert counts, which never exceed it).

Kernels.  The trace runs on the CPU, so ``kernels/dispatch.py`` routes
every kernel op to its plain version.  While a trace runs, the counter
holds ``dispatch.tag_plain_routes`` open: the FLOPs and bytes counted
inside each plain route are also kept under ``kernel:<name>``
(``Cost.regions``), so that a count can be read without the work a card
kernel would do instead.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.kernels import dispatch
from repro_torch.models.config import ModelConfig
from repro_torch.roofline import collectives as coll


# ---------------------------------------------------------------------------
# layer stacks (the reference's, for its probes)


@dataclass(frozen=True)
class Stack:
    """One homogeneous layer stack of an architecture."""
    name: str
    n_layers: int                  # layer count in the full config
    base: int                      # layer count in the base probe
    bump: Dict[str, int]           # config overrides adding ONE layer


def stacks_for(cfg: ModelConfig) -> Tuple[Dict[str, int], List[Stack]]:
    """(base-config overrides, stacks).  The base probe keeps exactly
    ``base`` layers of each stack; each stack's ``bump`` adds one."""
    if cfg.family == "encdec":
        base = {"n_layers": 1,
                "encdec": dataclasses.replace(cfg.encdec,
                                              n_encoder_layers=1)}
        return base, [
            Stack("enc", cfg.encdec.n_encoder_layers, 1,
                  {"encdec": dataclasses.replace(cfg.encdec,
                                                 n_encoder_layers=2)}),
            Stack("dec", cfg.n_layers, 1, {"n_layers": 2}),
        ]
    if cfg.family == "hybrid":
        if cfg.layer_pattern is not None:
            pat = cfg.layer_pattern
            kinds = list(dict.fromkeys(pat))      # e.g. ['m', 'A']
            base_pat = tuple(kinds)
            base = {"layer_pattern": base_pat, "n_layers": len(base_pat)}
            stacks = []
            for k in kinds:
                bump_pat = base_pat + (k,)
                stacks.append(
                    Stack(f"pat_{k}", sum(1 for p in pat if p == k), 1,
                          {"layer_pattern": bump_pat,
                           "n_layers": len(bump_pat)}))
            return base, stacks
        # zamba2-style shared block every few mamba layers: one "mamba"
        # stack, as the reference counts it.  Its probes' one and two
        # layers run no shared block (the reference's XLA cost model
        # counts the block's cond branch in every layer), so here the
        # extrapolation leaves the shared attention out; the direct
        # count is exact
        return {"n_layers": 1}, [Stack("mamba", cfg.n_layers, 1,
                                       {"n_layers": 2})]
    if cfg.moe is not None and cfg.moe.first_dense_layers > 0:
        d = cfg.moe.first_dense_layers
        base = {"n_layers": 2,
                "moe": dataclasses.replace(cfg.moe, first_dense_layers=1)}
        return base, [
            Stack("dense", d, 1,
                  {"n_layers": 3,
                   "moe": dataclasses.replace(cfg.moe,
                                              first_dense_layers=2)}),
            Stack("moe", cfg.n_layers - d, 1,
                  {"n_layers": 3,
                   "moe": dataclasses.replace(cfg.moe,
                                              first_dense_layers=1)}),
        ]
    # dense / moe(all-moe) / ssm / vlm: one homogeneous stack
    return {"n_layers": 1}, [Stack("blocks", cfg.n_layers, 1,
                                   {"n_layers": 2})]


def _op_merge(a: Optional[Dict], b: Optional[Dict], f) -> Dict:
    a, b = a or {}, b or {}
    return {k: f(a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)}


@dataclass
class Cost:
    """Per-device FLOPs, bytes and collective bytes (``coll_by_op`` by
    collective; ``intra`` the collective bytes inside one node).
    ``regions``: {"kernel:<name>": {"flops", "bytes"}} counted inside
    each kernel's plain version (kept apart, also in the totals)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: float = 0.0
    coll_by_op: Optional[Dict[str, float]] = None
    intra: float = 0.0
    regions: Optional[Dict[str, Dict[str, float]]] = None
    op_counts: Optional[Dict[str, int]] = None

    def _combine(self, o, f):
        regions = {k: _op_merge((self.regions or {}).get(k),
                                (o.regions or {}).get(k), f)
                   for k in set(self.regions or {}) | set(o.regions or {})}
        return Cost(f(self.flops, o.flops), f(self.bytes, o.bytes),
                    f(self.coll, o.coll),
                    _op_merge(self.coll_by_op, o.coll_by_op, f),
                    f(self.intra, o.intra), regions)

    def __sub__(self, o):
        return self._combine(o, lambda x, y: x - y)

    def __add__(self, o):
        return self._combine(o, lambda x, y: x + y)

    def __mul__(self, k: float):
        return Cost(self.flops * k, self.bytes * k, self.coll * k,
                    {kk: v * k for kk, v in (self.coll_by_op or {}).items()},
                    self.intra * k,
                    {r: {kk: v * k for kk, v in d.items()}
                     for r, d in (self.regions or {}).items()})

    __rmul__ = __mul__

    def clamped(self):
        return Cost(max(self.flops, 0.0), max(self.bytes, 0.0),
                    max(self.coll, 0.0),
                    {k: max(v, 0.0)
                     for k, v in (self.coll_by_op or {}).items()},
                    max(self.intra, 0.0),
                    {r: {k: max(v, 0.0) for k, v in d.items()}
                     for r, d in (self.regions or {}).items()})


# ---------------------------------------------------------------------------
# the counter


_C10D_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    # a broadcast moves its operand once over the group (the ring
    # factor of an all-gather of the operand)
    "broadcast_": "all-gather",
}
# c10d ops whose first argument is the output and second the input
_SPLIT_ARGS = {"_allgather_base_", "allgather_",
               "allgather_into_tensor_coalesced_", "_reduce_scatter_base_",
               "reduce_scatter_", "reduce_scatter_tensor_coalesced_",
               "alltoall_", "alltoall_base_"}
# ops that allocate or reshape metadata only
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh", "lift_fresh_copy", "set_", "resize_",
               "record_stream"}
_SHAPE_QUERIES = {"sym_size", "sym_stride", "sym_numel",
                  "sym_storage_offset", "size", "stride", "numel", "dim",
                  "is_contiguous", "sym_is_contiguous",
                  "is_strides_like_format", "is_non_overlapping_and_dense",
                  "storage_offset", "is_same_size"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _view_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _group_of(args) -> Any:
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    return None


class Counter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live memory (module
    docstring).  ``add_arguments`` registers the step's argument
    storages before it runs."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.records: List[coll.Record] = []
        self.regions: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0})
        self.region_stack: List[str] = []
        self._live: Dict[int, int] = {}
        self.args: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory ------------------------------------------------------------
    def add_arguments(self, tree) -> int:
        n = 0
        for t in _tensors(tree):
            k = _key(t)
            if k not in self.args:
                self.args[k] = t.untyped_storage().nbytes()
                n += self.args[k]
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def _free(self, k: int, n: int) -> None:
        if self._live.pop(k, None) is not None:
            self.live_bytes -= n

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self._live or k in self.args:
                continue
            n = st.nbytes()
            self._live[k] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, k, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- counting ----------------------------------------------------------
    def _add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        for r in set(self.region_stack):
            self.regions[f"kernel:{r}"]["flops"] += flops
            self.regions[f"kernel:{r}"]["bytes"] += nbytes

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split("::")[-1]
        op = _C10D_OPS.get(name)
        if op is None:
            return                      # barrier, monitored waits, ...
        pg = _group_of(args)
        import torch.distributed as dist
        ranks = (dist.get_process_group_ranks(pg) if pg is not None
                 else list(range(dist.get_world_size())))
        if name in _SPLIT_ARGS:              # (output(s), input(s), ...)
            res_b = sum(_view_bytes(t) for t in _tensors(args[0]))
            op_b = sum(_view_bytes(t) for t in _tensors(args[1]))
        else:                                # in place on its operands
            op_b = res_b = sum(_view_bytes(t) for t in _tensors(args[0]))
        self.records.append(coll.Record(op, len(ranks), op_b, res_b,
                                        coll.intra_node(ranks)))

    @staticmethod
    def _all_fake(args) -> bool:
        ts = _tensors(args)
        return bool(ts) and all(_is_fake(t) for t in ts)

    @staticmethod
    def _stand_in(name, args, kwargs) -> torch.Tensor:
        """A fake output for ``nonzero`` / ``bincount``, whose size is
        the data's (module docstring)."""
        x = args[0]
        if name == "nonzero":
            return torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                               device=x.device)
        minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
        weighted = len(args) > 1 and args[1] is not None
        return torch.empty((minlength,), device=x.device,
                           dtype=torch.float64 if weighted else torch.int64)

    def _bool_index(self, args) -> torch.Tensor:
        """``x[mask]`` on fake tensors: the mask through ``nonzero``'s
        stand-in, then an integer index (both counted)."""
        idx = []
        for i in args[1]:
            if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                nz = torch.ops.aten.nonzero.default(i)
                idx.extend(nz[:, j] for j in range(i.dim()))
            else:
                idx.append(i)
        return torch.ops.aten.index.Tensor(args[0], idx)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if name in _SHAPE_QUERIES or func.namespace == "prim":
            return func(*args, **kwargs)
        if func.namespace == "c10d":
            out = func(*args, **kwargs)
            self._collective(func, args, out)
            self._add(0.0, self._traffic(args, kwargs, out))
            return out
        packet = func._overloadpacket
        if packet not in self.flop_registry:
            with self:                   # FlopCounterMode's decomposition
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if name == "index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]) and self._all_fake(args):
            with self:
                return self._bool_index(args)
        if name in ("nonzero", "bincount") and self._all_fake(args):
            out = self._stand_in(name, args, kwargs)
        else:
            out = func(*args, **kwargs)
        flops = 0.0
        if packet in self.flop_registry:
            flops = float(self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        nbytes = 0.0
        if not (func.is_view or name in _NO_TRAFFIC):
            nbytes = self._traffic(args, kwargs, out)
        self._add(flops, nbytes)
        self._track(_tensors(out))
        return out

    @staticmethod
    def _traffic(args, kwargs, out) -> float:
        seen: Dict[int, int] = {}
        for t in _tensors((args, kwargs, out)):
            k = _key(t)
            seen[k] = max(seen.get(k, 0), _view_bytes(t))
        return float(sum(seen.values()))

    def cost(self) -> Cost:
        cs = coll.collective_bytes(self.records)
        return Cost(self.flops, self.bytes, cs["bytes_per_device"],
                    cs["by_op_bytes"], cs["intra_node_bytes"],
                    {k: dict(v) for k, v in self.regions.items()},
                    cs["op_counts"])


@dataclass
class Memory:
    """The port's ``memory_analysis``: bytes of the argument storages
    (``by_arg``, one entry per argument), of the output storages, of
    those outputs that are argument storages (``alias``), and the peak
    of the live storages less the arguments (``temp``)."""
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    by_arg: List[int] = field(default_factory=list)


def trace_cost(fn: Callable, *args) -> Tuple[Cost, Memory, Any]:
    """Run ``fn(*args)`` once under a :class:`Counter` (with the kernels'
    plain routes tagged) and return (cost, memory, fn's output).  The
    caller picks the tensors: fake ones under its ``FakeTensorMode``, or
    real ones."""
    counter = Counter()
    by_arg = [counter.add_arguments(a) for a in args]
    with dispatch.tag_plain_routes(counter.region_stack), counter:
        out = fn(*args)
    outs, seen = 0, set()
    alias = 0
    for t in _tensors(out):
        k = _key(t)
        if k in seen:
            continue
        seen.add(k)
        n = t.untyped_storage().nbytes()
        outs += n
        if k in counter.args:
            alias += n
    argb = sum(by_arg)
    mem = Memory(argument_bytes=argb, output_bytes=outs,
                 temp_bytes=max(counter.peak_bytes - argb, 0),
                 alias_bytes=alias, peak_bytes=counter.peak_bytes,
                 by_arg=by_arg)
    return counter.cost(), mem, out


# ---------------------------------------------------------------------------
# flash attention's byte correction (opt "flash")
#
# The plain attention the trace runs materialises the (B, H, T, S) logits
# and probabilities; the card's flash / decode kernels keep them on chip.
# The counter measures the plain traffic of one attention site at the
# cell's local shapes, and the kernel's analytic traffic replaces it:
#
#   fwd   reads q,k,v; writes o (+O(T) lse)          ~ 2*QB + 2*KB
#   bwd   reads q,k,v,o,do; writes dq,dk,dv          ~ 3*QB + 4*KB
#   remat re-runs fwd inside bwd                     + fwd again
#
#   QB = B*T*H*Dh*bytes,  KB = B*S*KV*Dh*bytes
#
# FLOPs are untouched (the kernel computes the same products).


def _attn_local_shapes(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       accum: int) -> Optional[Dict]:
    """Per-device attention operand shapes under the production sharding:
    the reference's rows a device, with every head (the port's ranks
    gather their weights and run all heads of their rows, where the
    reference splits heads over ``model``)."""
    if cfg.family in ("ssm",):
        return None
    from repro_torch.distributed import sharding as shd
    dp = shd.dp_size(mesh)
    if shape.kind == "train":
        b_loc = max(shape.global_batch // accum // dp, 1)
        T = S = shape.seq_len
        mode = "train"
    elif shape.kind == "prefill":
        b_loc = max(shape.global_batch // dp, 1)
        T = S = shape.seq_len
        mode = "prefill"
    else:
        b_loc = max(shape.global_batch // dp, 1)
        T, S = 1, shape.seq_len
        mode = "decode"
    return dict(b=b_loc, t=T, s=S, h=cfg.n_heads, kv=cfg.n_kv_heads,
                dh=cfg.head_dim, mode=mode)


def kernel_attn_bytes(mode: str, b: int, t: int, s: int, h: int, kv: int,
                      dh: int, dtype_bytes: int) -> float:
    """The flash / decode kernels' analytic HBM bytes for one site."""
    QB = b * t * h * dh * dtype_bytes
    KB = b * s * kv * dh * dtype_bytes
    if mode == "train":                 # fwd + remat-fwd + bwd
        return float((2 * QB + 2 * KB) * 2 + (3 * QB + 4 * KB))
    return float(2 * QB + 2 * KB)       # fwd only


def _attn_site_saving(mode: str, b: int, t: int, s: int, h: int, kv: int,
                      dh: int, dtype_bytes: int) -> Dict:
    """Counted plain-attention bytes minus the kernel's analytic bytes
    for ONE attention site at the given local lengths (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import layers as L
    from repro_torch.models.attention import sdpa

    dt = torch.bfloat16 if dtype_bytes == 2 else torch.float32
    with FakeTensorMode():
        grad = mode == "train"
        q = torch.empty((b, t, h, dh), dtype=dt, requires_grad=grad)
        k = torch.empty((b, s, kv, dh), dtype=dt, requires_grad=grad)
        v = torch.empty((b, s, kv, dh), dtype=dt, requires_grad=grad)
        if mode == "train":
            def f(q, k, v):
                out = L.remat(lambda a, b_, c: sdpa(a, b_, c, causal=True),
                              True, q, k, v)
                torch.sum(out.float()).backward()
                return q.grad, k.grad, v.grad
        elif mode == "prefill":
            def f(q, k, v):
                return sdpa(q, k, v, causal=True)
        else:
            def f(q, k, v):
                return sdpa(q, k, v, kv_len=torch.full(
                    (q.shape[0],), s, dtype=torch.int32))
        with torch.set_grad_enabled(grad):
            cost, _, _ = trace_cost(f, q, k, v)
    plain = cost.bytes
    kernel = kernel_attn_bytes(mode, b, t, s, h, kv, dh, dtype_bytes)
    return {"plain": plain, "kernel": kernel,
            "saved": max(plain - kernel, 0.0)}


def flash_correction(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     accum: int, n_attn_layers: int,
                     dtype_bytes: int = 2,
                     mixed_lb: int = 0, t_mix: int = 0) -> Dict:
    """Per-device bytes the flash / decode kernels save over the plain
    attention for one step of this cell, at the port's per-rank shapes
    (every head of the rank's rows).  As the reference's, a train site
    assumes a kernel backward too; the port's backward is plain on the
    card as well, so there it is what such a kernel would save.
    ``dtype_bytes``: the cell's element size (bf16 2, as the
    reference's; a float32 cell's 4).

    ``mixed_lb``/``t_mix``: with the mixed-granularity prefill variant,
    the first ``mixed_lb`` layers attend over ``t_mix`` tokens — the
    correction is computed per length segment so it never over-subtracts.
    """
    loc = _attn_local_shapes(cfg, shape, mesh, accum)
    if loc is None or cfg.mla is not None:
        # SSD has no attention; MLA runs its own einsums, no kernel
        return {"bytes_saved_per_device": 0.0, "sites": 0,
                "note": "no GQA attention sites (ssm/mla)"}
    b, t, s, h, kv, dh = (loc[k] for k in ("b", "t", "s", "h", "kv", "dh"))
    reps = accum if shape.kind == "train" else 1

    segments = []
    if mixed_lb > 0 and t_mix > 0 and loc["mode"] == "prefill":
        segments.append((mixed_lb * reps, t_mix, t_mix))
        segments.append(((n_attn_layers - mixed_lb) * reps, t, s))
    else:
        segments.append((n_attn_layers * reps, t, s))

    saved = 0.0
    details = []
    for n_sites, tt, ss in segments:
        site = _attn_site_saving(loc["mode"], b, tt, ss, h, kv, dh,
                                 dtype_bytes)
        saved += site["saved"] * n_sites
        details.append({"sites": n_sites, "t": tt, "s": ss, **site})
    return {"bytes_saved_per_device": saved,
            "segments": details,
            "sites": sum(d["sites"] for d in details),
            "local_shapes": loc}


def min_traffic_floor(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      accum: int, mixed_lb: int = 0,
                      t_mix: int = 0, dtype_bytes: int = 2) -> Dict:
    """Analytic lower bound on per-device HBM traffic for one step:
    parameters streamed once per pass (x3 for fwd+remat+bwd in training,
    + optimizer state), ~8 residual-stream tensors per layer, and the
    flash kernel's attention IO.  Used as a floor under the byte
    substitution so that no number over-claims (the reference's formula;
    ``dtype_bytes`` is the parameters' and activations' element size:
    bf16 2, as the reference's; a float32 cell's 4)."""
    from repro_torch.distributed import sharding as shd
    dp = shd.dp_size(mesh)
    tp = shd.mesh_shape(mesh)["model"]
    N = cfg.param_count()
    L_n = cfg.n_layers
    D = cfg.d_model
    is_train = shape.kind == "train"
    reps = accum if is_train else 1
    b_loc = max(shape.global_batch // (accum if is_train else 1) // dp, 1)
    T = 1 if shape.kind == "decode" else shape.seq_len
    if cfg.family == "vlm" and shape.kind == "prefill":
        T += cfg.vlm.n_image_tokens

    param_bytes = dtype_bytes * N / tp          # TP-sharded stream
    passes = 3 if is_train else 1               # fwd + remat + bwd
    opt_bytes = (N / (dp * tp)) * (4 + 4 + 4 + 2) * 2 if is_train else 0

    def act(t_eff, n_layers):
        return n_layers * 8 * b_loc * t_eff * D * dtype_bytes

    if mixed_lb > 0 and t_mix > 0:
        act_bytes = act(t_mix, mixed_lb) + act(T, L_n - mixed_lb)
    else:
        act_bytes = act(T, L_n)
    # kv-cache write (prefill) / read (decode)
    cache_bytes = 0
    if shape.kind == "prefill":
        cache_bytes = 2 * b_loc * shape.seq_len * cfg.kv_dim * 2
    elif shape.kind == "decode":
        cache_bytes = 2 * b_loc * shape.seq_len * \
            max(cfg.kv_dim // tp, cfg.head_dim) * 2 * L_n

    total = (reps * (passes * param_bytes + act_bytes) + opt_bytes
             + cache_bytes)
    return {"bytes_per_device": float(total),
            "parts": {"params": passes * param_bytes * reps,
                      "acts": act_bytes * reps, "opt": opt_bytes,
                      "cache": cache_bytes}}


def attn_layer_count(cfg: ModelConfig) -> int:
    """Attention layers per step (0 for pure SSM)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return sum(1 for p in (cfg.layer_pattern or ()) if p != "m")
    if cfg.family == "encdec":
        # enc self + dec self + dec cross
        return cfg.encdec.n_encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


# ---------------------------------------------------------------------------
# probe-and-extrapolate (the reference's API, a cross-check here)


def cell_cost(cell) -> Tuple[Cost, Memory]:
    """Trace a ``launch.specs.Cell`` once on fake tensors: its local
    meta pieces become fake CPU tensors of the same shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import specs
    with FakeTensorMode():
        args = specs.materialize(cell.args)
        cost, mem, _ = trace_cost(cell.fn, *args)
    return cost, mem


def _lower_cost(build_cell, arch_cfg: ModelConfig, shape: ShapeSpec,
                mesh, opt: str, accum: int) -> Cost:
    """Build and trace one probe; its (per-device) cost."""
    return cell_cost(build_cell(arch_cfg, shape, mesh, opt, accum))[0]


def probe_costs(arch: str, shape_name: str, mesh, build_cell,
                accum: int, opt: str = "base", fast: bool = True,
                verbose: bool = False, cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeSpec] = None) -> Dict:
    """Run the probe set and extrapolate the full-cell per-device cost
    (the reference's method and keys).  The dry-run does not call it: its
    direct count is exact in trip counts, and the tests hold this
    extrapolation to it.

      step cost = O + Sum_k L_k * o_k  +  A * (F + Sum_k L_k * f_k)

    P1 the base layers at accum 1, P2_k one more layer of stack k, and
    (``fast`` False, train cells with A > 1) P3 / P4_k the same at
    accum 2.  ``build_cell(cfg_override, shape, mesh, opt, accum)`` must
    honour the probe config and the forced accum.  ``fast`` counts the
    once-per-step part (the AdamW update) A times.  ``cfg`` / ``shape``
    override the registry's (tests probe small configs)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    base_over, stacks = stacks_for(cfg)

    is_train = shape.kind == "train"
    A = accum if is_train else 1
    # probes run ONE microbatch: shrink the global batch by the accum
    mb_batch = max(shape.global_batch // A, 1)
    pshape = dataclasses.replace(shape, global_batch=mb_batch)
    p2shape = dataclasses.replace(shape, global_batch=2 * mb_batch)

    base_cfg = cfg.replace(**base_over)
    # each bump on the base probe's config: the reference applies it to
    # the full config, so that its encoder-decoder probes keep the other
    # stack at full depth
    bumped = {s.name: base_cfg.replace(**s.bump) for s in stacks}
    P1 = _lower_cost(build_cell, base_cfg, pshape, mesh, opt, 1)
    P2 = {k: _lower_cost(build_cell, c, pshape, mesh, opt, 1)
          for k, c in bumped.items()}
    if is_train and A > 1 and not fast:
        P3 = _lower_cost(build_cell, base_cfg, p2shape, mesh, opt, 2)
        P4 = {k: _lower_cost(build_cell, c, p2shape, mesh, opt, 2)
              for k, c in bumped.items()}
    else:
        P3, P4 = None, None

    if P3 is not None:
        F = (P3 - P1).clamped()
        O = (P1 - F).clamped()
        total = O + A * F
        for s in stacks:
            f_k = ((P4[s.name] - P2[s.name]) - F).clamped()
            o_k = ((P2[s.name] - P1) - f_k).clamped()
            extra = s.n_layers - s.base
            total = total + extra * o_k + (A * extra) * f_k
        method = "probe-extrapolate exact (accum split)"
    else:
        per_mb = P1
        for s in stacks:
            B_k = (P2[s.name] - P1).clamped()
            per_mb = per_mb + (s.n_layers - s.base) * B_k
        total = A * per_mb
        method = ("probe-extrapolate fast (optimizer counted A times)")

    out = {
        "flops_per_device": total.flops,
        "bytes_per_device": total.bytes,
        "collective_bytes_per_device": total.coll,
        "collective_by_op": total.coll_by_op,
        "probes": {
            "P1": _asdict(P1),
            **{f"P2_{k}": _asdict(v) for k, v in P2.items()},
        },
        "accum": A,
        "stacks": {s.name: s.n_layers for s in stacks},
        "method": method,
    }
    if P3 is not None:
        out["probes"]["P3"] = _asdict(P3)
        out["probes"].update({f"P4_{k}": _asdict(v)
                              for k, v in P4.items()})
    if verbose:
        print(f"[probe] {arch} {shape_name}: {method}", flush=True)
    return out


def _asdict(c: Cost) -> Dict:
    d = dataclasses.asdict(c)
    d.pop("regions")
    d.pop("op_counts")
    return d
