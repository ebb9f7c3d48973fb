"""Parameter placement rules and the sharded train step (port of
``cliffordtpu/parallel/sharding.py``).

The rules are JAX's, read on the port's parameter names and on its
``nn.Linear`` (out, in) layout, where flax's (in, out) kernel puts the
same axes the other way round (flax's P(None, "model") is torch's
Shard(0)):

* tensor parallelism over "model" only on the 2-D Attention / SwiGLU
  projections: q, k, v (or the fused ``wqkv``) and w1, w3 (or ``w13``)
  split their outputs (``ColwiseParallel``), ``wo`` and ``w2`` their
  inputs (``RowwiseParallel``); the head-interleaved ``wqkv`` and the
  pair-interleaved ``w13`` keep each head's (q, k, v) and each (w1_i,
  w3_i) on one rank.  Layer-stacked (``scan_layers``) 3-D kernels stay
  replicated;
* ``mode="fsdp"`` (``fsdp_rule``): a leaf of at least ``fsdp_min_size``
  elements is split over "data" on its largest remaining axis that the
  data axis divides, after the TP rule; smaller leaves stay whole.  The
  axes are taken in JAX's order, so a tie breaks as JAX breaks it.

``shard_model`` applies them: ``parallelize_module`` over "model", then
DDP over "data" (``replicated``) or FSDP2's ``fully_shard`` over "data"
with ``shard_placement_fn`` from ``fsdp_rule`` (``fsdp``).  FSDP2 shards
every parameter it holds, so the leaves the rule keeps whole are given
to it as ``ignored_params`` and their gradients all-reduced by the step,
as are all gradients of a DP x TP ``replicated`` model, since DDP cannot
hold the DTensor parameters of tensor parallelism.  Two placements of
JAX's rules have no tensor-parallel form here and stay whole over
"model" (``tp_kept_whole``; the same math, more memory): a stacked
kernel that the fsdp rule puts on a "model" axis, and a projection pair
of which the rule splits one half only.

The Adam moments follow their parameters: the optimizer is built over the
sharded parameters (``shard_state``), and its moments are made like them.
"""

from __future__ import annotations

import re
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from cliffordtpu_torch.parallel.data import data_rank
from cliffordtpu_torch.parallel.mesh import mesh_sizes
from cliffordtpu_torch.train.loop import _losses, _train_step
from cliffordtpu_torch.train.state import group_names

MODES = ("replicated", "fsdp")
FSDP_MIN_SIZE = 2 ** 14

_COLWISE = re.compile(r"(^|\.)(attn\.(wq|wk|wv|wqkv)|ffn\.(w1|w3|w13))"
                      r"\.weight$")
_ROWWISE = re.compile(r"(^|\.)(attn\.wo|ffn\.w2)\.weight$")

Placement = Tuple[Optional[str], ...]


def rule_for_name(name: str) -> Placement:
    """The tensor-parallel placement of a 2-D projection weight, (out, in):
    ("model", None) splits the outputs, (None, "model") the inputs; () for
    every other parameter."""
    if _COLWISE.search(name):
        return ("model", None)
    if _ROWWISE.search(name):
        return (None, "model")
    return ()


def _jax_shape(shape, order) -> Tuple[int, ...]:
    """A port tensor's shape in JAX's axis order (port axis i is JAX axis
    order[i])."""
    if order is None:
        return tuple(shape)
    out = [0] * len(shape)
    for i, a in enumerate(order):
        out[a] = shape[i]
    return tuple(out)


def _to_port(dims: Placement, order) -> Placement:
    return tuple(dims) if order is None else tuple(dims[a] for a in order)


def fsdp_rule(name: str, jax_shape, sizes: Dict[str, int],
              min_size: int = FSDP_MIN_SIZE) -> Placement:
    """JAX's ``_fsdp_rule`` on a leaf's JAX-order shape: the TP rule (in
    JAX's (in, out) axes, padded to the leaf's rank as JAX pads it), then
    "data" on the largest remaining axis that the data axis divides.
    Returns one entry per JAX axis, or () for a leaf kept whole."""
    size = 1
    for s in jax_shape:
        size *= s
    if len(jax_shape) < 1 or size < min_size:
        return ()
    tp = tuple(reversed(rule_for_name(name)))
    dims = list(tp) + [None] * (len(jax_shape) - len(tp))
    order = sorted(range(len(jax_shape)), key=lambda a: -jax_shape[a])
    for ax in order:
        if dims[ax] is None and jax_shape[ax] % sizes["data"] == 0:
            dims[ax] = "data"
            break
    return tuple(dims)


def infer_param_sharding(sizes: Dict[str, int], model: nn.Module,
                         mode: str = "replicated",
                         fsdp_min_size: int = FSDP_MIN_SIZE
                         ) -> Dict[str, Placement]:
    """The placement of every parameter of ``model`` by name: a tuple over
    its axes of "data", "model" or None (() where it is whole), as JAX's
    ``infer_param_sharding`` places the same leaf.  ``sizes``: the mesh's
    axis sizes, {"data": n, "model": m}."""
    from cliffordtpu_torch.nn.param_import import layout

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    params = dict(model.named_parameters())
    out = {}
    for name, _, _, order in layout(model):
        shape = tuple(params[name].shape)
        if mode == "fsdp":
            dims = fsdp_rule(name, _jax_shape(shape, order), sizes,
                             fsdp_min_size)
            out[name] = _to_port(dims, order) if dims else ()
        else:
            out[name] = rule_for_name(name) if len(shape) == 2 else ()
    return out


class ShardedModel:
    """A model placed on a mesh: ``module`` is what the step calls (the
    DDP wrapper, or the model itself under FSDP2 or TP), ``model`` the
    underlying module (sharded in place), ``placements`` what
    ``infer_param_sharding`` gave, and ``sync_grads`` all-reduces over
    "data" the gradients that neither DDP nor FSDP2 reduces."""

    def __init__(self, module, model, mesh,
                 placements: Dict[str, Placement], unreduced: List):
        self.module = module
        self.model = model
        self.mesh = mesh
        self.placements = placements
        self._unreduced = unreduced

    def __call__(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    @torch.no_grad()
    def sync_grads(self):
        n = self.mesh["data"].size()
        grads = [p.grad for p in self._unreduced if p.grad is not None]
        if n == 1 or not grads:
            return
        group = self.mesh["data"].get_group()
        for g in grads:
            local = g.to_local() if hasattr(g, "to_local") else g
            dist.all_reduce(local, group=group)
            local.div_(n)


def _tp_plan(placements: Dict[str, Placement]) -> Dict[str, object]:
    """``parallelize_module``'s plan: each projection pair (q/k/v or wqkv
    with wo; w1/w3 or w13 with w2) whose 2-D kernels the rules split over
    "model", inputs and outputs; any other "model" placement (a stacked
    kernel, or one half of a pair) stays whole over "model", which is
    the same math (``tp_kept_whole``)."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    styles = {}
    for name, dims in placements.items():
        if "model" in dims and len(dims) == 2:
            styles[name.rsplit(".", 1)[0]] = ("col" if dims[0] == "model"
                                              else "row")
    pairs: Dict[str, set] = {}
    for module, style in styles.items():
        pairs.setdefault(module.rsplit(".", 1)[0], set()).add(style)
    return {module: (ColwiseParallel() if style == "col"
                     else RowwiseParallel())
            for module, style in styles.items()
            if pairs[module.rsplit(".", 1)[0]] == {"col", "row"}}


def tp_kept_whole(placements: Dict[str, Placement]) -> List[str]:
    """The parameters the rules place on "model" that ``_tp_plan`` keeps
    whole: FSDP2 and ``parallelize_module`` have no form for a stacked
    kernel split over "model" (JAX's fsdp rule on a ``scan_layers``
    stack) or for a projection pair split on one side only."""
    plan = _tp_plan(placements)
    return [n for n, dims in placements.items()
            if "model" in dims and n.rsplit(".", 1)[0] not in plan]


def shard_model(model: nn.Module, mesh, mode: str = "replicated",
                fsdp_min_size: int = FSDP_MIN_SIZE) -> ShardedModel:
    """Place ``model`` (on this rank's device) on ``mesh`` by the rules:
    tensor parallelism over "model", then DDP (``replicated``) or
    ``fully_shard`` (``fsdp``) over "data".  The model is changed in
    place; build its optimizer after this (``shard_state``)."""
    from torch.distributed.tensor import Shard

    sizes = mesh_sizes(mesh)
    placements = infer_param_sharding(sizes, model, mode, fsdp_min_size)
    if sizes["model"] > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        parallelize_module(model, mesh["model"], _tp_plan(placements))
    params = dict(model.named_parameters())
    if mode == "fsdp":
        from torch.distributed.fsdp import fully_shard

        data_dim = {id(params[n]): dims.index("data")
                    for n, dims in placements.items() if "data" in dims}
        whole = [params[n] for n, dims in placements.items()
                 if "data" not in dims]
        fully_shard(model, mesh=mesh["data"],
                    shard_placement_fn=lambda p: Shard(data_dim[id(p)]),
                    ignored_params=set(whole) or None)
        return ShardedModel(model, model, mesh, placements, whole)
    if sizes["model"] > 1:
        return ShardedModel(model, model, mesh, placements,
                            list(params.values()))
    device = next(model.parameters()).device
    ddp = nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=mesh["data"].get_group())
    return ShardedModel(ddp, model, mesh, placements, [])


def _place_like(param, moment: torch.Tensor):
    """A moment of a whole parameter placed as the (sharded) parameter."""
    if not hasattr(param, "device_mesh"):
        return moment.to(param.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(moment.to(param.to_local().device),
                             param.device_mesh, param.placements)


def shard_state(state, mesh, mode: str = "replicated",
                fsdp_min_size: int = FSDP_MIN_SIZE):
    """A ``TrainState`` placed on ``mesh`` (JAX's ``shard_state``): the
    model sharded by ``shard_model`` (``state.sharded``), its optimizer
    rebuilt over the sharded parameters with the same settings, and any
    Adam moments it held placed as their parameters."""
    from cliffordtpu_torch.train.state import ClippedOptimizer

    opt = state.optimizer
    names = [n for n, _ in state.model.named_parameters()]
    saved = opt.inner.state_dict()
    index = [n for g in group_names(names, len(saved["param_groups"]))
             for n in g]
    moments = {index[i]: st for i, st in saved["state"].items()}
    sharded = shard_model(state.model, mesh, mode, fsdp_min_size)
    params = dict(state.model.named_parameters())
    # the fused kernel on the card, as make_optimizer; one call of it takes
    # DTensors or plain tensors, not both, so each group splits in two
    groups = [{**_settings(g), "params": part}
              for g, names_ in zip(saved["param_groups"],
                                   group_names(names,
                                               len(saved["param_groups"])))
              for part in _by_kind([params[n] for n in names_]) if part]
    inner = type(opt.inner)(groups, fused=all(
        p.device.type == "cuda" for p in params.values()))
    for n, st in moments.items():
        inner.state[params[n]] = {
            k: (_place_like(params[n], v) if k != "step" else v)
            for k, v in st.items()}
    new = ClippedOptimizer(inner, opt.clip_norm, opt.accum_steps)
    return replace(state, optimizer=new, sharded=sharded)


def _by_kind(params) -> Tuple[list, list]:
    """(the DTensors, the plain tensors) of ``params``."""
    return ([p for p in params if hasattr(p, "device_mesh")],
            [p for p in params if not hasattr(p, "device_mesh")])


def _settings(group: dict) -> dict:
    """A parameter group's settings, without its parameters and kernel
    choice."""
    return {k: v for k, v in group.items()
            if k not in ("params", "fused", "foreach")}


def unshard_state(state, plain: nn.Module):
    """A sharded ``TrainState`` gathered into ``plain`` (an unsharded model
    built as the sharded one was): its parameters and Adam moments as
    whole tensors on every rank (a collective: every rank calls it).
    Returns a ``TrainState`` of ``plain`` with no ``sharded``."""
    from cliffordtpu_torch.train.state import ClippedOptimizer

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    plain_params = dict(plain.named_parameters())
    twin = {id(p): plain_params[n]
            for n, p in state.model.named_parameters()}
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            plain_params[n].copy_(whole(p.detach()))
    opt = state.optimizer
    groups = [{**_settings(g), "params": [twin[id(p)] for p in g["params"]]}
              for g in opt.inner.param_groups]
    inner = type(opt.inner)(groups, fused=all(
        p.device.type == "cuda" for p in plain_params.values()))
    for p, st in opt.inner.state.items():
        inner.state[twin[id(p)]] = {k: whole(v) for k, v in st.items()}
    new = ClippedOptimizer(inner, opt.clip_norm, opt.accum_steps)
    new.micro_step = opt.micro_step
    return replace(state, model=plain, optimizer=new, sharded=None)


def make_sharded_cnn_train_step(model: ShardedModel, optimizer,
                                mesh=None) -> Callable:
    """``train_step(x, key, beta) -> losses`` on ``mesh`` (the model's by
    default), ``train/loop.py::make_cnn_train_step`` on the global batch:
    ``x`` is this rank's rows (B/n of the global B), drawn as those rows
    of the global draw; the gradients are the global batch's (DDP / FSDP2
    average them over "data", ``sync_grads`` the rest); the returned
    losses are the global-batch means and ``grad_norm`` the global norm
    from before the clip, over sharded gradients."""
    mesh = mesh if mesh is not None else model.mesh
    n = mesh["data"].size()
    r = data_rank(mesh)
    group = mesh["data"].get_group()

    def global_means(losses):
        names = list(losses)
        stacked = torch.stack([losses[k].float().reshape(()) for k in names])
        if n > 1:
            dist.all_reduce(stacked, group=group)
            stacked = stacked / n
        return dict(zip(names, stacked.unbind(0)))

    def loss_fn(x, key, beta):
        b = x.shape[0]
        return _losses(model.model, x, key, beta, rows=(r * b, n * b),
                       call=model)

    return _train_step(optimizer, loss_fn, "total_loss",
                       after_backward=model.sync_grads, reduce=global_means)
