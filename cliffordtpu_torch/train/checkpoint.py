"""Checkpoints: save, resume, and carry a run that the JAX package
checkpointed (port of ``cliffordtpu/train/checkpoint.py``).

``save_checkpoint`` writes one ``torch.save`` file, ``best_model.ckpt``
under the output directory, replacing any earlier one: the model's
``state_dict``, the optimizer's (Adam(W) moments and step counts, both
parameter groups when the learnable-beta sigmas train at their own
rate), the gradient accumulator of an ``accum_steps`` optimizer, the run's
step, its best metric, the key's two uint32 words and a format tag.
``load_checkpoint`` reads it back (None when there is none) and
``restore_checkpoint`` loads it into a model and optimizer built as the
saved ones were; the steps that follow are the ones the run would have
taken (on the card, bit for bit where the run's own steps are: under
cuDNN's deterministic algorithms, ``torch.backends.cudnn.deterministic``,
as two uninterrupted runs differ without them).

``state_from_jax`` carries what the JAX ``load_checkpoint`` returns (numpy
leaves restored by orbax without a target) into the port: the parameters
through ``nn/param_import.py``, and Adam's count, mu and nu as torch's
step, exp_avg and exp_avg_sq, each moment through its parameter's layout
rule.  It reads the optimizer states of ``cliffordtpu/train/state.py``:
the ``clip_by_global_norm`` + ``adam`` / ``adamw`` chain, its
``multi_transform`` sigma group, ``fused_adam``'s flat moments (in
``ravel_pytree`` order) and ``optax.MultiSteps`` around any of them.  A
checkpoint from before the half-split RoPE layout (no ``rope_layout``
tag, attention kernels present) has its q / k kernels and their moments
permuted first.  A ``CliffordARVAE`` tree of any block layout carries:
fused or split projections (``proj_layout``, else read from the keys) are
converted to the receiving model's ``fused_proj`` with
``nn/param_convert.py``, parameters and moments alike, as JAX's
``load_checkpoint(fused_proj=)`` converts them, and a ``scan_layers``
tree goes onto a ``scan_layers`` model.

``restore_checkpoint`` converts the port's own checkpoints the same way
when the saved model's projections and the receiving model's differ.
"""

from __future__ import annotations

import copy
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cliffordtpu_torch import random
from cliffordtpu_torch.nn import param_convert
from cliffordtpu_torch.nn.param_import import from_jax, port_to_jax
from cliffordtpu_torch.nn.vit_vae import Attention
from cliffordtpu_torch.train.state import group_names

CKPT_NAME = "best_model.ckpt"
FORMAT = "cliffordtpu_torch/1"


def _path(output_dir: str) -> str:
    return os.path.abspath(os.path.join(output_dir, CKPT_NAME))


def _remove(path: str):
    if os.path.isdir(path):  # a JAX (orbax) checkpoint is a directory
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def save_checkpoint(output_dir: str, state, step: int = 0,
                    best_metric: float = 0.0, rng_key=None) -> str:
    """Save ``state`` (``train/state.py::TrainState``), the step, the best
    metric and the key; returns the file's path."""
    path = _path(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    _remove(path)
    opt = state.optimizer
    payload = {
        "format": FORMAT,
        "model": state.model.state_dict(),
        "optimizer": opt.inner.state_dict(),
        "micro_step": opt.micro_step,
        "accumulator": opt._acc,
        "step": int(step),
        "best_metric": float(best_metric),
        "rng_key": (None if rng_key is None
                    else list(random.key_words(rng_key))),
    }
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(output_dir: str) -> Optional[Dict[str, Any]]:
    """The payload that ``save_checkpoint`` wrote (tensors on the CPU), or
    None when ``output_dir`` holds no checkpoint."""
    path = _path(output_dir)
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a JAX (orbax) checkpoint: restore it with the JAX "
            f"package's load_checkpoint and carry it with state_from_jax")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: unknown checkpoint format "
                         f"{payload.get('format')!r}")
    return payload


def _fused(names) -> bool:
    return any(n.endswith(".wqkv.weight") for n in names)


def _converter(model):
    """Port tensors by name, in the other projection layout -> in
    ``model``'s, through JAX's flat keys and ``param_convert``."""
    distribution = getattr(model, "distribution", "clifford")
    n_heads = _n_heads(model)
    conv = (param_convert.fuse_vit_params if _fused(
        n for n, _ in model.named_parameters())
        else param_convert.unfuse_vit_params)

    def convert(by_name: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        tree = param_convert.nest(port_to_jax(by_name, distribution))
        conv(tree, n_heads)
        return from_jax(param_convert.flatten(tree), distribution)

    return convert


def _convert_layout(payload: Dict[str, Any], model) -> Dict[str, Any]:
    """A port checkpoint of one projection layout in the other (the
    receiving ``model``'s): parameters, Adam moments and the
    accumulator."""
    convert = _converter(model)
    out = dict(payload)
    out["model"] = convert(payload["model"])
    opt = payload["optimizer"]
    n_groups = len(opt["param_groups"])
    old = sum(group_names(list(payload["model"]), n_groups), [])
    new_groups = group_names([n for n, _ in model.named_parameters()],
                              n_groups)
    new = sum(new_groups, [])
    state = {old[i]: st for i, st in opt["state"].items()}
    moments = {}
    if state:
        moments = {m: convert({n: st[m] for n, st in state.items()})
                   for m in ("exp_avg", "exp_avg_sq")}
    steps = {("sigma" if "log_sigma" in n else "main"): st["step"]
             for n, st in state.items()}
    groups, i = [], 0
    for g, names in zip(opt["param_groups"], new_groups):
        groups.append({**g, "params": list(range(i, i + len(names)))})
        i += len(names)
    out["optimizer"] = {
        "state": {i: {"step": steps["sigma" if "log_sigma" in n else "main"],
                      "exp_avg": moments["exp_avg"][n],
                      "exp_avg_sq": moments["exp_avg_sq"][n]}
                  for i, n in enumerate(new) if moments},
        "param_groups": groups}
    if payload["accumulator"] is not None:
        acc = convert(dict(zip(old, payload["accumulator"])))
        out["accumulator"] = [acc[n] for n in new]
    return out


def load_model_state(model, payload: Dict[str, Any]) -> None:
    """Load a port checkpoint's parameters into ``model``, converted first
    when its projections are stored in the other layout."""
    params = payload["model"]
    if _fused(params) != _fused(n for n, _ in model.named_parameters()):
        params = _converter(model)(params)
    model.load_state_dict(params)


def restore_checkpoint(state, payload: Dict[str, Any]) -> Dict[str, Any]:
    """Load ``payload`` into ``state``'s model and optimizer (built with
    the saved run's optimizer settings); returns its step, best metric and
    key.  A checkpoint whose projections are fused where the model's are
    split, or the reverse, is converted first (``_convert_layout``)."""
    if _fused(payload["model"]) != _fused(
            n for n, _ in state.model.named_parameters()):
        payload = _convert_layout(payload, state.model)
    state.model.load_state_dict(payload["model"])
    opt = state.optimizer
    opt.inner.load_state_dict(payload["optimizer"])
    opt.micro_step = payload["micro_step"]
    acc = payload["accumulator"]
    opt._acc = None if acc is None else [a.to(state.device) for a in acc]
    return _meta(payload)


def _meta(payload) -> Dict[str, Any]:
    key = payload.get("rng_key")
    return {"step": int(payload.get("step", 0)),
            "best_metric": float(payload.get("best_metric", 0.0)),
            "rng_key": None if key is None else random.key_words(key)}


def delete_checkpoint(output_dir: str) -> None:
    """Delete the checkpoint after its evaluation; a failure is reported,
    not raised."""
    path = _path(output_dir)
    if os.path.exists(path):
        try:
            _remove(path)
        except OSError as e:
            print(f"warning: failed to delete {path}: {e}")


# ---- a JAX run's checkpoint ----


def _rope_half_perm(out_dim: int, n_heads: int) -> np.ndarray:
    """Column permutation interleaved-pair -> half-split, per head."""
    idx = np.arange(out_dim).reshape(n_heads, out_dim // n_heads)
    return np.concatenate([idx[:, 0::2], idx[:, 1::2]], axis=1).reshape(-1)


def _migrate_rope_layout(tree: Any, n_heads: int) -> int:
    """Permute every ``Attention_*/Dense_{0,1}/kernel`` (q, k) in place
    from the interleaved to the half-split RoPE layout, in a parameter
    tree or a moment tree alike; returns the number of kernels
    permuted."""
    if isinstance(tree, (list, tuple)):
        return sum(_migrate_rope_layout(sub, n_heads) for sub in tree)
    if not isinstance(tree, dict):
        return 0
    n = 0
    for key, sub in tree.items():
        if str(key).startswith("Attention_") and isinstance(sub, dict):
            for dense in ("Dense_0", "Dense_1"):
                kern = (sub[dense].get("kernel")
                        if isinstance(sub.get(dense), dict) else None)
                if kern is not None and np.ndim(kern) >= 2:
                    perm = _rope_half_perm(np.shape(kern)[-1], n_heads)
                    sub[dense]["kernel"] = np.asarray(kern)[..., perm]
                    n += 1
        n += _migrate_rope_layout(sub, n_heads)
    return n


def _has_attention_kernels(tree: Any) -> bool:
    if isinstance(tree, (list, tuple)):
        return any(_has_attention_kernels(v) for v in tree)
    if not isinstance(tree, dict):
        return False
    return any(str(k).startswith("Attention_") or _has_attention_kernels(v)
               for k, v in tree.items())


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(flat "a/b/c" key, leaf) in ``jax.tree_util`` order: dict keys
    sorted at every level."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(
            tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _unravel(flat: np.ndarray, params) -> Dict[str, np.ndarray]:
    """``ravel_pytree``'s inverse: the flat vector cut into the leaves of
    ``params``, as flat keys."""
    out, i = {}, 0
    for k, leaf in _leaves(params):
        n = int(np.prod(np.shape(leaf)))
        out[k] = np.asarray(flat[i:i + n]).reshape(np.shape(leaf))
        i += n
    if i != np.size(flat):
        raise ValueError(f"fused moments hold {np.size(flat)} values, the "
                         f"parameters {i}")
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        *path, last = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _adam_moments(state) -> Tuple[int, Dict, Dict]:
    """(count, mu, nu as flat dicts without the None leaves) of one
    ``scale_by_adam`` state, the first of its chain."""
    adam = state[0] if isinstance(state, (list, tuple)) else state
    if not (isinstance(adam, dict) and {"count", "mu", "nu"} <= set(adam)):
        raise ValueError(f"not an Adam state: {type(adam).__name__}")
    mu = {k: v for k, v in _leaves(adam["mu"]) if v is not None}
    nu = {k: v for k, v in _leaves(adam["nu"]) if v is not None}
    return int(np.asarray(adam["count"])), mu, nu


def _parse_opt_state(opt_state, params):
    """The JAX optimizer state -> (counts {"main", "sigma"}, mu, nu as
    nested trees, MultiSteps (mini_step, acc_grads tree) or None)."""
    multi = None
    if isinstance(opt_state, dict) and "inner_opt_state" in opt_state:
        multi = (int(np.asarray(opt_state["mini_step"])),
                 opt_state["acc_grads"])
        opt_state = opt_state["inner_opt_state"]
    if isinstance(opt_state, dict) and {"m", "v", "count"} <= set(opt_state):
        count = int(np.asarray(opt_state["count"]))
        mu = _unravel(opt_state["m"], params)
        nu = _unravel(opt_state["v"], params)
        return {"main": count, "sigma": count}, _nest(mu), _nest(nu), multi
    if not (isinstance(opt_state, (list, tuple)) and len(opt_state) == 2
            and opt_state[0] is None):
        raise ValueError("unrecognised optimizer state: expected the "
                         "clip_by_global_norm chain of "
                         "cliffordtpu/train/state.py::make_optimizer")
    inner = opt_state[1]
    if isinstance(inner, dict) and "inner_states" in inner:
        counts, mu, nu = {}, {}, {}
        for group in ("main", "sigma"):
            counts[group], m, v = _adam_moments(
                inner["inner_states"][group]["inner_state"])
            mu.update(m)
            nu.update(v)
        return counts, _nest(mu), _nest(nu), multi
    count, mu, nu = _adam_moments(inner)
    return {"main": count, "sigma": count}, _nest(mu), _nest(nu), multi


def _n_heads(model) -> int:
    for m in model.modules():
        if isinstance(m, Attention):
            return m.n_heads
    raise ValueError("a checkpoint with attention kernels for a model "
                     "without attention")


def _flat(tree) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v, dtype=np.float32) for k, v in _leaves(tree)}


def state_from_jax(payload: Dict[str, Any], model, optimizer=None
                   ) -> Dict[str, Any]:
    """Carry a JAX checkpoint ``payload`` into ``model`` and, given,
    ``optimizer`` (``train/state.py::ClippedOptimizer``, built over
    ``model`` with the JAX run's optimizer, learning rate, sigma group and
    accumulation).  Returns the run's step, best metric and key."""
    params = copy.deepcopy(payload["params"])
    moments = None
    if optimizer is not None:
        counts, mu, nu, multi = _parse_opt_state(
            copy.deepcopy(payload["opt_state"]), params)
        moments = [mu, nu] + ([multi[1]] if multi else [])
    if payload.get("rope_layout") is None and _has_attention_kernels(params):
        n_heads = _n_heads(model)
        _migrate_rope_layout(params, n_heads)
        _migrate_rope_layout(moments, n_heads)
    stored = (payload.get("proj_layout")
              or param_convert.detect_proj_layout(params))
    want = "fused" if getattr(model, "fused_proj", False) else "split"
    if stored not in ("none", want):
        conv = (param_convert.fuse_vit_params if want == "fused"
                else param_convert.unfuse_vit_params)
        conv(params, _n_heads(model))
        conv(moments, _n_heads(model))
    distribution = getattr(model, "distribution", "clifford")
    model.load_state_dict(from_jax(_flat(params), distribution))
    if optimizer is not None:
        _load_optimizer(optimizer, model, distribution, counts, moments,
                        multi)
    return _meta(payload)


def _load_optimizer(optimizer, model, distribution, counts, moments, multi):
    mu, nu = (from_jax(_flat(t), distribution) for t in moments[:2])
    names = {id(p): n for n, p in model.named_parameters()}
    inner = optimizer.inner
    saved = inner.state_dict()
    state = {}
    for group, saved_group in zip(inner.param_groups, saved["param_groups"]):
        for p, idx in zip(group["params"], saved_group["params"]):
            name = names[id(p)]
            count = counts["sigma" if "log_sigma" in name else "main"]
            state[idx] = {"step": torch.tensor(float(count)),
                          "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    inner.load_state_dict({"state": state,
                           "param_groups": saved["param_groups"]})
    if multi is None:
        if optimizer.accum_steps > 1:
            raise ValueError("the optimizer accumulates gradients; the JAX "
                             "run did not (no optax.MultiSteps state)")
        return
    if optimizer.accum_steps == 1:
        raise ValueError("the JAX run accumulates gradients "
                         "(optax.MultiSteps); build the optimizer with its "
                         "accum_steps")
    mini_step = multi[0]
    optimizer.micro_step = mini_step
    optimizer._acc = None
    if mini_step:
        acc = from_jax(_flat(moments[2]), distribution)
        optimizer._acc = [acc[names[id(p)]].to(p.device)
                          for g in inner.param_groups for p in g["params"]]
