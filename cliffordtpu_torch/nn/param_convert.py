"""Exact param-tree conversion between the split and fused ViT projection
layouts: the port's own copy of ``cliffordtpu/nn/param_convert.py`` (pure
numpy, no JAX), on JAX's trees.

It rearranges the SAME weights, so a model trained in one layout can be
evaluated or resumed in the other bit for bit (every fused output column
is the same fan-in reduction as its split counterpart).
``train/checkpoint.py`` converts restored trees with it, and
``nn/param_import.py`` carries either layout onto the port's modules
(``CliffordARVAE(fused_proj=)``).

Layouts (``nn/vit_vae.py``; JAX's (in, out) kernels):
* ``wqkv``: (D, 3D), head-interleaved — for head h, columns
  [3*hd*h : 3*hd*(h+1)] are [q_h | k_h | v_h].
* ``w13``: (D, 2*d_ff), column-pair interleaved — (w1_0, w3_0, w1_1, ...).

Both converters walk nested dicts of numpy arrays: JAX param trees,
optimizer moment trees (adam mu/nu mirror the param structure and
transform elementwise with the same rearrangement) and layer-stacked
``scan_layers`` trees (kernels with a leading layer axis; the
rearrangement acts on the trailing two axes).  ``nest`` / ``flatten``
turn a flat ``params.npz`` dict ("a/b/c" keys) into such a tree and back.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _is_dict(x) -> bool:
    return isinstance(x, dict)


def _fuse_qkv(q, k, v, n_heads: int):
    """(..., D, D) x3 -> (..., D, 3D) head-interleaved."""
    q, k, v = np.asarray(q), np.asarray(k), np.asarray(v)
    D = q.shape[-1]
    hd = D // n_heads
    lead = q.shape[:-1]  # (..., D_in) leading axes incl. fan_in
    qh = q.reshape(lead + (n_heads, hd))
    kh = k.reshape(lead + (n_heads, hd))
    vh = v.reshape(lead + (n_heads, hd))
    fused = np.stack([qh, kh, vh], axis=-2)  # (..., H, 3, hd)
    return fused.reshape(lead + (3 * D,))


def _unfuse_qkv(wqkv, n_heads: int):
    """(..., D_in, 3D) head-interleaved -> q, k, v of (..., D_in, D)."""
    wqkv = np.asarray(wqkv)
    D = wqkv.shape[-1] // 3
    hd = D // n_heads
    lead = wqkv.shape[:-1]
    y = wqkv.reshape(lead + (n_heads, 3, hd))
    q = y[..., 0, :].reshape(lead + (D,))
    k = y[..., 1, :].reshape(lead + (D,))
    v = y[..., 2, :].reshape(lead + (D,))
    return q, k, v


def _fuse_w13(w1, w3):
    """(..., D, F) x2 -> (..., D, 2F) pair-interleaved."""
    w1, w3 = np.asarray(w1), np.asarray(w3)
    F = w1.shape[-1]
    lead = w1.shape[:-1]
    return np.stack([w1, w3], axis=-1).reshape(lead + (2 * F,))


def _unfuse_w13(w13):
    w13 = np.asarray(w13)
    F = w13.shape[-1] // 2
    lead = w13.shape[:-1]
    y = w13.reshape(lead + (F, 2))
    return y[..., 0], y[..., 1]


def fuse_vit_params(tree: Any, n_heads: int) -> int:
    """In-place: split Attention/SwiGLU param dicts -> fused layout.

    Returns the number of modules converted.  Safe on adam moment trees
    (same structure, elementwise semantics).  Dicts already in the fused
    layout are left untouched.
    """
    if isinstance(tree, (list, tuple)):
        return sum(fuse_vit_params(sub, n_heads) for sub in tree)
    if not _is_dict(tree):
        return 0
    n = 0
    for key, sub in tree.items():
        if not _is_dict(sub):
            continue
        name = str(key)
        if name.startswith("Attention_") and "Dense_3" in sub:
            q, k, v = (sub.pop(f"Dense_{i}") for i in (0, 1, 2))
            out = sub.pop("Dense_3")
            sub["wqkv"] = {"kernel": _fuse_qkv(
                q["kernel"], k["kernel"], v["kernel"], n_heads)}
            sub["wo"] = out
            n += 1
        elif name.startswith("SwiGLU_") and "Dense_2" in sub:
            w1 = sub.pop("Dense_0")
            w3 = sub.pop("Dense_1")
            w2 = sub.pop("Dense_2")
            sub["w13"] = {"kernel": _fuse_w13(w1["kernel"], w3["kernel"])}
            sub["w2"] = w2
            n += 1
        else:
            n += fuse_vit_params(sub, n_heads)
    return n


def unfuse_vit_params(tree: Any, n_heads: int) -> int:
    """In-place inverse of :func:`fuse_vit_params` (exact round-trip)."""
    if isinstance(tree, (list, tuple)):
        return sum(unfuse_vit_params(sub, n_heads) for sub in tree)
    if not _is_dict(tree):
        return 0
    n = 0
    for key, sub in tree.items():
        if not _is_dict(sub):
            continue
        name = str(key)
        if name.startswith("Attention_") and "wqkv" in sub:
            q, k, v = _unfuse_qkv(sub.pop("wqkv")["kernel"], n_heads)
            out = sub.pop("wo")
            sub["Dense_0"] = {"kernel": q}
            sub["Dense_1"] = {"kernel": k}
            sub["Dense_2"] = {"kernel": v}
            sub["Dense_3"] = out
            n += 1
        elif name.startswith("SwiGLU_") and "w13" in sub:
            w1, w3 = _unfuse_w13(sub.pop("w13")["kernel"])
            w2 = sub.pop("w2")
            sub["Dense_0"] = {"kernel": w1}
            sub["Dense_1"] = {"kernel": w3}
            sub["Dense_2"] = w2
            n += 1
        else:
            n += unfuse_vit_params(sub, n_heads)
    return n


def nest(flat: dict) -> dict:
    """A flat "a/b/c" dict -> the nested dict the converters walk."""
    tree: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """``nest``'s inverse."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if _is_dict(val):
            out.update(flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def detect_proj_layout(tree: Any) -> str:
    """"fused" | "split" | "none" by inspecting Attention/SwiGLU keys."""
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            lay = detect_proj_layout(sub)
            if lay != "none":
                return lay
        return "none"
    if not _is_dict(tree):
        return "none"
    for key, sub in tree.items():
        if not _is_dict(sub):
            continue
        name = str(key)
        if name.startswith(("Attention_", "SwiGLU_")):
            if "wqkv" in sub or "w13" in sub:
                return "fused"
            if "Dense_2" in sub or "Dense_3" in sub:
                return "split"
        lay = detect_proj_layout(sub)
        if lay != "none":
            return lay
    return "none"
