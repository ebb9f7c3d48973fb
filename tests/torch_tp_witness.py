"""Why the split layout under (2, 2) tensor parallelism parts from the
single-device step at step 5: witnesses on the CPU, at the shapes of
tests/test_torch_parallel.py (its 2-head tiny ``CliffordARVAE``, batch
8, AdamW 1e-4, clip 1.0, 5 steps).

Prints, for each run, the relative distance of its loss and ``grad_norm``
from the plain float32 single-device step, step by step, and from the
same step in float64:

* ``split_gemms``: one device, the projections computed as the "model"
  axis splits them (tests/torch_parallel_ranks.py), no collective;
* ``halves``: one device, the batch in two halves of the global draw,
  their gradients averaged (a (2, 1) mesh's math);
* ``dp_tp`` / ``fsdp_tp_split``: the 4-rank CPU gloo group's steps;
* ``float64``: the plain step from the same float32 init, run in float64
  (this process maps the model's float32 casts to float64).

Then the parameter entries that Adam's first update moves furthest apart
in ``split_gemms`` against the plain step, with their raw gradients.

With ``--jax``, the same model in the JAX package, from its own init on
its images and keys (a 4-device virtual CPU mesh): JAX's (2, 2) FSDP x TP
step against JAX's single-device step, and the port's plain and
``split_gemms`` steps from JAX's weights against JAX's single device.

    OMP_NUM_THREADS=1 python tests/torch_tp_witness.py [--jax]
"""

import json
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402
from cliffordtpu_torch.nn.conv_vae import cnn_vae_loss  # noqa: E402
from cliffordtpu_torch.train.loop import make_cnn_train_step  # noqa: E402
from cliffordtpu_torch.train.state import create_train_state  # noqa: E402


def _state(model):
    return create_train_state(model, "adamw", ranks.LR, device="cpu")


def _record_first_update(st):
    """Keep the raw gradients and the parameters after step 1."""
    seen = {}
    step = st.optimizer.step

    def wrapped():
        first = not seen
        if first:
            seen["grad"] = {n: p.grad.detach().clone()
                            for n, p in st.model.named_parameters()}
        norm = step()
        if first:
            seen["param"] = {n: p.detach().clone()
                             for n, p in st.model.named_parameters()}
        return norm

    st.optimizer.step = wrapped
    return seen


def plain_and_split():
    x = ranks.images()
    out, first = {}, {}
    for name, model in (("plain", ranks.tiny(128)),
                        ("split_gemms", ranks.split_gemms(ranks.tiny(128)))):
        st = _state(model)
        first[name] = _record_first_update(st)
        out[name] = ranks.run_steps(make_cnn_train_step(st.model,
                                                        st.optimizer), x)
    return out, first


def halves(n=2):
    st = _state(ranks.tiny(128))
    model, opt = st.model, st.optimizer
    x = ranks.images()
    b = x.shape[0] // n

    def step(x, key, beta):
        opt.zero_grad()
        total = 0.0
        for r in range(n):
            xr = x[r * b:(r + 1) * b]
            x_recon, q_z, p_z, _ = model(xr, key, rows=(r * b, n * b))
            loss = cnn_vae_loss(xr, x_recon, q_z, p_z, model.distribution,
                                beta=beta,
                                recon_loss_type=model.recon_loss_type,
                                l1_weight=model.l1_weight,
                                sigmas=model.loss_sigmas())["total_loss"] / n
            loss.backward()
            total = total + loss.detach()
        return {"total_loss": total, "grad_norm": opt.step()}

    return ranks.run_steps(step, x)


def float64():
    """The plain step in float64 from the float32 init."""
    model = ranks.tiny(128).double()
    to = torch.Tensor.to

    def wide(v):
        return torch.float64 if v is torch.float32 else v

    torch.Tensor.float = lambda self, *a, **k: self.double()
    torch.Tensor.to = lambda self, *a, **k: to(
        self, *[wide(v) for v in a], **{n: wide(v) for n, v in k.items()})
    st = _state(model)
    return ranks.run_steps(make_cnn_train_step(st.model, st.optimizer),
                           ranks.images().double())


def group_steps():
    """The 4-rank group's steps (tests/torch_parallel_ranks.py)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        procs = [subprocess.Popen(
            [sys.executable, ranks.__file__, out],
            env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE="4", LOCAL_WORLD_SIZE="4",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     OMP_NUM_THREADS="1"),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for r in range(4)]
        if any(p.wait() for p in procs):
            raise RuntimeError("the 4-rank group failed")
        with open(out) as f:
            return json.load(f)["steps"]


def _rel(got, want):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(g / w - 1)
    return {"loss": [float(f"{v:.3g}") for v in d[:, 0]],
            "grad_norm": [float(f"{v:.3g}") for v in d[:, 1]]}


def jax_witness():
    """JAX's (2, 2) FSDP x TP and single-device steps of the 2-head tiny
    model from JAX's init, and the port's steps from the same weights."""
    import jax
    import jax.numpy as jnp

    from cliffordtpu.nn import CliffordARVAE as JaxViT
    from cliffordtpu.parallel.mesh import create_mesh
    from cliffordtpu.parallel.sharding import (
        make_sharded_cnn_train_step,
        shard_state,
    )
    from cliffordtpu.serving import _flatten_params
    from cliffordtpu.train.loop import make_cnn_train_step as jax_step
    from cliffordtpu.train.state import create_train_state as jax_state
    from cliffordtpu_torch import random
    from cliffordtpu_torch.nn import param_import

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    key = jax.random.PRNGKey(0)
    model = JaxViT(latent_dim=8, image_size=32, in_channels=1,
                   distribution="clifford", cnn_chs=[16, 32, 128],
                   z_channels=128, encoder_vit_layers=1,
                   decoder_vit_layers=1, patch_size=4)
    x = jax.random.uniform(key, (ranks.BATCH, 32, 32, 1)) * 2 - 1
    single = jax_state(key, model, x[:2], optimizer="adamw", lr=ranks.LR)
    flat = {k: np.asarray(v)
            for k, v in _flatten_params(single.params).items()}
    mesh = create_mesh((2, 2))
    sharded = shard_state(mesh, jax_state(key, model, x[:2],
                                          optimizer="adamw", lr=ranks.LR),
                          mode="fsdp", fsdp_min_size=ranks.FSDP_MIN)
    steps = {"jax": jax_step(model),
             "jax_fsdp_tp": make_sharded_cnn_train_step(model, mesh)}
    states = {"jax": single, "jax_fsdp_tp": sharded}
    runs = {name: [] for name in steps}
    for i in range(ranks.STEPS):
        k = jax.random.fold_in(key, i)
        for name, step in steps.items():
            states[name], losses = step(states[name], x, k,
                                        jnp.float32(1.0))
            runs[name].append((float(losses["total_loss"]),
                               float(losses["grad_norm"])))
    xt = torch.from_numpy(np.array(x))
    for name, split in (("port", False), ("port_split_gemms", True)):
        port = ranks.tiny(128)
        port.load_state_dict(param_import.from_jax(flat))
        st = _state(ranks.split_gemms(port) if split else port)
        step = make_cnn_train_step(st.model, st.optimizer)
        runs[name] = [
            (float(out["total_loss"]), float(out["grad_norm"]))
            for out in (step(xt, random.sample_key(np.asarray(
                jax.random.fold_in(key, i))), torch.tensor(1.0))
                for i in range(ranks.STEPS))]
    for name, got in runs.items():
        print(json.dumps({"run": name, "vs_jax": _rel(got, runs["jax"]),
                          "vs_port": _rel(got, runs["port"])}))


def main():
    torch.set_num_threads(1)
    runs, first = plain_and_split()
    runs["halves"] = halves()
    steps = group_steps()
    runs["dp_tp"] = steps["dp_tp"]
    runs["fsdp_tp_split"] = steps["fsdp_tp_split"]
    runs["float64"] = float64()
    for name, got in runs.items():
        print(json.dumps({"run": name, "vs_plain": _rel(got, runs["plain"]),
                          "vs_float64": _rel(got, runs["float64"])}))
    moved = []
    for n, p in first["plain"]["param"].items():
        d = (first["split_gemms"]["param"][n] - p).abs().flatten()
        for i in d.argsort(descending=True)[:2].tolist():
            moved.append((float(d[i]), n, i))
    for d, n, i in sorted(moved, reverse=True)[:4]:
        g = {k: float(first[k]["grad"][n].flatten()[i])
             for k in ("plain", "split_gemms")}
        print(json.dumps({"param": n, "entry": i, "moved_apart": d,
                          "raw_grad": g}))


if __name__ == "__main__":
    jax_witness() if "--jax" in sys.argv else main()
