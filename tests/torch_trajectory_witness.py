"""Does the port train a CNN runner cell as the JAX package does?  A
witness on the CPU at the CNN check's flags (``fashion_train --dataset
mnist32 --latent_dims 128 --require_real``, the committed shard
``tests/data/mnist/mnist.npz``, batch 256, lr 1e-3, the cyclical beta,
patience 50), for one (arch, dist) cell and one trial.  JAX trains with
its per-step program: the check ran ``--scan_epochs``, whose epoch
program draws the same keys but took 1100 s for its first epoch on 8
CPUs, where the per-step program took 116 s.

The trial's run key is derived as both runners derive it
(``fold_in(PRNGKey(seed), stable_hash(128, dist, trial) % 2**31)``).
JAX's initial weights (``create_train_state`` on that key) are carried
to the port by ``param_import.from_jax``; then both packages train from
them through their own ``train_model``, each epoch recorded by a logger
that also reads, on a fixed batch of 256 test images, the batch mean of
the per-token concentration kappa and the share of kappa within 1e-3 of
``concentration_floor`` (the plateau's signature: a head that gave up
on its tokens sits on the floor).

The yardstick is the rule of tests/test_torch_runner.py: the port may
part from JAX by at most twice a package's own parting when the training
images move by 1e-6 (normal, seed 0).  The port's own parting is taken
over every epoch; JAX's over the first ``--jax_own_epochs``.  An epoch
whose parameters (largest absolute difference) part beyond twice the
yardstick is a parting; the first such epoch is then walked step by step
through each package's ``make_cnn_train_step`` with the runner's keys,
and at the first parting step every parameter's pre-clip gradient is
held against JAX's.

    JAX_PLATFORMS=cpu python tests/torch_trajectory_witness.py \\
        --arch hybrid --dist clifford --trial 1 --epochs 20 \\
        --jax_own_epochs 2 --out OUT.json
    JAX_PLATFORMS=cpu python tests/torch_trajectory_witness.py \\
        --arch hybrid --dist clifford --at_jax_weights 5 --out OUT.json
    JAX_PLATFORMS=cpu python tests/torch_trajectory_witness.py \\
        --arch vit --dist clifford --inits DIR --trials 1 8

``--at_jax_weights N`` only holds both packages' gradients at JAX's
weights over epoch 1's first N steps (``at_jax_weights``: with the
runner's recon loss and with "mse", and the pixels where the l1 loss's
gradient in x_recon changes sign).  ``--inits`` only writes JAX's initial
weights of the trials as recipes ``DIR/<arch>_<dist>_trial<t>.json``
(``init_recipes``: each parameter's threefry key and draw, a few
kilobytes where the ViT's weights take 214 MB), held bit for bit
against JAX's init; ``scripts/torch_cnn_check_probe.py --init_dir``
redraws them.  Cost on 8 CPU cores at batch 256: about 20 s a JAX hybrid
step and 86 s a JAX ViT step (5 steps an epoch), 25 s / 116 s of
compile; the port's hybrid step about 1.7 s.  Run one JAX job at a
time.
"""

import argparse
import json
import math
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                os.path.join(ROOT, "scripts")]
from cliffordtpu.data import load_dataset  # noqa: E402
from cliffordtpu.nn.conv_vae import cnn_vae_loss as jax_loss  # noqa: E402
from cliffordtpu.runners import cnn_runner as jrunner  # noqa: E402
from cliffordtpu.serving import _flatten_params  # noqa: E402
from cliffordtpu.train import loop as jloop  # noqa: E402
from cliffordtpu.train.schedules import cyclical_kl_beta  # noqa: E402
from cliffordtpu.train.state import \
    create_train_state as jax_train_state  # noqa: E402
from cliffordtpu.utils import stable_hash  # noqa: E402
from cliffordtpu_torch import random as trandom  # noqa: E402
from cliffordtpu_torch.nn import param_import  # noqa: E402
from cliffordtpu_torch.runners import cnn_runner  # noqa: E402
from cliffordtpu_torch.scripts import fashion_train  # noqa: E402
from cliffordtpu_torch.train.loop import make_cnn_train_step  # noqa: E402
from cliffordtpu_torch.train.state import (  # noqa: E402
    ClippedOptimizer,
    create_train_state,
)
import torch_cnn_check_probe as probe  # noqa: E402
import torch_jax_once  # noqa: E402

D = 128
MOVE = 1e-6
FLOOR_BAND = 1e-3
KAPPA_BATCH = 256
ESCAPED = 200.0  # the probe's escape: a best loss below the plateau's


def check_args(arch, dist, epochs, extra=()):
    """(JAX's args, the port's args) of the check's flags (and
    ``extra``, runner flags that shrink a rehearsal)."""
    argv = ["--dataset", "mnist32", "--arch", arch, "--latent_dims", str(D),
            "--distributions", dist, "--epochs", str(epochs),
            "--require_real", "--no_wandb", *extra]
    jargs = torch_jax_once.jax_script("fashion_train").build_parser() \
        .parse_args(argv)
    args = fashion_train.build_parser().parse_args(argv + ["--device", "cpu"])
    for a in (jargs, args):
        a.cur_lr = 1e-4 if dist == "powerspherical" else a.lr
    return jargs, args


def run_key(dist, trial, seed=0):
    return jax.random.fold_in(jax.random.PRNGKey(seed),
                              stable_hash(D, dist, trial) % (2 ** 31))


def jax_init(jargs, jmodel, x_train, key):
    """JAX's initial weights of the trial, in the port's names."""
    params = jax_train_state(key, jmodel, x_train[:2], optimizer="adamw",
                             lr=jargs.cur_lr, clip_norm=1.0).params
    return _port_params(params, jmodel.distribution)


def _port_params(params, distribution):
    return param_import.from_jax(
        _flatten_params(jax.device_get(params)), distribution)


def _data(args):
    os.environ.setdefault("CLIFFORDTPU_DATA_DIR",
                          os.path.join(ROOT, "tests", "data"))
    ds = load_dataset("mnist32", n_train=args.limit_train,
                      n_test=args.limit_test)
    if ds["source"] == "synthetic":
        raise SystemExit("no mnist32 shard under $CLIFFORDTPU_DATA_DIR")
    return (np.asarray(ds["x_train"], np.float32),
            np.asarray(ds["x_test"], np.float32))


def _kappa_stats(kappa, floor):
    if kappa is None:
        return {}
    k = np.asarray(kappa, np.float64)
    return {"kappa_mean": float(k.mean()),
            "kappa_at_floor": float((k - floor <= FLOOR_BAND).mean())}


class Recorder:
    """A logger for ``train_model``: every epoch's metrics, the kappa
    statistics of ``heads()`` and the parameters ``params()`` give."""

    use = True

    def __init__(self, heads, params, floor):
        self.heads, self.params, self.floor = heads, params, floor
        self.epochs, self.snaps = [], []

    def log_metrics(self, m):
        row = {k.replace("/", "_"): float(v) for k, v in m.items()}
        row["epoch"] = int(m["epoch"]) + 1
        row.update(_kappa_stats(self.heads(), self.floor))
        self.epochs.append(row)
        self.snaps.append(self.params())


def train_jax(jargs, jmodel, x_train, x_test, key, x_fixed, epochs):
    """JAX's ``train_model`` with a recorder; returns (recorder, best)."""
    holder = {}
    name = "make_cnn_train_step"
    real = getattr(jrunner, name)

    def recording(model):
        step = real(model)

        def wrapped(state, *a):
            state, losses = step(state, *a)
            # a host copy: the next call donates the state's buffers
            holder["params"] = jax.tree_util.tree_map(
                lambda t: np.array(t, copy=True), state.params)
            return state, losses
        return wrapped

    def heads():
        if jmodel.distribution != "clifford":
            return None
        _, kappa = jmodel.apply({"params": holder["params"]}, x_fixed,
                                method=jmodel.encode_heads)
        return kappa

    rec = Recorder(heads, lambda: _port_params(holder["params"],
                                               jmodel.distribution),
                   getattr(jmodel, "concentration_floor", 0.0))
    jargs.epochs = epochs
    setattr(jrunner, name, recording)
    try:
        _, best, _ = jrunner.train_model(jargs, jmodel, x_train, x_test, key,
                                         rec)
    finally:
        setattr(jrunner, name, real)
    return rec, float(best)


def _port_model(args, dist, init):
    model = cnn_runner.build_model(args, dist, D, 1)
    model.load_state_dict(init)
    return model


def train_port(args, dist, init, x_train, x_test, key, x_fixed, epochs):
    model = _port_model(args, dist, init)
    xf = torch.as_tensor(x_fixed)

    def heads():
        if model.distribution != "clifford":
            return None
        with torch.no_grad():
            return model.encode_heads(xf)[1].numpy()

    rec = Recorder(heads, lambda: {n: t.detach().clone()
                                   for n, t in model.state_dict().items()},
                   getattr(model, "concentration_floor", 0.0))
    args.epochs = epochs
    _, best, _ = cnn_runner.train_model(args, model, x_train, x_test,
                                        np.asarray(key), rec)
    return rec, float(best)


def param_gap(a, b):
    """(largest absolute difference, relative L2 distance) of two
    state dicts."""
    num = den = 0.0
    big = 0.0
    for n in b:
        d = (a[n].double() - b[n].double())
        big = max(big, d.abs().max().item())
        num += float((d ** 2).sum())
        den += float((b[n].double() ** 2).sum())
    return big, math.sqrt(num / max(den, 1e-300))


def moved(x_train):
    noise = np.random.default_rng(0).standard_normal(x_train.shape)
    return (x_train + MOVE * noise).astype(np.float32)


LOGGED = ("train_total_loss", "train_recon_loss", "train_kld_loss",
          "train_grad_norm", "test_total_loss", "test_recon_loss",
          "test_kld_loss", "best_test_total_loss", "kappa_mean",
          "kappa_at_floor", "beta")


def compare(runs):
    """Per epoch: each run's logged row, the parameter gaps (port-JAX,
    the port's own, JAX's own) and whether the port parted beyond twice
    the yardstick."""
    out, first = [], None
    for e, (prow, jrow) in enumerate(zip(runs["port"].epochs,
                                         runs["jax"].epochs)):
        row = {"epoch": e + 1}
        for name, rec in runs.items():
            if e < len(rec.epochs):
                row[name] = {k: rec.epochs[e][k] for k in LOGGED
                             if k in rec.epochs[e]}
        gaps = {"port_jax": param_gap(runs["port"].snaps[e],
                                      runs["jax"].snaps[e])}
        if e < len(runs["port_moved"].snaps):
            gaps["port_own"] = param_gap(runs["port_moved"].snaps[e],
                                         runs["port"].snaps[e])
        if "jax_moved" in runs and e < len(runs["jax_moved"].snaps):
            gaps["jax_own"] = param_gap(runs["jax_moved"].snaps[e],
                                        runs["jax"].snaps[e])
        row["param_max_abs"] = {k: v[0] for k, v in gaps.items()}
        row["param_rel_l2"] = {k: v[1] for k, v in gaps.items()}
        loss = {"port_jax": abs(prow["test_total_loss"]
                                - jrow["test_total_loss"])}
        for name, base, own in (("port_own", "port", "port_moved"),
                                ("jax_own", "jax", "jax_moved")):
            if own in runs and e < len(runs[own].epochs):
                loss[name] = abs(runs[own].epochs[e]["test_total_loss"]
                                 - runs[base].epochs[e]["test_total_loss"])
        row["test_total_abs"] = loss
        own = [row["param_max_abs"][k] for k in ("port_own", "jax_own")
               if k in row["param_max_abs"]]
        row["yardstick"] = max(own)
        row["parted"] = row["param_max_abs"]["port_jax"] > 2 * max(own)
        if row["parted"] and first is None:
            first = e + 1
        out.append(row)
    return out, first


def escape_epoch(rec):
    for row in rec.epochs:
        if row["best_test_total_loss"] < ESCAPED:
            return row["epoch"]
    return None


def _jax_grad_fn(jmodel, loss_type):
    """``jax.grad`` of the runner's loss with ``loss_type`` as its recon
    loss, in the parameters and in an addend of x_recon (the loss's
    gradient in x_recon): ``fn(params, delta, x, key, beta) -> ((grads,
    d_x_recon), loss pieces)``."""
    def loss(params, delta, x, k, beta):
        x_recon, q_z, p_z, _ = jmodel.apply({"params": params}, x,
                                            rngs={"sample": k})
        out = jax_loss(x, x_recon + delta, q_z, p_z, jmodel.distribution,
                       beta=beta, recon_loss_type=loss_type,
                       l1_weight=jmodel.l1_weight)
        return out["total_loss"], out
    return jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))


def locate(jargs, args, jmodel, dist, key, init, x_train, n_epochs):
    """Walk epochs 1..``n_epochs`` step by step in both packages (and the
    port on moved images); return every step's gaps and, at the first
    step that parts beyond twice the port's own parting, each
    parameter's pre-clip gradient gap against JAX's."""
    jstate = jax_train_state(key, jmodel, x_train[:2], optimizer="adamw",
                             lr=jargs.cur_lr, clip_norm=1.0)
    jstep = jloop.make_cnn_train_step(jmodel)
    ports = {}
    grads = {}
    for name, images in (("port", x_train), ("port_moved", moved(x_train))):
        model = _port_model(args, dist, init)
        st = create_train_state(model, "adamw", lr=args.cur_lr,
                                clip_norm=1.0, device="cpu")
        ports[name] = (st, make_cnn_train_step(st.model, st.optimizer),
                       torch.as_tensor(images))
    names = [n for n, _ in ports["port"][0].model.named_parameters()]
    scale = ClippedOptimizer._scale

    def recording_scale(self, g, factor):
        grads[id(self)] = {n: t.detach().clone() for n, t in zip(names, g)}
        scale(self, g, factor)

    ClippedOptimizer._scale = recording_scale
    n, bs = len(x_train), args.batch_size
    steps, out, found = max(1, n // bs), [], None
    try:
        for epoch in range(n_epochs):
            beta = cyclical_kl_beta(epoch, args.warmup_epochs,
                                    args.cycle_epochs, args.min_beta,
                                    args.max_beta)
            ekey = jax.random.fold_in(key, epoch + 1)
            perm = np.asarray(jax.random.permutation(ekey, n))
            tkey = trandom.fold_in_words(np.asarray(key), epoch + 1)
            for s in range(steps):
                idx = perm[s * bs:(s + 1) * bs]
                skey = jax.random.fold_in(ekey, s + 1)
                # a host copy: the step donates its state's buffers
                before = jax.tree_util.tree_map(
                    lambda t: np.array(t, copy=True), jstate.params)
                jstate, jl = jstep(jstate, jax.numpy.asarray(x_train[idx]),
                                   skey, jax.numpy.float32(beta))
                row = {"epoch": epoch + 1, "step": s + 1,
                       "jax_total": float(jl["total_loss"]),
                       "jax_grad_norm": float(jl["grad_norm"])}
                snaps = {}
                for name, (st, step, xs) in ports.items():
                    pl = step(xs[torch.as_tensor(idx)], trandom.sample_key(
                        trandom.fold_in_words(tkey, s + 1)), beta)
                    row[f"{name}_total"] = float(pl["total_loss"])
                    row[f"{name}_grad_norm"] = float(pl["grad_norm"])
                    snaps[name] = {k: t.detach().clone()
                                   for k, t in st.model.state_dict().items()}
                want = _port_params(jstate.params, jmodel.distribution)
                gap = param_gap(snaps["port"], want)[0]
                own = param_gap(snaps["port_moved"], snaps["port"])[0]
                row.update(param_max_abs={"port_jax": gap, "port_own": own},
                           parted=gap > 2 * own)
                out.append(row)
                if row["parted"]:
                    x = x_train[idx]
                    (jgrads, _), _ = _jax_grad_fn(
                        jmodel, jmodel.recon_loss_type)(
                            before, np.zeros_like(x), x, skey,
                            np.float32(beta))
                    jgrads = _port_params(jgrads, jmodel.distribution)
                    got = grads[id(ports["port"][0].optimizer)]
                    found = {"epoch": epoch + 1, "step": s + 1,
                             "grad_max_abs": {
                                 k: (got[k] - jgrads[k]).abs().max().item()
                                 for k in got},
                             "grad_max_abs_ref": {
                                 k: jgrads[k].abs().max().item()
                                 for k in got}}
                    return out, found
    finally:
        ClippedOptimizer._scale = scale
    return out, found


def init_recipes(jmodel, x, keys):
    """JAX's initial weights of ``create_train_state(key, jmodel, x)``, for
    each of ``keys``, as a recipe the port redraws without JAX: for each
    parameter (flax's flat name) the threefry key words, the draw
    (``uniform`` with its bounds or ``normal``) and shape of the
    initializer's call of ``jax.random``, and the float32 factor that the
    initializer multiplies the draw by; or the constant it fills; or,
    where the port's redraw is not bit-equal, the values themselves (small
    parameters only).  The keys and draws come out of one jitted init that
    returns them; each recipe is then held bit for bit against
    ``create_train_state``'s init (the port's redraw in full for the first
key, whose draws match every key's)."""
    import base64
    import inspect

    from jax._src import random as jsrc

    meta, depth, real = [], [0], {}

    def recording(name):
        fn = real[name]
        sig = inspect.signature(fn)

        def wrapped(*a, **kw):
            depth[0] += 1
            try:
                out = fn(*a, **kw)
            finally:
                depth[0] -= 1
            if depth[0] == 0:  # not a draw inside another draw
                b = sig.bind(*a, **kw)
                b.apply_defaults()
                k = b.arguments["key"]
                if jax.dtypes.issubdtype(k.dtype, jax.dtypes.prng_key):
                    k = jax.random.key_data(k)
                meta.append({
                    "kind": name, "key": k, "raw": out,
                    "shape": [int(n) for n in b.arguments["shape"]],
                    **({"minval": float(b.arguments["minval"]),
                        "maxval": float(b.arguments["maxval"])}
                       if name == "uniform" else {})})
            return out
        return wrapped

    def run(key):
        meta.clear()
        init_key, sample_key = jax.random.split(key)
        params = jmodel.init({"params": init_key, "sample": sample_key},
                             x[:2])["params"]
        return params, [(m["key"], m["raw"]) for m in meta]

    for name in ("uniform", "normal"):
        real[name] = getattr(jsrc, name)
    jitted, recipes, redrawn = jax.jit(run), [], None
    for key in keys:
        try:
            for name in real:
                setattr(jsrc, name, recording(name))
                setattr(jax.random, name, recording(name))
            params, drawn = jax.device_get(jitted(key))
        finally:
            for name, fn in real.items():
                setattr(jsrc, name, fn)
                setattr(jax.random, name, fn)
        draws = [{k: v for k, v in m.items() if k not in ("key", "raw")}
                 | {"key": [int(w) for w in np.asarray(k)],
                    "raw": np.asarray(r, np.float32)}
                 for m, (k, r) in zip(meta, drawn)]
        params = _flatten_params(params)
        want = _flatten_params(jax.device_get(jax_train_state(
            key, jmodel, x[:2], optimizer="adamw", lr=1e-3,
            clip_norm=1.0).params))
        assert set(params) == set(want) and all(
            np.array_equal(params[n], w) for n, w in want.items())
        recipe = {name: _param_recipe(np.asarray(p, np.float32), draws)
                  for name, p in params.items()}
        if redrawn is None:
            # the port redraws the first key's weights in full; where its
            # draw is not JAX's bit for bit (for every key: the same
            # draws), the recipes carry the values
            flat = probe.flat_from_recipe({"params": recipe}, check=False)
            redrawn = [n for n, w in want.items()
                       if not np.array_equal(flat[n], w)]
        for name in redrawn:
            w = want[name]
            if w.size > 65536:
                raise AssertionError(f"{name}: the redraw parts from JAX's "
                                     f"init")
            recipe[name] = {"kind": "values", "shape": list(w.shape),
                            "b64": base64.b64encode(np.ascontiguousarray(
                                w, np.float32).tobytes()).decode()}
        for name, w in want.items():  # values the probe checks its redraw by
            w = np.asarray(w, np.float32).reshape(-1)
            recipe[name]["check"] = [[i, float(w[i])] for i in sorted(
                {0, w.size // 2, w.size - 1})]
        recipes.append({"params": recipe, "n_values": len(redrawn)})
    return recipes


def _param_recipe(p, draws):
    """The draw and float32 factor that give ``p`` exactly, or its
    constant."""
    for d in draws:
        if d["shape"] != list(p.shape) or not p.size:
            continue
        raw = d["raw"]
        i = int(np.abs(raw).argmax())
        if raw.flat[i] == 0:
            continue
        s0 = np.float32(p.flat[i] / raw.flat[i])
        for s in (s0, *(np.nextafter(s0, np.float32(t)) for t in
                        (np.inf, -np.inf))):
            if np.array_equal(raw * np.float32(s), p):
                return {k: v for k, v in d.items() if k != "raw"} | {
                    "scale": float(s)}
    if p.size and np.all(p == p.flat[0]):
        return {"kind": "const", "shape": list(p.shape),
                "value": float(p.flat[0])}
    raise AssertionError(f"no draw gives a parameter of shape {p.shape}")


def at_jax_weights(jargs, args, jmodel, dist, key, x_train, n_steps):
    """The first ``n_steps`` of epoch 1 along JAX's per-step trajectory:
    at JAX's weights before each step, on its batch and key, both
    packages' loss pieces and pre-clip gradients (relative L2 over every
    parameter) with the runner's recon loss and with "mse" in its place,
    and, for an l1 loss, the pixels where the sign of the loss's gradient
    in x_recon differs between the packages (a residual within float32
    rounding of zero)."""
    from cliffordtpu_torch.nn.conv_vae import cnn_vae_loss

    state = jax_train_state(key, jmodel, x_train[:2], optimizer="adamw",
                            lr=jargs.cur_lr, clip_norm=1.0)
    jstep = jloop.make_cnn_train_step(jmodel)
    model = _port_model(args, dist, _port_params(state.params,
                                                 jmodel.distribution))

    fns = {t: _jax_grad_fn(jmodel, t)
           for t in (jmodel.recon_loss_type, "mse")}
    n, bs = len(x_train), args.batch_size
    beta = cyclical_kl_beta(0, args.warmup_epochs, args.cycle_epochs,
                            args.min_beta, args.max_beta)
    ekey = jax.random.fold_in(key, 1)
    perm = np.asarray(jax.random.permutation(ekey, n))
    tkey = trandom.fold_in_words(np.asarray(key), 1)
    out = []
    for s in range(n_steps):
        idx = perm[s * bs:(s + 1) * bs]
        skey = jax.random.fold_in(ekey, s + 1)
        x = x_train[idx]
        params = jax.tree_util.tree_map(lambda t: np.array(t, copy=True),
                                        state.params)
        model.load_state_dict(_port_params(params, jmodel.distribution))
        row = {"step": s + 1}
        for loss_type, fn in fns.items():
            (jg, jdelta), aux = fn(params, np.zeros_like(x), x, skey,
                                   np.float32(beta))
            jg = _port_params(jg, jmodel.distribution)
            model.zero_grad()
            x_recon, q_z, p_z, _ = model(torch.as_tensor(x),
                                         trandom.sample_key(
                                             trandom.fold_in_words(
                                                 tkey, s + 1)))
            x_recon.retain_grad()
            got = cnn_vae_loss(torch.as_tensor(x), x_recon, q_z, p_z,
                               model.distribution, beta=beta,
                               recon_loss_type=loss_type,
                               l1_weight=model.l1_weight)
            got["total_loss"].backward()
            num = sum(float(((p.grad.double() - jg[k].double()) ** 2).sum())
                      for k, p in model.named_parameters())
            den = sum(float((g.double() ** 2).sum()) for g in jg.values())
            row[loss_type] = {
                "grad_rel_l2": math.sqrt(num / den),
                **{k: [float(got[k].detach()), float(aux[k])]
                   for k in ("total_loss", "recon_loss", "kld_loss")}}
            if loss_type == "l1":
                row[loss_type]["sign_flips"] = int((np.sign(
                    x_recon.grad.numpy()) != np.sign(np.asarray(
                        jdelta))).sum())
        print(json.dumps(row), flush=True)
        out.append(row)
        state, _ = jstep(state, jax.numpy.asarray(x), skey,
                         jax.numpy.float32(beta))
    return out


def write_inits(arch, dist, trials, outdir):
    jargs, _ = check_args(arch, dist, 1)
    x_train, _ = _data(jargs)
    jmodel = jrunner.build_model(jargs, dist, D, 1)
    os.makedirs(outdir, exist_ok=True)
    numbers = range(trials[0], trials[1] + 1)
    for t, recipe in zip(numbers, init_recipes(
            jmodel, x_train, [run_key(dist, t) for t in numbers])):
        recipe.update(arch=arch, dist=dist, trial=t,
                      distribution=jmodel.distribution)
        path = os.path.join(outdir, f"{arch}_{dist}_trial{t}.json")
        with open(path, "w") as f:
            json.dump(recipe, f)
        print(path, recipe["n_values"], flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True, choices=["cnn", "hybrid", "vit"])
    p.add_argument("--dist", required=True)
    p.add_argument("--trial", type=int, default=1)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--jax_own_epochs", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--inits", default=None,
                   help="write JAX's initial weights of --trials here")
    p.add_argument("--trials", type=int, nargs=2, default=(1, 8))
    p.add_argument("--at_jax_weights", type=int, default=0, metavar="N",
                   help="only compare both packages' gradients at JAX's "
                        "weights over epoch 1's first N steps")
    p.add_argument("--runner_flags", default="",
                   help="extra runner flags for a rehearsal, e.g. "
                        "'--batch_size 16 --limit_train 32'")
    a = p.parse_args(argv)
    if a.inits:
        write_inits(a.arch, a.dist, a.trials, a.inits)
        return 0
    t0 = time.time()
    jargs, args = check_args(a.arch, a.dist, a.epochs,
                             a.runner_flags.split())
    x_train, x_test = _data(jargs)
    x_fixed = x_test[:KAPPA_BATCH]
    key = run_key(a.dist, a.trial)
    jmodel = jrunner.build_model(jargs, a.dist, D, 1)
    init = jax_init(jargs, jmodel, x_train, key)
    if a.at_jax_weights:
        result = {"cell": {"arch": a.arch, "dist": a.dist, "trial": a.trial,
                           "runner_flags": a.runner_flags},
                  "steps": at_jax_weights(jargs, args, jmodel, a.dist, key,
                                          x_train, a.at_jax_weights),
                  "seconds": time.time() - t0}
        if a.out:
            with open(a.out, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    secs, runs = {}, {}

    def timed(name, fn):
        s = time.time()
        runs[name] = fn()[0]
        secs[name] = time.time() - s
        print(f"{name}: {secs[name]:.0f} s", flush=True)

    timed("jax", lambda: train_jax(jargs, jmodel, x_train, x_test, key,
                                   x_fixed, a.epochs))
    if a.jax_own_epochs:
        timed("jax_moved", lambda: train_jax(
            jargs, jmodel, moved(x_train), x_test, key, x_fixed,
            a.jax_own_epochs))
    timed("port", lambda: train_port(args, a.dist, init, x_train, x_test,
                                     key, x_fixed, a.epochs))
    timed("port_moved", lambda: train_port(args, a.dist, init,
                                           moved(x_train), x_test, key,
                                           x_fixed, a.epochs))
    rows, first = compare(runs)
    steps, found = ([], None) if first is None else locate(
        jargs, args, jmodel, a.dist, key, init, x_train, first)
    result = {
        "cell": {"arch": a.arch, "dist": a.dist, "trial": a.trial,
                 "runner_flags": a.runner_flags,
                 "epochs": a.epochs, "d": D, "batch_size": args.batch_size,
                 "lr": args.cur_lr, "n_train": len(x_train),
                 "n_test": len(x_test)},
        "run_key": [int(w) for w in np.asarray(key)],
        "yardstick": (f"largest parameter difference of a package from "
                      f"itself when its training images move by {MOVE} "
                      f"(normal, seed 0): the port's over every epoch, "
                      f"JAX's over the first {a.jax_own_epochs}; parted = "
                      f"port-JAX beyond twice the larger"),
        "kappa": (f"batch mean of kappa and the share within {FLOOR_BAND} "
                  f"of concentration_floor on the first {KAPPA_BATCH} "
                  f"test images"),
        "escape_epoch": {n: escape_epoch(r) for n, r in runs.items()},
        "first_parting_epoch": first,
        "first_parting_step": found,
        "steps": steps,
        "epochs": rows,
        "seconds": {**secs, "total": time.time() - t0},
    }
    text = json.dumps(result, indent=1)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    for row in rows:
        print(json.dumps({"epoch": row["epoch"], **{
            n: round(row[n]["test_total_loss"], 3) for n in runs
            if n in row}, "kappa_at_floor": {
                n: row[n].get("kappa_at_floor") for n in runs if n in row},
            "param_max_abs": row["param_max_abs"],
            "parted": row["parted"]}), flush=True)
    print(json.dumps({"first_parting_epoch": first,
                      "first_parting_step": None if found is None else
                      {k: found[k] for k in ("epoch", "step")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
