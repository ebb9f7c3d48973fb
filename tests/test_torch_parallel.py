"""parallel/ of the port (cliffordtpu_torch/parallel/): the placement
rules leaf for leaf against the JAX package's ``infer_param_sharding``,
and the sharded train steps of one 4-rank CPU gloo group
(tests/torch_parallel_ranks.py, started once for the module with
torchrun's environment) against the port's single-device step, at JAX's
own bars (tests/test_parallel.py): DP loss rtol 2e-4; FSDP loss rtol 5e-5
/ atol 2e-4 and grad_norm rtol 5e-4 / atol 2e-4, every one of 5 steps.
The split layout under TP is held at those bars against the single-device
step that computes its projections as TP splits them
(``torch_parallel_ranks.split_gemms``): against the plain step it parts
at step 5 by float32 reassociation alone, which the single device shows
without TP (tests/torch_tp_witness.py).
The JAX mesh step is not run here: tests/test_parallel.py holds it."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn.vit_vae import CliffordARVAE as JaxViT
from cliffordtpu.parallel.mesh import create_mesh as jax_mesh
from cliffordtpu.parallel.sharding import (
    infer_param_sharding as jax_infer,
)
from cliffordtpu_torch import parallel
from cliffordtpu_torch.parallel import sharding
from cliffordtpu_torch.nn.param_import import layout
from cliffordtpu_torch.runners import cnn_runner
from cliffordtpu_torch.train.loop import make_cnn_train_step
from cliffordtpu_torch.train.state import create_train_state

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(1)

LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
LAYOUT_IDS = ["split", "fused", "split_scan", "fused_scan"]


def _jax_specs(fused, scan, mesh_shape, mode):
    """JAX's placements of tests/test_parallel.py's tiny model in a
    layout, flat key -> spec tuple."""
    model = JaxViT(latent_dim=8, image_size=32, in_channels=1,
                   distribution="clifford", cnn_chs=[16, 32, 64],
                   z_channels=64, encoder_vit_layers=1,
                   decoder_vit_layers=1, patch_size=4, fused_proj=fused,
                   scan_layers=scan)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(model.init, {"params": key, "sample": key},
                            jnp.zeros((2, 32, 32, 1)))["params"]
    shard = jax_infer(jax_mesh(mesh_shape), shapes, mode,
                      fsdp_min_size=2 ** 10)
    leaves = jax.tree_util.tree_flatten_with_path(
        shard, is_leaf=lambda s: hasattr(s, "spec"))[0]
    return {"/".join(k.key for k in path): tuple(v.spec)
            for path, v in leaves}


@pytest.mark.parametrize("mesh_shape,mode", [((4, 2), "replicated"),
                                             ((8, 1), "fsdp")],
                         ids=["4x2_replicated", "8x1_fsdp"])
@pytest.mark.parametrize("fused,scan", LAYOUTS, ids=LAYOUT_IDS)
def test_placements_equal_jax_leaf_for_leaf(fused, scan, mesh_shape, mode):
    """Every parameter of the port's tiny model is placed as JAX places
    its leaf, through the layout's transpose (flax's (in, out) kernel is
    the port's (out, in) weight)."""
    want = _jax_specs(fused, scan, mesh_shape, mode)
    model = ranks.tiny(64, fused, scan)
    sizes = dict(zip(("data", "model"), mesh_shape))
    got = parallel.infer_param_sharding(sizes, model, mode,
                                        fsdp_min_size=2 ** 10)
    params = dict(model.named_parameters())
    assert len(got) == len(want) == len(params)
    placed = 0
    for port, jax_key, _, order in layout(model):
        ndim = params[port].dim()
        spec = tuple(want[jax_key]) + (None,) * (ndim - len(want[jax_key]))
        if order is not None:
            spec = tuple(spec[a] for a in order)
        mine = tuple(got[port]) + (None,) * (ndim - len(got[port]))
        assert mine == spec, (port, mine, spec)
        placed += any(spec)
    # the rules reach some leaves, except a stack's under "replicated"
    assert placed or (scan and mode == "replicated")


def test_rules_by_name():
    assert parallel.rule_for_name("decoder_vit.layers.0.attn.wqkv.weight") \
        == ("model", None)
    assert parallel.rule_for_name("encoder_vit.scan.block.ffn.w2.weight") \
        == (None, "model")
    assert parallel.rule_for_name("encoder_vit.layers.0.norm1.weight") == ()
    assert parallel.rule_for_name("quant_proj.weight") == ()
    # JAX's fsdp rule: TP first, then the largest divisible axis, ties
    # broken in JAX's axis order; small leaves whole
    assert parallel.fsdp_rule("x.ffn.w1.weight", (64, 256),
                              {"data": 4, "model": 2}) == ("data", "model")
    assert parallel.fsdp_rule("x.attn.wo.weight", (128, 128),
                              {"data": 4, "model": 2}) == ("model", "data")
    assert parallel.fsdp_rule("x.norm1.weight", (128,),
                              {"data": 4, "model": 2}) == ()
    # JAX's fsdp rule puts "model" on a stacked kernel's axis, which has
    # no tensor-parallel form here: those stay whole over "model"
    model = ranks.tiny(128, True, True)
    placed = parallel.infer_param_sharding({"data": 2, "model": 2}, model,
                                           "fsdp", fsdp_min_size=2 ** 10)
    whole = sharding.tp_kept_whole(placed)
    assert whole and all(".scan." in n for n in whole)
    assert not sharding.tp_kept_whole(parallel.infer_param_sharding(
        {"data": 2, "model": 2}, ranks.tiny(128, True), "fsdp",
        fsdp_min_size=2 ** 10))


def test_mesh_spec_and_rows():
    assert parallel.parse_mesh_spec("dp", 4) == (4, 1)
    assert parallel.parse_mesh_spec("2x2", 4) == (2, 2)
    assert parallel.parse_mesh_spec("3", 4) == (3, 1)
    with pytest.raises(ValueError, match="nproc_per_node 8"):
        parallel.create_mesh((4, 2), "cpu")  # a world of 1 here

    class Axis:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    class Mesh:
        device_type = "cpu"

        def __getitem__(self, name):
            return Axis({"data": 4, "model": 2}[name])

        def get_local_rank(self, name):
            return 2

    assert parallel.global_batch_rows(Mesh(), 16) == (8, 12)
    with pytest.raises(ValueError, match="divisible"):
        parallel.global_batch_rows(Mesh(), 10)
    x = parallel.make_global_batch(Mesh(), np.ones((4, 2), np.float64))
    assert x.dtype == torch.float32 and x.device.type == "cpu"


def test_a_one_rank_mesh_takes_the_one_device_norm():
    """A gradient on a mesh of one rank is all of it: ``global_norm``
    takes the one-device norm of its shard, bit for bit, in any order of
    the tensors, so a world of one clips exactly as one device does (the
    world-1 FSDP2 step of chip_smoke is held to the single device at
    1e-6)."""
    from cliffordtpu_torch.train import state

    class Mesh:
        def __init__(self, n):
            self.n = n

        def size(self):
            return self.n

    class Sharded:  # the two attributes global_norm reads of a DTensor
        def __init__(self, t):
            self.t, self.device_mesh = t, Mesh(1)

        def to_local(self):
            return self.t

    gen = torch.Generator().manual_seed(5)
    grads = [torch.randn(s, generator=gen) * 3 for s in ((64, 33), (7,),
                                                          (5, 4, 3))]
    want = state.global_norm(grads)
    assert want.dtype == torch.float32
    assert torch.equal(state.global_norm([Sharded(g) for g in grads]), want)
    # a sharded optimizer holds its parameters in another order
    assert torch.equal(state.global_norm([Sharded(g) for g in grads[::-1]]),
                       want)
    assert state._whole(grads[0]) and state._whole(Sharded(grads[0]))
    two = Sharded(grads[0])
    two.device_mesh = Mesh(2)
    assert not state._whole(two)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4-rank group's report, and the single-device references
    computed here while the ranks run."""
    out = tmp_path_factory.mktemp("ranks") / "report.json"
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="4", LOCAL_WORLD_SIZE="4",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, ranks.__file__, str(out)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    single = {}
    x = ranks.images()
    for name, _, _, zc, fused in ranks.CASES:
        if (zc, fused) not in single:
            st = create_train_state(ranks.tiny(zc, fused), "adamw", ranks.LR,
                                    device="cpu")
            single[(zc, fused)] = ranks.run_steps(
                make_cnn_train_step(st.model, st.optimizer), x)
    st = create_train_state(ranks.split_gemms(ranks.tiny(128)), "adamw",
                            ranks.LR, device="cpu")
    single["split_gemms"] = ranks.run_steps(
        make_cnn_train_step(st.model, st.optimizer), x)
    x_train, x_test = ranks.runner_data()
    best = cnn_runner.train_model(ranks.runner_args(), ranks.tiny(128),
                                  x_train, x_test, (0, 0))[1]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(out) as f:
        report = json.load(f)
    return report, single, best


def _steps_match(got, want, loss_rtol, loss_atol=0.0, norm_rtol=None,
                 norm_atol=0.0):
    assert len(got) == len(want) == ranks.STEPS
    for (l, g), (lw, gw) in zip(got, want):
        np.testing.assert_allclose(l, lw, rtol=loss_rtol, atol=loss_atol)
        if norm_rtol is not None:
            np.testing.assert_allclose(g, gw, rtol=norm_rtol, atol=norm_atol)


def _case(name):
    return next(c for c in ranks.CASES if c[0] == name)


@pytest.mark.parametrize("name", ["dp", "dp_tp"])
def test_dp_steps_match_single_device(group, name):
    """(4, 1) DP and (2, 2) DP x TP: each rank draws its rows of the
    global draw; the global losses are the single-device step's."""
    report, single, _ = group
    _, _, _, zc, fused = _case(name)
    _steps_match(report["steps"][name], single[(zc, fused)], 2e-4)


@pytest.mark.parametrize("name", ["fsdp", "fsdp_tp"])
def test_fsdp_steps_match_single_device(group, name):
    """(4, 1) FSDP and (2, 2) FSDP x TP (the fused layout), 5 steps at
    JAX's FSDP bars, the gradient norm over the sharded gradients."""
    report, single, _ = group
    _, _, _, zc, fused = _case(name)
    _steps_match(report["steps"][name], single[(zc, fused)], 5e-5, 2e-4,
                 5e-4, 2e-4)


@pytest.mark.parametrize("name", ["dp_tp", "fsdp_tp_split"])
def test_tp_split_layout_matches_the_split_gemm_step(group, name):
    """The split layout (the model's default) under (2, 2) DP x TP and
    FSDP x TP, every one of 5 steps at JAX's FSDP bars on the loss and
    ``grad_norm``, against the single-device step that computes the
    projections as the "model" axis splits them: the placements, the
    collectives, the rows of the draw and the sharded norm, with TP's
    float32 reassociation on both sides.  Against the plain step the
    split layout parts at step 5 (``grad_norm`` 3.2e-3 relative, steps
    1-4 within 3e-5), as much as this reference does on one device: the
    clip at 1.0 brings small gradient entries down to Adam's eps, where
    reassociation steers their update (PERF.md, tests/torch_tp_witness.py)."""
    report, single, _ = group
    _steps_match(report["steps"][name], single["split_gemms"], 5e-5, 2e-4,
                 5e-4, 2e-4)


def test_fsdp_shards_each_leaf_and_the_bytes_shrink(group):
    """Every leaf the rule splits over "data" holds exactly 1/4 of it on
    a rank; the leaves below the cutoff stay whole, so a rank's parameter
    bytes fall below 0.35 of the whole and its Adam moments' too."""
    report, _, _ = group
    shards = report["fsdp_shards"]
    assert shards
    for name, (local, whole) in shards.items():
        assert local * 4 == whole, (name, local, whole)
    for key in ("fsdp_param_bytes", "fsdp_moment_bytes"):
        local, whole = report[key]
        assert local < 0.35 * whole, (key, local, whole)


def test_runner_trains_under_mesh_and_matches_single_device(group):
    """``train_model`` with ``--mesh dp`` and ``--mesh 2x2`` in the group
    gives the single-device best loss within 2e-4 (JAX's bar); a batch
    the data axis does not divide, and ``--scan_epochs`` with a mesh,
    raise JAX's errors."""
    report, _, best = group
    for spec in ("dp", "2x2"):
        np.testing.assert_allclose(report["runner"][spec], best, rtol=2e-4)
    assert "divisible" in report["divisible"]
    args = ranks.runner_args("dp")
    args.scan_epochs = True
    with pytest.raises(ValueError, match="scan_epochs"):
        cnn_runner.train_model(args, ranks.tiny(), *ranks.runner_data(),
                               (0, 0))
