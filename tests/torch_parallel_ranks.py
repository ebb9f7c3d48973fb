"""One rank of the 4-rank CPU group of tests/test_torch_parallel.py.

Started four times with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and OMP_NUM_THREADS=1; joins the
gloo group through ``parallel.init_distributed`` and runs, in order, the
(4, 1) DP, (4, 1) FSDP, (2, 2) DP x TP and (2, 2) FSDP x TP train steps,
the same (2, 2) FSDP x TP step on the split layout, then ``train_model`` under ``--mesh dp`` and ``--mesh 2x2``, and the
runner's refusal of a batch the data axis does not divide.  Rank 0 writes
what the tests read to the JSON file named by its one argument.

    python tests/torch_parallel_ranks.py OUT.json
"""

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cliffordtpu_torch import parallel, random  # noqa: E402
from cliffordtpu_torch.nn.vit_vae import CliffordARVAE  # noqa: E402
from cliffordtpu_torch.runners import cnn_runner  # noqa: E402
from cliffordtpu_torch.train.state import create_train_state  # noqa: E402

STEPS, BATCH, LR, FSDP_MIN = 5, 8, 1e-4, 2 ** 10
# (name, mesh shape, mode, z_channels, fused_proj): TP needs 2 heads
CASES = (("dp", (4, 1), "replicated", 64, False),
         ("fsdp", (4, 1), "fsdp", 64, False),
         ("dp_tp", (2, 2), "replicated", 128, False),
         ("fsdp_tp", (2, 2), "fsdp", 128, True),
         ("fsdp_tp_split", (2, 2), "fsdp", 128, False))


def tiny(zc=64, fused_proj=False, scan_layers=False):
    """tests/test_parallel.py's tiny CliffordARVAE (z 64, one head), or
    its 2-head twin at z 128."""
    return CliffordARVAE(latent_dim=8, image_size=32, in_channels=1,
                         cnn_chs=[16, 32, zc], z_channels=zc,
                         encoder_vit_layers=1, decoder_vit_layers=1,
                         patch_size=4, fused_proj=fused_proj,
                         scan_layers=scan_layers)


def split_gemms(model, tp=2):
    """``model`` (in place) with each tensor-parallel projection computed
    on one device as a (., tp) mesh computes it: q/k/v and w1/w3
    (``ColwiseParallel``) as ``tp`` GEMMs over blocks of their outputs,
    wo and w2 (``RowwiseParallel``) as the sum of ``tp`` partial GEMMs
    over blocks of their inputs, so their backward sums partial input
    gradients as the ranks' all-reduce does.  The plain model's math with
    TP's float32 reassociation, and no collective."""
    import torch.nn.functional as F

    def colwise(m):
        def forward(x):
            w = m.weight.chunk(tp, 0)
            b = m.bias.chunk(tp, 0) if m.bias is not None else [None] * tp
            return torch.cat([F.linear(x, wi, bi) for wi, bi in zip(w, b)],
                             -1)
        return forward

    def rowwise(m):
        def forward(x):
            parts = [F.linear(xi, wi) for xi, wi in
                     zip(x.chunk(tp, -1), m.weight.chunk(tp, 1))]
            y = parts[0]
            for part in parts[1:]:
                y = y + part
            return y if m.bias is None else y + m.bias
        return forward

    for name, m in model.named_modules():
        rule = parallel.rule_for_name(name + ".weight")
        if rule:
            m.forward = colwise(m) if rule[0] == "model" else rowwise(m)
    return model


def images():
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (BATCH, 32, 32, 1)).astype(np.float32))


def run_steps(step, x):
    """``STEPS`` steps of ``step`` on ``x``, key fold_in((0, 0), i):
    [(total_loss, grad_norm)]."""
    out = []
    for i in range(STEPS):
        losses = step(x, random.fold_in_words((0, 0), i),
                      torch.tensor(1.0))
        out.append((float(losses["total_loss"]), float(losses["grad_norm"])))
    return out


def runner_args(mesh=None, batch_size=BATCH):
    return SimpleNamespace(
        cur_lr=1e-3, use_learnable_beta=False, epochs=2,
        batch_size=batch_size, warmup_epochs=1, cycle_epochs=4,
        min_beta=0.1, max_beta=1.0, patience=0, mesh=mesh,
        mesh_mode="replicated", scan_epochs=False, device="cpu",
        grad_accum=1)


def runner_data():
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, (24, 32, 32, 1)).astype(np.float32),
            rng.uniform(-1, 1, (8, 32, 32, 1)).astype(np.float32))


def _bytes(tensors):
    """(local, global) bytes of parameters or moments."""
    loc = glob = 0
    for t in tensors:
        glob += t.numel() * t.element_size()
        local = t.to_local() if hasattr(t, "to_local") else t
        loc += local.numel() * local.element_size()
    return loc, glob


def main(out_path):
    torch.set_num_threads(1)
    parallel.init_distributed("cpu")
    rank = torch.distributed.get_rank()
    x = images()
    report = {"steps": {}}
    for name, shape, mode, zc, fused in CASES:
        mesh = parallel.create_mesh(shape, "cpu")
        st = create_train_state(tiny(zc, fused), "adamw", LR, device="cpu")
        st = parallel.shard_state(st, mesh, mode, fsdp_min_size=FSDP_MIN)
        r0, r1 = parallel.global_batch_rows(mesh, BATCH)
        step = parallel.make_sharded_cnn_train_step(st.sharded,
                                                    st.optimizer, mesh)
        if name == "fsdp":
            params = dict(st.model.named_parameters())
            sharded = {n: [params[n].to_local().numel(), params[n].numel()]
                       for n, dims in st.sharded.placements.items()
                       if "data" in dims}
        report["steps"][name] = run_steps(step, x[r0:r1])
        if name == "fsdp":
            moments = [v for s in st.optimizer.inner.state.values()
                       for k, v in s.items() if k != "step"]
            report["fsdp_shards"] = sharded
            report["fsdp_param_bytes"] = _bytes(st.model.parameters())
            report["fsdp_moment_bytes"] = _bytes(moments)
    x_train, x_test = runner_data()
    report["runner"] = {}
    for spec in ("dp", "2x2"):
        model = tiny(128)
        report["runner"][spec] = cnn_runner.train_model(
            runner_args(spec), model, x_train, x_test, (0, 0))[1]
    try:
        cnn_runner.train_model(runner_args("dp", batch_size=6), tiny(),
                               x_train, x_test, (0, 0))
        report["divisible"] = ""
    except ValueError as e:
        report["divisible"] = str(e)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(report, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
