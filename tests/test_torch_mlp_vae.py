"""The port's ``MLPVAE`` (cliffordtpu_torch/nn/mlp_vae.py) and
``mlpvae_from_jax`` against the flax module cliffordtpu/nn/mlp_vae.py, on
parameters of the JAX model's shapes drawn from a numpy seed and carried
across, with the sampling key the JAX model derives (``make_rng``).

Every family: normal (also with ``l2_normalize``), powerspherical, vmf
and clifford, at z_dim 5 (powerspherical 6, as the MNIST runner sets it),
h_dim 32, batch 8.  Bars: heads and latents within 1e-5 of max(1, |x|);
decoder logits within 1e-4 of max(1, |x|) (784-wide float32 products in
another summation order); the lanes of ``LaneMLPVAE`` equal to their
own ``MLPVAE`` within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliffordtpu.nn.mlp_vae import MLPVAE as JaxMLPVAE
from cliffordtpu.serving import _flatten_params
from cliffordtpu_torch import random
from cliffordtpu_torch.nn import mlp_vae, param_import

torch.set_num_threads(1)

B = 8
CONFIGS = [("normal", False, 5), ("normal", True, 5),
           ("powerspherical", False, 6), ("vmf", False, 5),
           ("clifford", False, 5)]


def random_params(model, seed):
    """Flat params of the JAX ``model``'s shapes from a numpy seed (no
    initialiser is run)."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((2, 784)))["params"]
    rng = np.random.default_rng(seed)
    flat = _flatten_params(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), shapes))
    return {k: (rng.normal(size=v.shape) * (
        1 / np.sqrt(v.shape[0]) if k.endswith("kernel") else 0.1))
        .astype(np.float32) for k, v in flat.items()}


def close(got, want, bar):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return got.shape == want.shape and np.abs(got - want).max() <= bar * max(
        1.0, np.abs(want).max())


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda c: f"{c[0]}{'-l2' if c[1] else ''}")
def pair(request):
    dist, l2, z_dim = request.param
    jmodel = JaxMLPVAE(h_dim=32, z_dim=z_dim, distribution=dist,
                       l2_normalize=l2)
    flat = random_params(jmodel, len(dist) + 10 * l2)
    params = jax.tree_util.tree_map(jnp.asarray, {
        name: {"kernel": flat[f"{name}/kernel"], "bias": flat[f"{name}/bias"]}
        for name in {k.split("/")[0] for k in flat}})
    x = np.random.default_rng(1).uniform(0, 1, (B, 28, 28)) \
        .astype(np.float32)
    rng = jax.random.PRNGKey(3)

    @jax.jit
    def forward(p, x):
        (m, p2), _, z, logits = jmodel.apply({"params": p}, x,
                                             rngs={"sample": rng})
        flat_z = jmodel.apply({"params": p}, x, rngs={"sample": rng},
                              method=jmodel.get_flat_latent)
        return m, p2, z, logits, flat_z

    port = mlp_vae.MLPVAE(32, z_dim, dist, l2)
    port.load_state_dict(param_import.from_jax(flat))
    return dict(dist=dist, flat=flat, x=x, rng=np.asarray(rng), port=port,
                want=jax.device_get(forward(params, x)))


def test_forward_matches_the_flax_module(pair):
    port, x = pair["port"], torch.from_numpy(pair["x"])
    with torch.no_grad():
        (m, p2), (q_z, p_z), z, logits = port(x, random.sample_key(
            pair["rng"]))
    want_m, want_p2, want_z, want_logits, _ = pair["want"]
    assert close(m, want_m, 1e-5) and close(p2, want_p2, 1e-5)
    assert close(z, want_z, 1e-5)
    assert close(logits, want_logits, 1e-4)
    assert logits.shape == (B, 784)
    assert z.shape == (B, 2 * port.z_dim if pair["dist"] == "clifford"
                       else port.z_dim)


def test_flat_latent_matches_the_flax_module(pair):
    with torch.no_grad():
        z = pair["port"].get_flat_latent(torch.from_numpy(pair["x"]),
                                         random.sample_key(pair["rng"]))
    assert close(z, pair["want"][4], 1e-5)


def test_param_import_names_every_layer(pair):
    """Dense kernels transposed for ``nn.Linear``; the second head is
    ``fc_var`` (normal) or a 1-wide ``fc_scale``; every key is used."""
    sd = param_import.mlpvae_from_jax(pair["flat"])
    assert set(sd) == set(pair["port"].state_dict())
    np.testing.assert_array_equal(sd["enc1.weight"].numpy(),
                                  pair["flat"]["enc1/kernel"].T)
    head = "fc_var" if pair["dist"] == "normal" else "fc_scale"
    assert f"{head}.weight" in sd
    with pytest.raises(ValueError, match="not carried"):
        param_import.mlpvae_from_jax({**pair["flat"], "extra/kernel":
                                      np.zeros((2, 2), np.float32)})


def test_lanes_compute_what_their_own_models_compute(pair):
    """A ``LaneMLPVAE`` of the model and a perturbed copy, each lane on its
    own key, against the two ``MLPVAE``s."""
    port = pair["port"]
    other = mlp_vae.MLPVAE(32, port.z_dim, port.distribution,
                           port.l2_normalize)
    other.load_state_dict({k: v * 1.1 for k, v in port.state_dict().items()})
    lanes = mlp_vae.LaneMLPVAE(2, 32, port.z_dim, port.distribution,
                               port.l2_normalize)
    lanes.load_state_dict({k: torch.stack([a, other.state_dict()[k]])
                           for k, a in port.state_dict().items()})
    x = torch.from_numpy(pair["x"]).reshape(B, -1)
    keys = [(0, 5), (0, 6)]
    with torch.no_grad():
        got = lanes(torch.stack([x, x.flip(0)]), keys)
        for t, (model, xt) in enumerate(((port, x), (other, x.flip(0)))):
            (m, p2), _, z, logits = model(xt, keys[t])
            for a, b in ((got[0][0][t], m), (got[0][1][t], p2),
                         (got[2][t], z), (got[3][t], logits)):
                assert close(a, b.numpy(), 1e-5)


def test_init_is_xavier_from_the_seed_and_unknown_latents_raise():
    a, b = mlp_vae.MLPVAE(32, 5, "clifford"), mlp_vae.MLPVAE(32, 5,
                                                             "clifford")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            limit = np.sqrt(6.0 / sum(p.shape))
            assert 0.5 * limit < p.abs().max() <= limit, name
    assert a.dec1.weight.shape == (128, 10) and a.fc_scale.weight.shape == (
        1, 128)
    assert not torch.equal(mlp_vae.MLPVAE(32, 5, seed=1).enc1.weight,
                           mlp_vae.MLPVAE(32, 5).enc1.weight)
    with pytest.raises(ValueError, match="distribution"):
        mlp_vae.MLPVAE(32, 5, "gaussian")
    with pytest.raises(ValueError, match="sampler"):
        mlp_vae.MLPVAE(32, 5, "vmf", sampler="keyed")(
            torch.zeros(2, 784), (0, 1))
