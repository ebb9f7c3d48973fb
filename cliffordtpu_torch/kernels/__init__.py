"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version, a wrapper and a launch count (port of ``cliffordtpu/kernels``).

Sources live in ``cliffordtpu_torch/csrc``; ``build.py`` compiles them.
Importing the package registers the operators of ``ops.py`` (the kernels
and the latent draw as ``torch.export`` sees them); ``native.py`` loads
their C++ counterparts for the Python-free serving path on request.
"""

from cliffordtpu_torch.kernels import ops  # noqa: F401  (registers the ops)


def launch_counts() -> dict:
    """The launches of each kernel in this process so far, as its wrapper
    counts them (the attention forward's dense-route calls apart)."""
    from cliffordtpu_torch.kernels import attention, sampler, torus

    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            "torus_fwd": torus.fwd_launches, "torus_bwd": torus.launches,
            "sampler_keyed": sampler.launches,
            "sampler_rng": sampler.rng_launches}
