"""The pieces of ``jax.random`` the port needs, bit for bit.

Threefry-2x32 is counter-based, so there is no hidden generator: a key is
two uint32 words that the caller passes, and every draw is a pure function
of (key, counter).  Under jax's partitionable threefry (the default on
jax 0.9):

* ``split(key)[i] = threefry2x32(key, hi=0, lo=i)``
  (``jax._src.prng._threefry_split_foldlike``);
* the 32 random bits at flat index q of a draw are
  ``x0 ^ x1`` with ``(x0, x1) = threefry2x32(key, hi=0, lo=q)``
  (``_threefry_random_bits_partitionable``);
* ``uniform`` turns bits into a float with the mantissa trick and
  ``max(minval, f * (maxval - minval) + minval)`` in float32, with
  ``maxval - minval`` rounded to float32 first
  (``jax._src.random._uniform``).  XLA contracts the product and the sum
  into one fused multiply-add, so the port forms them in float64 (where
  the product of two float32 values is exact) and rounds once to
  float32;
* ``normal`` is ``jax._src.random._normal_real``: a uniform in
  (nextafter(-1, 0), 1), then ``sqrt(2) * erfinv``.  Its words are
  jax's bit for bit; the normals differ from jax's by XLA's float32
  ``erf_inv`` approximation (a few 1e-6 relative on the CPU), against
  ``torch.special.erfinv``'s near-exact one.

* ``fold_in(key, data) = threefry2x32(key, hi=0, lo=data)``
  (``_threefry_fold_in`` on ``threefry_seed(data)``);
* ``permutation(key, n)`` is ``jax._src.random._shuffle`` on a range:
  ceil(3 ln n / ln(2**32 - 1)) rounds, each splitting the key, drawing
  32-bit sort keys and sorting stably by them;
* ``randint`` is ``jax._src.random._randint`` at int32: two halves of a
  split, 32 bits each, reduced modulo the span in wrapping uint32
  arithmetic;
* flax's first ``make_rng("sample")`` in a root module is
  ``fold_in(rng, 3213575472)`` (``sample_key``): the first four bytes of
  the SHA-1 of the counter 1, which ``flax.core.scope._fold_in_static``
  folds in.

``lane_uniform`` draws for T keys at once: the key words are (T, 1)
tensors, so one set of integer operations gives T draws, each the one
its key gives alone (the counterpart of ``jax.vmap`` over keys).

Beside threefry stands Philox-4x32-10 (Salmon et al., SC'11), the
generator of the Philox sampler kernel (``csrc/sampler_rng.cu``), which
has no counterpart in ``jax.random``.

Words are held in int64 tensors masked to 32 bits, so every operation is
exact on any device.  The CUDA sampler kernels (``csrc/sampler_keyed.cu``,
``csrc/sampler_rng.cu``) compute the same words and are held to these
functions bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Union[Sequence[int], np.ndarray, torch.Tensor]


def key_words(key: Key) -> Tuple[int, int]:
    """A key as two Python ints in [0, 2**32): accepts a pair of ints, a
    uint32 array of shape (2,) (a raw ``jax.random.PRNGKey``) or a tensor."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    words = [int(w) for w in np.asarray(key).reshape(-1)]
    if len(words) != 2:
        raise ValueError(f"a key is two uint32 words, got {len(words)}")
    if any(not 0 <= w <= _MASK for w in words):
        raise ValueError(f"key words must lie in [0, 2**32), got {words}")
    return words[0], words[1]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds, key injection every 4) on uint32 words
    held in int64 tensors or in Python ints; returns (x0, x1) alike."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def split_words(key: Key, num: int = 2) -> List[Tuple[int, int]]:
    """``jax.random.split`` on the host: ``num`` keys as pairs of ints.
    Python ints run the same threefry code as tensors, without launching
    a tensor operation per step."""
    k0, k1 = key_words(key)
    return [threefry2x32(k0, k1, 0, i) for i in range(num)]


def fold_in_words(key: Key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` on the host, for a ``data`` that
    fits one uint32 word: the new key as a pair of ints."""
    if not 0 <= data <= _MASK:
        raise ValueError(f"data must lie in [0, 2**32), got {data}")
    k0, k1 = key_words(key)
    return threefry2x32(k0, k1, 0, data)


def split(key: Key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: an int64 tensor (num, 2) of new keys (CPU)."""
    return torch.tensor(split_words(key, num), dtype=torch.int64)


def fold_in(key: Key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the new key as an int64 tensor (2,) (CPU)."""
    return torch.tensor(fold_in_words(key, data), dtype=torch.int64)


# the first four bytes of sha1(b"\x01"): flax folds the rng counter 1 in so
MAKE_RNG_DATA = 3213575472


def sample_key(rng: Key) -> Tuple[int, int]:
    """The key that a flax root module's first ``self.make_rng(name)``
    derives from the rng passed to ``apply`` as ``rngs={name: rng}``: the
    sampling key of one forward pass of the JAX models."""
    return fold_in_words(rng, MAKE_RNG_DATA)


def _bits(k0, k1, n: int, device) -> torch.Tensor:
    """x0 ^ x1 of threefry2x32(key, (0, q)) for the counters q < n; k0, k1
    are ints or (T, 1) tensors, which give (T, n)."""
    if n > 2 ** 32:
        raise ValueError("counters beyond 2**32 need the hi word; not ported")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return x0 ^ x1


def random_bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), the words
    ``jax.random.bits(key, shape)`` gives."""
    k0, k1 = key_words(key)
    n = int(np.prod(shape, dtype=np.int64))
    return _bits(k0, k1, n, device).reshape(tuple(shape))


def lane_uniform(keys: torch.Tensor, shape: Sequence[int],
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)`` bit for
    bit: ``keys`` is an int64 tensor (T, 2) of key words on the device the
    draws go to; returns (T, *shape)."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64 (T, 2), got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    n = int(np.prod(shape, dtype=np.int64))
    bits = _bits(keys[:, :1], keys[:, 1:], n, keys.device)
    return uniform_from_bits(bits, minval, maxval).reshape(
        (keys.shape[0], *shape))


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` (int64 (n,)): per round a split,
    32-bit sort keys from ``random_bits`` and a stable sort."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split_words(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) bit for
    bit, as an int64 tensor: the key splits in two, each half draws 32
    bits per element, and with span = maxval - minval (1 when maxval <=
    minval) and m = (2**16 % span)**2 % span the offset is ((hi % span) *
    m + lo % span) % span, every product and sum wrapping in uint32 as
    jax forms them (so m is 0 for a span above 2**16)."""
    if not -2 ** 31 <= minval <= maxval <= 2 ** 31 - 1:
        raise ValueError(f"[{minval}, {maxval}) must be an int32 range")
    k_hi, k_lo = split_words(key)
    hi = random_bits(k_hi, shape, device)
    lo = random_bits(k_lo, shape, device)
    span = max(maxval - minval, 1)
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span  # 0 for span > 2**16
    a = hi % span  # < span < 2**32; a * mult wraps mod 2**32
    prod = (a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16)) \
        & _MASK
    return minval + ((prod + lo % span) & _MASK) % span


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """uint32 words -> float32 uniforms in [minval, maxval), exactly as
    ``jax.random.uniform`` does: mantissa float f in [0, 1), then
    ``max(minval, f * (maxval - minval) + minval)`` in float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f  # max(0, f * 1 + 0) == f for f in [0, 1)
    # the bounds and their difference rounded to float32 as jax rounds
    # them, held as Python floats (no copy to the device); then
    # f * (hi - lo) + lo as one fused multiply-add, as XLA computes it
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    fma = (f.double() * scale + float(lo)).float()
    return torch.clamp(fma, min=float(lo))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` bit for
    bit."""
    return uniform_from_bits(random_bits(key, shape, device), minval, maxval)


# nextafter(-1, 0) in float32: the lower end of jax's normal draws
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the same uniform words in
    (nextafter(-1, 0), 1), then sqrt(2) * erfinv."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return torch.special.erfinv(u) * np.float32(np.sqrt(2.0))


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)


def _mulhilo(m: int, x):
    """(high, low) words of the 64-bit product of the constant ``m`` and the
    word ``x``, from two products that stay below 2**48 (an int64 tensor
    cannot hold the full product)."""
    lo_part = x * (m & 0xFFFF)
    hi_part = x * (m >> 16)
    return ((hi_part + (lo_part >> 16)) >> 16,
            (lo_part + ((hi_part & 0xFFFF) << 16)) & _MASK)


def philox4x32(key: Key, counter, rounds: int = 10):
    """Philox-4x32 on uint32 words held in int64 tensors or in Python ints:
    ``key`` two words, ``counter`` four (each a tensor or an int; they
    broadcast).  Returns the four output words."""
    k0, k1 = key_words(key)
    c0, c1, c2, c3 = counter
    for i in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK
        k1 = (k1 + _PHILOX_W[1]) & _MASK
    return c0, c1, c2, c3
