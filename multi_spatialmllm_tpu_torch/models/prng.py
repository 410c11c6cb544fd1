"""`jax.random`'s threefry streams as torch integer ops.

The JAX package samples tokens with `jax.random` (`fold_in`, `split`,
`categorical`); this module reproduces those streams, so the port draws
the tokens JAX draws from the same logits. It follows JAX 0.9 with its
defaults: the threefry2x32 PRNG, `jax_threefry_partitionable=True` (the
layout of `bits` and `split`) and the "low" Gumbel mode. Keys are a pair
of uint32 words held as int64 tensors (`[..., 2]`), and every word stays
masked to 32 bits: CUDA's uint32 arithmetic is incomplete in torch, int64
is not. Everything runs on the device of its inputs.

* `key(seed)` is `threefry_seed`: the high word is `seed >> 32` and the
  low word `seed & 0xffffffff`. A seed given as an int64 tensor or a
  Python int (any int64, a negative one as its two's complement) takes
  the 64-bit rule, as JAX does with x64 on; an int32 tensor takes JAX's
  32-bit rule (high word 0, as a batcher's int32 seed slots give), so
  seeds 0 to 2**31 - 1 agree either way.
* `fold_in`, `split`, `bits` and `uniform` are bit for bit JAX's.
* `gumbel` is `-log(-log(u))` of JAX's uniform `u`, computed in float64
  and rounded once to float32: the same on the CPU and the card, and
  within a few float32 ulp of JAX's float32 logs (which are not correctly
  rounded). `categorical` is `argmax(logits + gumbel)`, as in JAX, so a
  drawn token can differ from JAX's only where the top two of
  `logits + gumbel` lie within those few ulp.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of count words `(x0, x1)` under key words
    `(k0, k1)`: int64 tensors (or ints) of uint32 values, broadcast
    together -> `(y0, y1)`."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """`jax.random.key(seed)`'s words `[..., 2]` int64 for a seed or a
    tensor of seeds (see the module docstring for the 32/64-bit rule)."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(device) if device is not None else seed
        if s.dtype == torch.int32:
            lo = s.long() & MASK
            hi = torch.zeros_like(lo)
        else:
            s = s.long()
            hi, lo = (s >> 32) & MASK, s & MASK
        return torch.stack([hi, lo], dim=-1)
    seed = int(seed) % (1 << 64)
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)` (data cast to uint32), over any
    leading batch dims of `k` `[..., 2]` and `data` (broadcast)."""
    d = torch.as_tensor(data, device=k.device).long() & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _counts(shape, device):
    """The (hi, lo) words of each element's row-major index (JAX's
    `iota_2x32_shape`)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (idx >> 32) & MASK, idx & MASK


def _hash_counts(k: torch.Tensor, shape):
    """threefry of every count of `shape` under key(s) `k` `[..., 2]`:
    `(y0, y1)` of shape `k.shape[:-1] + shape`."""
    c_hi, c_lo = _counts(tuple(shape), k.device)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    return threefry2x32(k[..., 0].reshape(view), k[..., 1].reshape(view),
                        c_hi, c_lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)` -> `[num, 2]` (partitionable layout)."""
    y0, y1 = _hash_counts(k, (num,))
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32 values in int64), for one key
    or a batch of keys `[..., 2]` (result `k.shape[:-1] + shape`)."""
    y0, y1 = _hash_counts(k, tuple(shape))
    return y0 ^ y1


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`: the top 23
    bits as a mantissa in [1, 2), minus one, scaled and shifted in float32
    and clamped below at minval."""
    b = bits(k, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=k.device) - lo
    return torch.maximum(lo, f * span + lo)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """Gumbel noise as `jax.random.gumbel(k, shape)` (float32; see the
    module docstring for its rounding)."""
    u = uniform(k, shape, minval=F32_TINY, maxval=1.0).double()
    return (-torch.log(-torch.log(u))).float()


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits, axis=-1)` for float32 logits
    `[..., V]`: one key draws all rows (`k` `[2]`, the noise over the
    whole shape), or a key per row (`k` `[..., 2]` matching the leading
    dims: `vmap(categorical)` over rows)."""
    if k.dim() == 1:
        g = gumbel(k, logits.shape)
    else:
        assert k.shape[:-1] == logits.shape[:-1], (k.shape, logits.shape)
        g = gumbel(k.reshape(-1, 2), logits.shape[-1:]).reshape(logits.shape)
    return torch.argmax(g + logits.float(), dim=-1)
