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
* `fold_in`, `split`, `bits`, `uniform` and `randint` are bit for bit
  JAX's.
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


def randint(k: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval, int32)` (JAX's default
    dtype with x64 off, as bench.py's model path runs), as int64 values:
    two 32-bit draws from the two halves of `split(k)`, each reduced
    modulo the span, combined as JAX combines them (`hi % span *
    ((2**16 % span)**2 % span) + lo % span` in uint32 arithmetic), and
    reduced again. Python int bounds with `0 < maxval - minval < 2**31`."""
    span = maxval - minval
    if not 0 < span < 2**31:
        raise ValueError(f"randint: span {span} not supported")
    halves = split(k)
    hi, lo = bits(halves[0], shape), bits(halves[1], shape)
    # JAX squares 2**16 % span in uint32: past a span of 2**16 the square
    # wraps to 0, and the high draw drops out
    mult = ((2**16 % span) ** 2 & MASK) % span
    off = ((hi % span) * mult) & MASK
    off = (off + lo % span) & MASK
    return minval + off % span


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


# XLA's float32 erf_inv (Giles' single-precision approximation), the
# polynomial in w = -log1p(-x*x) for w < 5 and in sqrt(w) - 3 past it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv` (`lax.erf_inv`) as torch ops: the same
    polynomial, each step a fused multiply-add as XLA's CPU code makes it
    (the product exact in float64, one rounding to float32 after the add
    but for a rare double rounding). `log1p` is torch's, not XLA's own
    approximation, so a result can be a few ulp from JAX's
    (tests/test_torch_lora.py states the bound)."""
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        c = torch.where(lt, lt5[i], ge5[i]).double()
        p = (c + p.double() * w).float()
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(k, shape, float32)`: `sqrt(2) * erf_inv(u)` of
    JAX's uniform `u` on `[nextafter(-1, 0), 1)`."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, minval=lo, maxval=1.0)
    return torch.tensor(2.0 ** 0.5, dtype=torch.float32) * erfinv(u)
