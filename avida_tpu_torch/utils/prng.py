"""`jax.random`'s threefry stream, draw for draw, on torch tensors.

The reference package draws every random number of an update from
`jax.random` (threefry2x32 with `jax_threefry_partitionable=True`): the
per-update key is `fold_in(run_key, update_no)`, and the scheduler, the
birth flush and the cycle kernel's seed all draw from its splits.  This
module reproduces that stream exactly so a port run can be held against a
reference run bit for bit (tests/test_torch_prng.py).

A key is an int64 tensor of shape (2,) holding two uint32 words (torch
has no general uint32 arithmetic; every value stays in [0, 2**32) and
each add or shift is masked).  All draws land on the key's device.

Integer draws (`split`, `fold_in`, `bits`, `randint`) and `uniform` are
exact by construction.  The float samplers (`normal`, `binomial`) repeat
the float32 arithmetic of the reference's compiled CPU program: the
transcendental functions are the polynomial approximations XLA's CPU
backend emits (`xla_log`, `xla_log1p`, `xla_erf_inv`), and every multiply
that XLA contracts into a fused multiply-add is an `fma_f32` here.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


# ---- threefry2x32 ----

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors of
    uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.key(seed)`'s raw words: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def _counts(n: int, device):
    """Flat uint64 iota split into (hi, lo) uint32 words."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return lo >> 32, lo & MASK32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)` -> int64[num, 2]."""
    hi, lo = _counts(num, k.device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b0, b1], dim=1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)` for a scalar `data` (uint32)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    o0, o1 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([o0, o1])


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32) as int64 values."""
    shape = tuple(shape)
    n = math.prod(shape)
    hi, lo = _counts(n, k.device)
    b0, b1 = threefry2x32(k[0], k[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


def split_rows(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`split` of each row of int64[K, 2] keys -> int64[K, num, 2]."""
    hi, lo = _counts(num, keys.device)
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    return torch.stack([b0, b1], dim=2)


def fold_in_rows(keys: torch.Tensor, data) -> torch.Tensor:
    """`fold_in(k, data)` of each row of int64[K, 2] keys -> [K, 2]; `data`
    a scalar, or int64[D] for every (key, datum) pair -> [K, D, 2]."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    if d.dim():
        o0, o1 = threefry2x32(keys[:, :1], keys[:, 1:],
                              torch.zeros_like(d)[None], d[None])
        return torch.stack([o0, o1], dim=2)
    o0, o1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=1)


def bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`bits(k, (n,))` of each row of int64[K, 2] keys -> int64[K, n]."""
    hi, lo = _counts(n, keys.device)
    b0, b1 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    return b0 ^ b1


def randint_from_bits(higher, lower, minval: int, maxval: int):
    """`randint`'s arithmetic on its two bit draws (Python int bounds):
    the int32 values."""
    lo, hi = max(int(minval), -2**31), min(int(maxval), 2**31 - 1)
    span = (hi - lo) & MASK32 if hi > lo else 1
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = ((((higher % span) * mult) & MASK32) + (lower % span)) & MASK32
    out = lo + off % span
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def bits_to_unit(b):
    """uint32 bits -> float32 in [0, 1): 23 mantissa bits under exponent 0
    (`uniform` on [0, 1) is exactly this)."""
    w = ((b >> 9) | 0x3F800000).to(torch.int32)
    return w.view(torch.float32) - 1.0


def uniform(k, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`."""
    f = bits_to_unit(bits(k, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, fma_f32(f, hi - lo, lo))


def randint(k, shape, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(k, shape, minval, maxval, int32)`; the bounds
    may be Python ints or int tensors broadcastable to `shape`."""
    shape = tuple(shape)
    k1, k2 = split(k)
    higher, lower = bits(k1, shape), bits(k2, shape)
    dev = k.device
    lo = torch.as_tensor(minval, device=dev).to(torch.int64)
    hi = torch.as_tensor(maxval, device=dev).to(torch.int64)
    lo = lo.clamp(-2**31, 2**31 - 1)
    hi = hi.clamp(-2**31, 2**31 - 1)
    span = (hi - lo) & MASK32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    mult = (2**16) % span
    mult = ((mult * mult) & MASK32) % span
    off = (((higher % span) * mult) & MASK32) + (lower % span)
    off = (off & MASK32) % span
    out = lo + off
    out = torch.where(out >= 2**31, out - 2**32, out)
    return torch.broadcast_to(out, shape).to(torch.int32)


# ---- the float32 arithmetic of XLA's CPU backend ----

def fma_f32(a, b, c):
    """float32 fused multiply-add, computed in float64: the float32
    product is exact there, so only the final rounding to float32
    remains (a double rounding that differs from a true fma only on
    exact float64 ties).  A Python number operand is rounded to float32
    first and enters as a scalar (no host-to-device copy)."""
    a = torch.as_tensor(a)
    return (a.double() * _f64(b, a) + _f64(c, a)).float()


def _f64(x, like):
    """An fma_f32 operand in float64: a tensor on `like`'s device, or a
    Python number rounded to float32."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, device=like.device).double()
    return round_f32(x)


def round_f32(x) -> float:
    """A Python number rounded to the nearest float32 (as a Python
    float): the value a float32 tensor op gives a weakly typed scalar."""
    import struct
    return struct.unpack("<f", struct.pack("<f", float(x)))[0]


def f32_reciprocal(x) -> float:
    """1 / x in float32 arithmetic, as a Python float: the constant XLA's
    algebraic simplifier multiplies by where a program divides a float32
    value by the constant x."""
    import numpy as np
    return float(np.float32(1.0) / np.float32(x))


def xla_f32_sum(x):
    """float32 total of a vector in the order of XLA's CPU backend (the
    reference's `x.sum()` in a compiled program).  Its tree-reduction pass
    cuts a reduction over more than 32 values into windows of 32 -- the
    vector zero-padded to a multiple of 32, the smaller half of the
    padding in front -- sums each window in order, and repeats on the
    window sums; 32 or fewer values are summed in order.  Float32 adds
    only, so it rounds the same on every device.  A tensor of more than
    one dimension is reduced along its first: each column in that
    order."""
    x = torch.as_tensor(x).to(torch.float32)
    while x.shape[0] > 32:
        pad = -x.shape[0] % 32
        x = torch.cat([x.new_zeros((pad // 2,) + x.shape[1:]), x,
                       x.new_zeros((pad - pad // 2,) + x.shape[1:])])
        x = _sum_rows_in_order(x.reshape((-1, 32) + x.shape[1:])
                               .transpose(0, 1))
    return _sum_rows_in_order(x)


def _sum_rows_in_order(rows):
    """0 + rows[0] + rows[1] + ... in float32."""
    total = rows.new_zeros(rows.shape[1:])
    for r in rows:
        total = total + r
    return total


def sqrt_f32(x):
    """Correctly rounded float32 square root (torch's vectorised CPU
    kernel is not; the float64 root rounds to the right float32)."""
    return x.double().sqrt().float()


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _hexf(h: int) -> float:
    """A float32 constant written as the float64 hex of LLVM IR."""
    import struct
    return struct.unpack(">d", h.to_bytes(8, "big"))[0]


_LOG_P = tuple(_hexf(h) for h in (
    0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000,
    0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000,
    0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000))
_LOG_Q1 = _hexf(0xBF2BD01060000000)
_LOG_Q2 = _hexf(0x3FE6300000000000)
_SQRTHF = _hexf(0x3FE6A09E60000000)
_MIN_NORM = _hexf(0x3810000000000000)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend computes it (the Cephes
    polynomial, with its multiply-adds fused)."""
    x = x.float()
    # XLA's CPU code runs with denormals-are-zero
    x = torch.where(x.abs() < _MIN_NORM, x * 0.0, x)
    invalid = ~(x > 0)                 # x <= 0 or NaN
    iszero = x == 0
    isinf = x == math.inf
    xc = torch.where(x <= _MIN_NORM, _MIN_NORM, x)
    w = xc.view(torch.int32)
    e = ((w >> 23) & 0x1FF) - 127
    m = ((w & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    e1 = e.float() + 1.0
    mask = m < _SQRTHF
    tmp = torch.where(mask, m, 0.0)
    e2 = e1 - mask.float()
    xm = (m - 1.0) + tmp
    x2 = xm * xm
    x3 = x2 * xm
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _LOG_P
    y = fma_f32(xm, p0, p1)
    y1 = fma_f32(xm, p3, p4)
    y = fma_f32(y, xm, p2)
    y1 = fma_f32(y1, xm, p5)
    y = fma_f32(y, x3, y1)
    y2 = fma_f32(xm, p6, p7)
    y2 = fma_f32(y2, xm, p8)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e2 * _LOG_Q1)
    r = fma_f32(x2, -0.5, xm)
    r = r + y
    r = fma_f32(e2, _LOG_Q2, r)
    r = torch.where(invalid, math.nan, r)
    r = torch.where(iszero, -math.inf, r)
    return torch.where(isinf, math.inf, r)


_EXP_LN2 = _hexf(0x3FE62E4300000000)
_EXP_LO = _hexf(0xC055F33340000000)
_EXP_HI = _hexf(0x4056333340000000)
_EXP_LOG2E = _hexf(0x3FF7154760000000)
_EXP_C1 = _hexf(0x3FE6300000000000)
_EXP_C2 = _hexf(0xBF2BD01060000000)
_EXP_P = tuple(_hexf(h) for h in (
    0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000,
    0x3FA5553820000000, 0x3FC5555540000000))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend computes it: the Cephes range
    reduction and polynomial with the multiply-adds its code generator
    fuses, a power of two built in the exponent bits, and results below
    the smallest normal flushed to zero."""
    x = x.float().clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(fma_f32(x, _EXP_LOG2E, 0.5)).clamp(-127.0, 127.0)
    x = fma_f32(fx, -_EXP_C1, x)
    x = fma_f32(fx, -_EXP_C2, x)
    p0, p1, p2, p3, p4 = _EXP_P
    y = fma_f32(x, p0, p1)
    for c in (p2, p3, p4, 0.5):
        y = fma_f32(y, x, c)
    r = fma_f32(y, x * x, x) + 1.0
    r = r * ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(r.abs() < _MIN_NORM, r * 0.0, r)


def xla_exp2(x: torch.Tensor) -> torch.Tensor:
    """`jnp.exp2` on XLA's CPU backend: exp(x * float32(ln 2))."""
    return xla_exp(x.float() * _EXP_LN2)


_L1P_A = tuple(_hexf(h) for h in (
    0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
    0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000))
_L1P_B0 = _hexf(0x3F07BC0960000000)
_L1P_B = tuple(_hexf(h) for h in (
    0x3FDFE818A0000000, 0x401A509F40000000, 0x403DE97380000000,
    0x404E798EC0000000, 0x404C8E75A0000000, 0x40340A2020000000))
_L1P_SMALL = _hexf(0x3FDA8279A0000000)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend computes it: log(1 + x) for
    |x| >= sqrt(2) - 1, else a Cephes rational approximation."""
    x = x.float()
    large = xla_log(x + 1.0)
    den = fma_f32(x, 0.0, 1.0)
    for c in _L1P_A:
        den = fma_f32(den, x, c)
    num = fma_f32(x, 0.0, _L1P_B0)
    for c in _L1P_B:
        num = fma_f32(num, x, c)
    xx = x * x
    t = (x * xx) * (num / den)
    small = x + fma_f32(xx, -0.5, t)
    return torch.where(x.abs() < _L1P_SMALL, small, large)


_ERFINV_LT5 = tuple(_hexf(h) for h in (
    0x3E5E2CB100000000, 0x3E970966C0000000, 0xBECD8E6AE0000000,
    0xBED26B5820000000, 0x3F2CA65B60000000, 0xBF548A8100000000,
    0xBF711C9DE0000000, 0x3FCF91EC60000000, 0x3FF805C5E0000000))
_ERFINV_GE5 = tuple(_hexf(h) for h in (
    0xBF2A3E1360000000, 0x3F1A76AD60000000, 0x3F561B8E40000000,
    0xBF6E17BCE0000000, 0x3F77824F60000000, 0xBF7F38BAE0000000,
    0x3F8354AFC0000000, 0x3FF006DB60000000, 0x4006A9EFC0000000))


def xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function (Giles' polynomials) as XLA's CPU
    backend computes it."""
    x = x.float()
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    z = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)

    def coef(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i], x),
                           _f32(_ERFINV_GE5[i], x))

    p = fma_f32(coef(0), z, coef(1))
    for i in range(2, 9):
        p = fma_f32(p, z, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k, shape) -> torch.Tensor:
    """`jax.random.normal(k, shape)` (float32)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return _f32(math.sqrt(2.0), u) * xla_erf_inv(u)


# ---- binomial (jax.random's inversion + BTRS samplers) ----

_STIRLING = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
             0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
             0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
             0.00833056343336287)


def _stirling_tail(k):
    table = torch.tensor(_STIRLING, dtype=torch.float32, device=k.device)
    kc = k.clamp(0.0, 9.0)
    kp1sq = (kc + 1) * (kc + 1)
    approx = (_f32(1.0 / 12, k) - (_f32(1.0 / 360, k)
                                   - _f32(1.0 / 1260, k) / kp1sq) / kp1sq) \
        / (kc + 1)
    return torch.where(k <= 9, table[torch.floor(kc).long()], approx)


def _binomial_inversion(k, count, prob):
    log1mp = xla_log1p(-prob)
    num_geom = torch.zeros_like(prob)
    geom_sum = torch.zeros_like(prob)
    while bool((geom_sum <= count).any()):
        ks = split(k)
        sub, k = ks[0], ks[1]
        num_geom = torch.where(geom_sum <= count, num_geom + 1, num_geom)
        u = uniform(sub, prob.shape)
        geom = torch.ceil(xla_log(u) / log1mp)
        geom_sum = geom_sum + geom
    return num_geom - 1


def _btrs(k, count, prob):
    stddev = sqrt_f32(count * prob * (1 - prob))
    b = fma_f32(stddev, 2.53, 1.15)
    a = fma_f32(prob, 0.01, fma_f32(b, 0.0248, -0.0873))
    c = fma_f32(count, prob, 0.5)
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full_like(prob, -1.0)
    accepted = torch.zeros(prob.shape, dtype=torch.bool, device=prob.device)
    while not bool(accepted.all()):
        ks = split(k, 3)
        k, k0, k1 = ks[0], ks[1], ks[2]
        u = uniform(k0, prob.shape)
        v = uniform(k1, prob.shape)
        u = u - 0.5
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        kk = torch.floor(fma_f32(2 * a / us + b, u, c))
        reject = (kk < 0) | (kk > count)
        v = xla_log(v * alpha / (a / (us * us) + b))
        ub = fma_f32(m + 0.5, xla_log((m + 1) / (r * (count - m + 1))),
                  (count + 1) * xla_log((count - m + 1) / (count - kk + 1)))
        ub = fma_f32(kk + 0.5, xla_log(r * (count - kk + 1) / (kk + 1)), ub)
        ub = (ub + _stirling_tail(m) + _stirling_tail(count - m)
              - _stirling_tail(kk) - _stirling_tail(count - kk))
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, kk, k_out)
        accepted = accepted | accept
    return k_out


def binomial(k, count, prob) -> torch.Tensor:
    """`jax.random.binomial(k, count, prob)` (float32 samples) for a
    float32 count and probability vector (count >= 0, 0 <= prob <= 1)."""
    prob = torch.as_tensor(prob, dtype=torch.float32, device=k.device)
    count = torch.as_tensor(count, dtype=torch.float32, device=k.device)
    shape = torch.broadcast_shapes(count.shape, prob.shape)
    count = torch.broadcast_to(count, shape)
    prob = torch.broadcast_to(prob, shape)
    q = torch.where(prob < 0.5, prob, 1.0 - prob)
    q_nan = torch.isnan(q)
    q_neg = q < 0.0
    q = torch.where(q_nan | q_neg, _f32(0.01, q), q)
    count_bad = torch.isnan(count) | (count < 0.0)
    use_inv = count_bad | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inv, count, _f32(0.0, q))
    count_btrs = torch.where(use_inv, _f32(1e4, q), count)
    q_btrs = torch.where(use_inv, _f32(0.5, q), q)
    samples = torch.where(use_inv, _binomial_inversion(k, count_inv, q),
                          _btrs(k, count_btrs, q_btrs))
    samples = torch.where(q_neg | q_nan | count_bad,
                          _f32(math.nan, q), samples)
    count_inf = torch.isinf(count)
    samples = torch.where(count_inf & ~(q_neg | q_nan | count_bad),
                          _f32(math.inf, q), samples)
    keep = (prob < 0.5) | count_bad | q_nan | count_inf
    return torch.where(keep, samples, count - samples)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.cumsum` of a float32 vector on XLA's CPU backend.  Up to 16
    values: the running sum in order.  Longer: its reduce-window rewrite
    -- the vector zero-padded to rows of 16, the running sum inside each
    row, and the total of the rows before it (this same scan over the
    row totals, shifted by one) added to each row."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n <= 16:
        out = torch.empty_like(x)
        acc = x.new_zeros(())
        for i in range(n):
            acc = acc + x[i]
            out[i] = acc
        return out
    k = -(-n // 16)
    rows = torch.cat([x, x.new_zeros(16 * k - n)]).reshape(k, 16)
    inner = torch.empty_like(rows)
    acc = x.new_zeros(k)
    for j in range(16):
        acc = acc + rows[:, j]
        inner[:, j] = acc
    before = torch.cat([x.new_zeros(1), xla_cumsum(inner[:, 15])[:-1]])
    return (inner + before[:, None]).reshape(-1)[:n]


def choice(k, n: int, shape, p) -> torch.Tensor:
    """`jax.random.choice(k, n, shape, p=p)` with replacement: the
    cumulative weights (xla_cumsum), r = total * (1 - uniform), and the
    first index whose cumulative weight reaches r (searchsorted,
    left)."""
    p_cuml = xla_cumsum(p.to(torch.float32))
    r = p_cuml[-1] * (1.0 - uniform(k, shape))
    return torch.searchsorted(p_cuml, r).to(torch.int32)
