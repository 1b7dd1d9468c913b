"""Unsigned 64-bit arithmetic on int64 tensors.

Hashes are u64 everywhere (HashIntoType in khmer). PyTorch's CPU build
implements no ``%``, ``<<`` or ``>>`` on ``torch.uint64``, so the port
carries every hash as the int64 tensor with the same bit pattern (from
numpy: ``arr.view(np.int64)``) and does the operations whose result
depends on signedness here. Multiplication, addition, xor, and, or and
left shifts give the same bits under either reading and need no helper.
"""

import torch

_SIGN = -(1 << 63)


def to_signed(x):
    """A Python int in [0, 2^64) -> the int64 value with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >= 1 << 63 else x


def srl(x, s):
    """Logical right shift of u64 bit patterns by a constant 0 <= s < 64."""
    if not 0 <= s < 64:
        raise ValueError("shift %d out of range" % s)
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod(x, p):
    """Unsigned ``x % p`` for a constant 0 < p < 2^62; result in [0, p).

    For a negative int64 x the unsigned value is x + 2^64, so its residue
    is that of x (torch.remainder is non-negative for p > 0) plus
    2^64 mod p.
    """
    p = int(p)
    if not 0 < p < (1 << 62):
        raise ValueError("modulus %d out of range" % p)
    r = torch.remainder(x, p)
    return torch.where(x < 0, torch.remainder(r + (1 << 64) % p, p), r)


_LOW32 = (1 << 32) - 1


def reciprocal(p):
    """floor((2^64 - 1) / p): the constant by which the kernels reduce a
    hash modulo p, a byte table's prime or the blocked layout's block count
    (csrc/u64_common.cuh reciprocal)."""
    p = int(p)
    if not 0 < p < (1 << 63):
        raise ValueError("modulus %d out of range" % p)
    return ((1 << 64) - 1) // p


def umulhi(x, m):
    """High 64 bits of the u64 product of bit patterns x and a constant
    0 <= m < 2^64 (CUDA's __umul64hi), from 32-bit halves whose partial
    products wrap in int64 to their u64 bits."""
    x0, x1 = x & _LOW32, srl(x, 32)
    m0, m1 = to_signed(m & _LOW32), to_signed(m >> 32)
    p00, p01, p10 = x0 * m0, x0 * m1, x1 * m0
    mid = srl(p00, 32) + (p01 & _LOW32) + (p10 & _LOW32)  # < 3 * 2^32
    return x1 * m1 + srl(p01, 32) + srl(p10, 32) + srl(mid, 32)


def umod_reciprocal(x, p):
    """Unsigned ``x % p`` for a constant 0 < p < 2^63 by the kernels'
    steps (csrc/u64_common.cuh reduce): q = umulhi(x, reciprocal(p)) is
    floor(x / p) or one less, r = x - q p lies in [0, 2p), and one
    subtraction ends it. The kernels' arithmetic, testable on the CPU."""
    p = int(p)
    r = x - umulhi(x, reciprocal(p)) * p
    return torch.where(ult(r, p), r, r - p)


def ult(a, b):
    """Unsigned ``a < b``: flipping the sign bit maps u64 order onto
    int64 order."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def umin(a, b):
    """Unsigned elementwise minimum."""
    return torch.where(ult(b, a), b, a)


_MIX1 = to_signed(0xBF58476D1CE4E5B9)
_MIX2 = to_signed(0x94D049BB133111EB)


def mix64(x):
    """splitmix64 finalizer (khmer_tpu core/blocked.py mix64); the int64
    multiplies wrap to the same bits as the u64 ones."""
    x = x ^ srl(x, 30)
    x = x * _MIX1
    x = x ^ srl(x, 27)
    x = x * _MIX2
    return x ^ srl(x, 31)
