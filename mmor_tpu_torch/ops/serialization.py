"""Space-filling-curve serialization codes for point clouds (PTv3).

Counterpart of ``mmor_tpu/ops/serialization.py``: int32 bit arithmetic,
10 bits per axis (grid coordinates clamped to [0, 1023]) -> 30-bit codes,
for the four PTv3 orders. Coordinates may carry leading batch dims.
"""

from __future__ import annotations

import torch

BITS = 10
MAX_COORD = (1 << BITS) - 1

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _part_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x with two zero bits between each."""
    x = x & MAX_COORD
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def z_order_encode(grid_coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int grid coords -> (...,) int32 Morton codes (x lowest bits)."""
    c = torch.clamp(grid_coords, 0, MAX_COORD).to(torch.int32)
    return (_part_bits(c[..., 0]) | (_part_bits(c[..., 1]) << 1)
            | (_part_bits(c[..., 2]) << 2))


def hilbert_encode(grid_coords: torch.Tensor) -> torch.Tensor:
    """(..., 3) int grid coords -> (...,) int32 Hilbert indices (Skilling's
    transpose-form conversion, then bit interleave)."""
    c = torch.clamp(grid_coords, 0, MAX_COORD).to(torch.int32)
    x = [c[..., 0], c[..., 1], c[..., 2]]
    n = 3
    m = 1 << (BITS - 1)
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            cond = (x[i] & q) != 0
            x0_inv = x[0] ^ p
            t = (x[0] ^ x[i]) & p
            x0_exch = x[0] ^ t
            xi_exch = x[i] ^ t
            x[0] = torch.where(cond, x0_inv, x0_exch)
            if i != 0:
                x[i] = torch.where(cond, x[i], xi_exch)
        q >>= 1
    for i in range(1, n):  # Gray encode
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q = m
    while q > 1:
        t = torch.where((x[n - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    for i in range(n):
        x[i] = x[i] ^ t
    code = torch.zeros_like(x[0])
    for b in range(BITS):
        for i in range(n):
            code = code | (((x[i] >> b) & 1) << (b * n + (n - 1 - i)))
    return code


def encode(grid_coords: torch.Tensor, order: str) -> torch.Tensor:
    """Serialization code for one of the 4 PTv3 orders."""
    if order == "z":
        return z_order_encode(grid_coords)
    if order == "z-trans":
        return z_order_encode(grid_coords[..., [1, 0, 2]])
    if order == "hilbert":
        return hilbert_encode(grid_coords)
    if order == "hilbert-trans":
        return hilbert_encode(grid_coords[..., [1, 0, 2]])
    raise ValueError(f"unknown order {order!r}")
