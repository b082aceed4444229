"""Least device time of the kernels' work at the card's published peaks.

Frozen copies of `chip_smoke.py:compositor_bound`, `backward_bound` and
`field_bound` (the arithmetic unchanged), so that the yardstick stays fixed
when the program's own smoke test changes. Each returns (ms, what sets it).
`*_ops` give the operation counts alone, split by the unit that runs them,
for `mfu.train`.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, bf16 dense
# tensor-core products, HBM3 bandwidth
PEAK_F32_OPS = 67e12
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12
H = 256  # the fields' trunk width
DEPTH = 8


def compositor_ops(channels: int, pairs: int) -> float:
    """f32 operations of one compositor call over `pairs` walked (pixel,
    Gaussian) pairs: 11 for sigma, 4 for alpha, 2 tests, 3 for the
    transmittance, 1 for the weight, 2C + 1 to accumulate."""
    return float(pairs * (22 + 2 * channels))


def backward_ops(channels: int, pairs: int) -> float:
    """f32 operations of one compositor backward over `pairs` live pairs."""
    return float(pairs * (48 + 4 * channels))


def compositor_bound(n: int, channels: int, num_isects: int, num_tiles: int, pixels: int, pairs: int):
    bytes_ = 4 * (n * (7 + channels) + num_isects + num_tiles + 1 + pixels * (channels + 3))
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = compositor_ops(channels, pairs) / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def backward_bound(n: int, channels: int, num_isects: int, num_tiles: int, pixels: int, pairs: int):
    bytes_ = 4 * (
        n * (7 + channels) + num_isects + num_tiles + 1 + pixels * (channels + 3) + num_isects * (8 + channels)
    )
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = backward_ops(channels, pairs) / PEAK_F32_OPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def field_ops(n: int, in_ch: int, backward: bool, heads: bool):
    """(bf16 tensor-core operations, f32 operations) of one field call: the
    trunk's products 2 n 256 (2 in_ch + 7 x 256), the heads' 2 n 13 x 256,
    each twice backward (input and weight gradients)."""
    k = 2 if backward else 1
    trunk = 2.0 * n * H * (2 * in_ch + 7 * H) * k
    head = 2.0 * n * 13 * H * k if heads else 0.0
    return trunk, head


def field_bound(n: int, in_ch: int, save: bool, backward: bool, heads: bool, sources: int = 1):
    trunk, head_ops = field_ops(n, in_ch, backward, heads)
    t_ops = (trunk / PEAK_BF16_OPS + head_ops / PEAK_F32_OPS) * 1e3
    if backward:
        io = 4 * 3 * sources * 2 + (4 * 13 if heads else 4 * H)
    else:
        io = 4 * 3 * sources + (4 * 13 if heads else (0 if save else 2 * H))
    per_row = io + (2 * (128 + DEPTH * H) if (save or backward) else 0)
    weights = H * (2 * in_ch + 7 * H) * (2 + (4 if backward else 0)) + (4 * 13 * H if heads else 0)
    t_bytes = (n * per_row + weights) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
