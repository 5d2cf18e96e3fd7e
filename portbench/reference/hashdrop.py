"""The serving decoder's prenet dropout: a counter hash keyed on (seed,
step, layer, row, unit), rate 0.5 (a frozen copy of the decode kernel's
hash, so the reference draws the masks the served decode drew)."""

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep(seed: int, step: int, layer: int, rows, units: int, device=None):
    """float32 (len(rows), units) mask: 1 keeps, 0 drops; ``rows`` are the
    rows of the served batch."""
    h = _mix32(torch.tensor((seed & _M32) ^ 0x9E3779B9, dtype=torch.int64, device=device))
    h = _mix32(h ^ step)
    row = torch.as_tensor(rows, dtype=torch.int64, device=device)[:, None]
    unit = torch.arange(units, dtype=torch.int64, device=device)[None, :]
    return (_mix32(h ^ ((row * 2 + layer) * 65536 + unit)) < 2 ** 31).float()
