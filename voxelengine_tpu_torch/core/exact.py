"""Correctly rounded float32 division and square root.

The traversal truncates entry points to cells, so its results depend on
the last bit of every float op; the JAX package and the Hopper kernel both
round each op as IEEE does.  Two torch ops do not by default:

* CUDA ``div`` turns ``tensor / python_number`` into a multiplication by
  the number's reciprocal, which can lose one bit.  :func:`fdiv` divides
  by a tensor on the same device instead.
* CPU ``sqrt`` on float32 goes through a vector math library that is not
  correctly rounded (about 0.5% of inputs come out one ulp off).
  :func:`sqrt_rn` takes the root in float64 and rounds once to float32,
  which is the correctly rounded float32 root.
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (length 3), summed ``x + y + z``:
    the order in which XLA reduces three terms."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fdiv(a, b):
    """IEEE ``a / b`` where either side may be a Python number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b
