"""Float-to-int32 casts, and squared norms, that give what the JAX
package's give.

XLA's float32-to-int32 conversion saturates at the int32 range and takes NaN
to 0; torch's gives INT_MIN for NaN and for values beyond the range on the
CPU (ROADMAP C71). Where the JAX package casts a value that NaN or an
out-of-range float can reach, the port casts through :func:`xla_int32`.
"""

from __future__ import annotations

import torch

from pcl_tpu_torch.ops.nn1 import _fma32

_INT32_MIN = -2147483648.0
_INT32_MAX = 2147483647.0


def xla_int32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` as XLA computes it: truncation toward zero, NaN to
    0, values beyond the int32 range to its ends. The clamp runs in float64,
    where both ends are exact."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return torch.clamp(x, _INT32_MIN, _INT32_MAX).to(torch.int32)


def sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """``v0 v0 + v1 v1 + v2 v2`` over the last axis as ``fma(v2, v2, fma(v1,
    v1, v0 v0))`` in float32."""
    return _fma32(v[..., 2], v[..., 2], _fma32(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))


def norm3(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)`` over three coordinates, as XLA's CPU
    code forms it."""
    return torch.sqrt(sq_norm3(v).to(torch.float64)).to(torch.float32)
