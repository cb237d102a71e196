"""Batched 3x3 linear algebra on ``[N, 3, 3]`` matrices and ``[N, 3]`` vectors.

Counterpart of ``pcl_tpu/ops/batch33.py``, which keeps a batch of matrices as
``[9, N]`` (entries on the major axis, the batch in the lanes) because a
``[N, 3, 3]`` array pads every matrix to a whole tile on the TPU. That lane
form is a TPU layout: here a batch is an ordinary ``[N, 3, 3]`` tensor, and
the functions keep the JAX package's names and results. ``to_lanes`` and
``from_lanes`` (and the two for vectors) convert between the two layouts, for
state that arrives in lane form.

``inv`` is the closed-form adjugate inverse with the determinant clamped at
``eps``, never ``torch.linalg.inv``: the closed form is the contract (a
singular matrix gives large finite entries, not an error), and a batched LU of
a hundred thousand 3x3 matrices is slow on the card.
"""

from __future__ import annotations

import torch

from pcl_tpu_torch.core.geometry import _cross


def to_lanes(C: torch.Tensor) -> torch.Tensor:
    """``[N, 3, 3] -> [9, N]`` (row-major entries major, batch minor)."""
    return C.reshape(C.shape[0], 9).T


def from_lanes(L: torch.Tensor) -> torch.Tensor:
    """``[9, N] -> [N, 3, 3]``."""
    return L.T.reshape(L.shape[1], 3, 3)


def vec_to_lanes(v: torch.Tensor) -> torch.Tensor:
    """``[N, 3] -> [3, N]``."""
    return v.T


def vec_from_lanes(V: torch.Tensor) -> torch.Tensor:
    """``[3, N] -> [N, 3]``."""
    return V.T


def matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-matrix product ``[N, 3, 3] @ [N, 3, k] -> [N, 3, k]``."""
    return torch.matmul(A, B)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[N, 3, 3] x [N, 3] -> [N, 3]``."""
    return torch.einsum("nij,nj->ni", A, x)


def transpose(A: torch.Tensor) -> torch.Tensor:
    """Per-matrix transpose."""
    return A.transpose(-1, -2)


def sandwich(R: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``R C R^T`` with one ``[3, 3]`` ``R`` for every ``C [N, 3, 3]``: the
    rotated source covariance of GICP."""
    return torch.einsum("ia,nab,jb->nij", R, C, R)


def add_scaled_identity(C: torch.Tensor, s) -> torch.Tensor:
    """``C + s I`` per matrix."""
    return C + s * torch.eye(3, dtype=C.dtype, device=C.device)


def det(A: torch.Tensor) -> torch.Tensor:
    """``[N, 3, 3] -> [N]`` determinants (first row against the cross
    product of the other two)."""
    return torch.sum(A[..., 0, :] * _cross(A[..., 1, :], A[..., 2, :]), dim=-1)


def inv(A: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Closed-form adjugate inverse ``[N, 3, 3] -> [N, 3, 3]``: the columns
    are the cross products of the rows over the determinant, whose magnitude
    is clamped at ``eps`` (its sign kept, ``+eps`` at 0)."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0 = _cross(r1, r2)
    d = torch.sum(r0 * c0, dim=-1)
    d = torch.where(torch.abs(d) > eps, d, torch.where(d >= 0, eps, -eps))
    adj = torch.stack([c0, _cross(r2, r0), _cross(r0, r1)], dim=-1)
    return adj * (1.0 / d)[..., None, None]


def quadform(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x^T M x`` per matrix: ``[N, 3, 3], [N, 3] -> [N]``."""
    return torch.sum(x * matvec(M, x), dim=-1)


def scale(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-matrix scalar: ``[N, 3, 3] * [N] -> [N, 3, 3]``."""
    return A * w[:, None, None]


def gather(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[N, 3, 3], [Q] int -> [Q, 3, 3]`` (``A[idx]``)."""
    return A[idx.long()]
