"""Factorizations with the JAX package's failure semantics, over a stack.

``jnp.linalg.cholesky``, ``eigh`` and ``svd`` return NaN where a matrix
cannot be factored; ``torch.linalg`` raises instead (``cholesky`` on a
matrix that is not positive definite, ``eigh``/``svd`` on non-finite input
that fails to converge).  The quantization engines rely on the NaN: a bad
Gram must come out as non-finite leaves of *its* slice of a bucket, which
the health check then catches and heals, while the other slices of the
same stacked call come out exactly as they would alone.  So each function
here takes ``(..., m, n)``, factors every slice independently and gives a
failed slice NaN factors.

``trace`` sums each slice's diagonal in f64 and rounds to the input's
dtype: the same value ``torch.trace`` gives a 2-D f32 matrix on the CPU,
for a 2-D call and a stacked one alike.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def trace(H: Tensor) -> Tensor:
    """Trace of each ``(m, m)`` slice of ``H``, shape ``H.shape[:-2]``."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    # f64 as torch.trace sums a 2-D f32 matrix on the CPU (docstring)
    return d.sum(-1, dtype=torch.float64).to(H.dtype)  # reprolint: disable=DTYPE (m terms, once a site)


def _nan_where(bad: Tensor, x: Tensor) -> Tensor:
    """``x`` with the slices flagged in ``bad`` (shape ``x.shape[:k]``)
    replaced by NaN."""
    bad = bad.reshape(bad.shape + (1,) * (x.dim() - bad.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def _nonfinite(x: Tensor) -> Tensor:
    return ~torch.isfinite(x).all(dim=-1).all(dim=-1)


def cholesky(H: Tensor) -> Tensor:
    """Lower Cholesky factor of each slice; NaN where a slice is not
    positive definite or not finite."""
    L, info = torch.linalg.cholesky_ex(H)
    return _nan_where(info != 0, L)


def eigh(H: Tensor) -> tuple[Tensor, Tensor]:
    """Ascending eigenvalues and eigenvectors of each symmetric slice; NaN
    for a slice that is not finite (it is factored as the identity)."""
    bad = _nonfinite(H)
    if not bool(bad.any()):
        return torch.linalg.eigh(H)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    evals, evecs = torch.linalg.eigh(torch.where(bad[..., None, None], eye,
                                                 H))
    return _nan_where(bad, evals), _nan_where(bad, evecs)


def svd(X: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Thin SVD of each slice; NaN factors for a slice that is not finite
    (it is factored as zeros)."""
    bad = _nonfinite(X)
    if not bool(bad.any()):
        return torch.linalg.svd(X, full_matrices=False)
    U, S, Vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, X),
                                full_matrices=False)
    return _nan_where(bad, U), _nan_where(bad, S), _nan_where(bad, Vh)
