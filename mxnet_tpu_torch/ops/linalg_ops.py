"""Linear-algebra operators.

Counterpart of `mxnet_tpu/ops/linalg_ops.py` (reference
`src/operator/tensor/la_op.cc`, the ``_linalg_*`` family): ``gemm``,
``gemm2``, ``potrf``, ``potri``, ``trsm``, ``trmm``, ``sumlogdiag``,
``syrk``, ``gelqf``, ``syevd``, ``inverse`` and ``det``, each also under
its ``linalg_*`` alias. The JAX package leaves them to XLA's linear
algebra; here they are ``torch.matmul`` and ``torch.linalg``, batched
over the leading axes, and their gradients come from the tape as the JAX
package's come from autodiff.

Where the libraries differ the JAX semantics hold:

- ``potrf`` and ``syevd`` read the symmetrised input ``(A + Aᵀ) / 2``, as
  ``jnp.linalg.cholesky`` and ``eigh`` do, so both triangles take part and
  the gradient is symmetric.
- ``potrf`` of a matrix that is not positive definite gives NaN in the
  lower triangle of that batch entry and does not raise (``cholesky_ex``
  reports it on the device).
- ``gelqf`` makes the diagonal of L non-negative, ``syevd`` returns
  ``(Vᵀ, w)``: the rows are the eigenvectors, eigenvalues ascending.
- ``potri``, ``trsm`` read only the triangle ``lower`` names.

``syevd``, ``inverse`` and ``det`` go through solvers of the card's
linear-algebra libraries that read their status back on the host
(``eigh`` fails inside a CUDA graph capture); on a CUDA tensor they call
`compiled.note_host_op`, so a hybridized program holding one runs
uncaptured instead of failing. The products, ``cholesky_ex``, ``qr`` and
the triangular solves capture.
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


def _solver(name, x):
    """Mark a call of a solver on a CUDA tensor (see the module
    docstring)."""
    if x.is_cuda:
        from .. import compiled
        compiled.note_host_op(name)


def _sym(a):
    return (a + _t(a)) / 2


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _gemm(params, A, B, C):
    """alpha * op(A) op(B) + beta * C."""
    a = _t(A) if params.get("transpose_a", False) else A
    b = _t(B) if params.get("transpose_b", False) else B
    return (params.get("alpha", 1.0) * torch.matmul(a, b)
            + params.get("beta", 1.0) * C,)


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _gemm2(params, A, B):
    """alpha * op(A) op(B)."""
    a = _t(A) if params.get("transpose_a", False) else A
    b = _t(B) if params.get("transpose_b", False) else B
    return (params.get("alpha", 1.0) * torch.matmul(a, b),)


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _potrf(params, A):
    """The Cholesky factor (lower, or its transpose with ``lower=False``);
    NaN where the matrix is not positive definite."""
    L, info = torch.linalg.cholesky_ex(_sym(A))
    bad = (info != 0)[..., None, None]
    L = torch.where(bad, torch.full((), float("nan"), dtype=L.dtype,
                                    device=L.device), L).tril()
    if not params.get("lower", True):
        L = _t(L)
    return (L,)


@register("_linalg_potri", aliases=("linalg_potri",))
def _potri(params, A):
    """The inverse of a symmetric positive-definite matrix from its
    Cholesky factor ``A``."""
    lower = params.get("lower", True)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    inv = torch.linalg.solve_triangular(A, eye, upper=not lower, left=True)
    if lower:
        return (torch.matmul(_t(inv), inv),)
    return (torch.matmul(inv, _t(inv)),)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _trsm(params, A, B):
    """X with op(A) X = alpha B (X op(A) = alpha B with ``rightside``),
    op(A) = Aᵀ with ``transpose``; A triangular."""
    lower = params.get("lower", True)
    a, upper = A, not lower
    if params.get("transpose", False):
        a, upper = _t(A), lower
    return (torch.linalg.solve_triangular(
        a, params.get("alpha", 1.0) * B, upper=upper,
        left=not params.get("rightside", False)),)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def _trmm(params, A, B):
    """alpha op(tri(A)) B, or alpha B op(tri(A)) with ``rightside``."""
    alpha = params.get("alpha", 1.0)
    tri = torch.tril(A) if params.get("lower", True) else torch.triu(A)
    if params.get("transpose", False):
        tri = _t(tri)
    if params.get("rightside", False):
        return (alpha * torch.matmul(B, tri),)
    return (alpha * torch.matmul(tri, B),)


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _sumlogdiag(params, A):
    return (torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1),)


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _syrk(params, A):
    """alpha A Aᵀ, or alpha Aᵀ A with ``transpose``."""
    alpha = params.get("alpha", 1.0)
    if params.get("transpose", False):
        return (alpha * torch.matmul(_t(A), A),)
    return (alpha * torch.matmul(A, _t(A)),)


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def _gelqf(params, A):
    """The LQ factorisation A = L Q of an m x n matrix, m <= n, with the
    diagonal of L non-negative."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    L, Q = _t(r), _t(q)
    d = torch.sign(torch.diagonal(L, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones((), dtype=d.dtype, device=d.device),
                    d)
    return (L * d[..., None, :], Q * d[..., :, None])


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def _syevd(params, A):
    """(Vᵀ, w) of a symmetric matrix: the eigenvectors as rows, the
    eigenvalues ascending."""
    _solver("_linalg_syevd", A)
    w, v = torch.linalg.eigh(_sym(A))
    return (_t(v), w)


@register("_linalg_inverse", aliases=("linalg_inverse",))
def _inverse(params, A):
    _solver("_linalg_inverse", A)
    return (torch.linalg.inv_ex(A).inverse,)


@register("_linalg_det", aliases=("linalg_det",))
def _det(params, A):
    _solver("_linalg_det", A)
    return (torch.linalg.det(A),)
