"""Spectral normalization by power iteration.

Counterpart of ``twingan_tpu/ops/sn.py``. The layer keeps a persistent
``u`` vector of shape ``(out_features,)`` and passes it in; one power
iteration always runs, and the caller stores the new ``u`` only in the
passes that update state (the JAX package's ``spectral`` collection is
written only when it is mutable).

Gradients follow the JAX package, which diverges from its TF original on
purpose: u and v carry no gradient, and sigma = v'Wu is taken on the live
weight, so d(W / sigma)/dW carries the -(v u') W / sigma^2 term of the
Miyato formulation and no iteration-path terms.

The weight is a matrix [in, out] here, as in the JAX package's
``reshape(-1, out)`` of an HWIO kernel; ``spectral_normalize`` takes the
port's layouts (an OIHW conv kernel, or a dense [in, out] kernel) and
gives the same sigma: the order of the rows of W does not change it.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(torch.square(v)) + _EPS)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor,
                    num_iters: int = 1) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_iters`` rounds of power iteration on a [in, out] matrix from
    ``u`` [out]. Returns (sigma, new_u, v): u and v without gradient,
    sigma = v' W u on the live ``w_mat``."""
    with torch.no_grad():
        w_stop = w_mat.detach()
        v = None
        for _ in range(num_iters):
            v = _l2norm(w_stop @ u)  # [in]
            u = _l2norm(v @ w_stop)  # [out]
    sigma = torch.einsum("i,io,o->", v, w_mat, u)
    return sigma, u, v


def as_matrix(w: torch.Tensor) -> torch.Tensor:
    """The [in, out] matrix of a port weight: an OIHW conv kernel becomes
    [I*H*W, O]; a 2-d dense kernel is [in, out] already."""
    if w.dim() == 2:
        return w
    return w.reshape(w.shape[0], -1).t()


def spectral_normalize(w: torch.Tensor, u: torch.Tensor,
                       num_iters: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma, new_u) for a port weight (OIHW conv or [in, out] dense
    kernel) and its ``u`` [out]; the caller decides whether to store
    new_u."""
    sigma, new_u, _ = power_iteration(as_matrix(w).float(), u, num_iters)
    return w / torch.clamp(sigma, min=_EPS).to(w.dtype), new_u
