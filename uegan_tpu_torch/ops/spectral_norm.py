"""Spectral normalization over explicit (u, v) buffers, counterpart of
uegan_tpu/ops/spectral_norm.py.

The reference wraps D's convs in ``torch.nn.utils.spectral_norm`` (one power
iteration per train-mode forward, eps 1e-12; reference models.py:185-188).
The JAX package runs the power iteration functionally so that several
branches of one fused D forward see the sigmas of sequential forwards
(``spectral_sigmas``).  ``torch.nn.utils.spectral_norm`` on one batched
forward would step u and v once for all branches, so the port keeps the
JAX form: u and v are buffers the caller updates, and they carry no
gradient; sigma = u^T W v differentiates through W only.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def kernel_to_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (out, in*kh*kw) float32 matrix, torch's flatten order."""
    return weight.float().reshape(weight.shape[0], -1)


def init_uv(weight_shape, generator: torch.Generator, device=None) -> Tuple[torch.Tensor,
                                                                             torch.Tensor]:
    """Random normalized u (out,) and v (in*kh*kw,), as torch draws them when
    it wraps a module."""
    cout = weight_shape[0]
    rest = 1
    for d in weight_shape[1:]:
        rest *= d
    u = _l2normalize(torch.randn(cout, generator=generator))
    v = _l2normalize(torch.randn(rest, generator=generator))
    return u.to(device), v.to(device)


def spectral_sigmas(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor, n: int,
                    update: bool = True, eps: float = 1e-12):
    """The sigmas of ``n`` sequential train-mode forwards: forward i
    normalizes by the estimate after i power iterations.  Returns (sigmas
    (n,) float32, u_n, v_n); u and v carry no gradient, each sigma
    differentiates through ``weight``."""
    w_mat = kernel_to_matrix(weight)
    sigmas = []
    uu, vv = u, v
    for _ in range(n):
        if update:
            with torch.no_grad():
                vv = _l2normalize(w_mat.T @ uu, eps)
                uu = _l2normalize(w_mat @ vv, eps)
        sigmas.append(torch.dot(uu, w_mat @ vv))
    return torch.stack(sigmas), uu, vv


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       update: bool = True, eps: float = 1e-12):
    """``weight`` / sigma after one power iteration (``update``; train-mode
    torch) or with the stored u, v (eval mode).  Returns (normalized weight,
    u, v)."""
    sig, u1, v1 = spectral_sigmas(weight, u, v, 1, update, eps)
    return weight / sig[0].to(weight.dtype), u1, v1
