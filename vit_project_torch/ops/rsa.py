"""Behavioral RSA: RDM construction + Spearman rho with tie handling
(counterpart of the JAX package's ops/rsa.py).

The reference computes this on the host every epoch with numpy + scipy
(behavioral_RSA, new_cvpr_train_behavior_things_pipeline.py:605-654): RDM =
1 - corrcoef(embeddings) with zeroed diagonal, then Spearman rho between the
strict upper triangles of the model RDM and the human triplet RDM.

rho is computed in torch on the embeddings' device: average ranks by one
O(n^2) pairwise comparison (n = 1128 values for a 48x48 RDM), then Pearson
on the ranks. The two-sided p-value uses scipy.stats.spearmanr's
t-distribution approximation through ``scipy.special.betainc`` on the host
(torch has no incomplete beta function).
"""
from __future__ import annotations

import torch


def rdm_from_embeddings(emb: torch.Tensor) -> torch.Tensor:
    """1 - corrcoef over rows of [N, F] embeddings, diagonal zeroed (f32)."""
    emb = emb.float()
    xc = emb - emb.mean(dim=1, keepdim=True)
    cov = torch.matmul(xc, xc.t())
    d = torch.sqrt(torch.diagonal(cov))
    corr = cov / (d[:, None] * d[None, :])
    n = corr.shape[0]
    return (1.0 - corr) * (1.0 - torch.eye(n, dtype=corr.dtype,
                                           device=corr.device))


def upper_tri(x: torch.Tensor) -> torch.Tensor:
    """Strict upper triangle of a square [N, N] matrix in row-major order
    (np.triu_indices_from(k=1) order)."""
    n = x.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    return x[iu[0], iu[1]]


def rankdata_average(a: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based) with ties, as scipy.stats.rankdata:
    rank_i = #(a_j < a_i) + (#(a_j == a_i) + 1) / 2."""
    a = a.float()
    less = (a[None, :] < a[:, None]).sum(dim=1).float()
    equal = (a[None, :] == a[:, None]).sum(dim=1).float()
    return less + (equal + 1.0) * 0.5


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean()
    yc = y - y.mean()
    return (xc * yc).sum() / torch.sqrt((xc * xc).sum() * (yc * yc).sum())


def spearman_pvalue(rho: float, n: int) -> float:
    """Two-sided p of Spearman's rho over n pairs (scipy's approximation):
    p = betainc(df/2, 1/2, df / (df + t^2)), t^2 = rho^2 df / (1 - rho^2)."""
    from scipy.special import betainc
    if abs(rho) >= 1.0:
        return 0.0
    df = n - 2
    t2 = rho * rho * df / max(1.0 - rho * rho, 1e-12)
    return float(betainc(df / 2.0, 0.5, df / (df + t2)))


def spearman(x: torch.Tensor, y: torch.Tensor) -> tuple[float, float]:
    """Spearman rho (in torch) and its two-sided p-value."""
    rho = float(_pearson(rankdata_average(x), rankdata_average(y)))
    return rho, spearman_pvalue(rho, x.shape[0])


def behavioral_rsa(embeddings: torch.Tensor, reference_rdm: torch.Tensor):
    """The per-epoch RSA: embeddings [48, 66] model predictions on the
    held-out THINGS images (in the reference-RDM row order) against the
    [48, 48] human triplet RDM. Returns (rho, p_value, model_rdm)."""
    model_rdm = rdm_from_embeddings(embeddings)
    ref = torch.as_tensor(reference_rdm, dtype=torch.float32,
                          device=model_rdm.device)
    rho, p = spearman(upper_tri(ref), upper_tri(model_rdm))
    return rho, p, model_rdm
