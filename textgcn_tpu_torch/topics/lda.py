"""Latent Dirichlet Allocation inference: the variational E-step on a device.

Port of the inference side of ``textgcn_tpu/topics/lda.py``
(``_dirichlet_expectation_exp``, ``_e_step``, ``LDA.transform``)::

  Eb      = exp(E[log beta])  = exp(psi(lambda) - psi(sum_w lambda))   [K,V]
  Eg      = exp(E[log theta]) = exp(psi(gamma)  - psi(sum_k gamma))    [D,K]
  phinorm = Eg @ Eb                                                    [D,V]
  gamma  <- alpha + Eg * ((X / phinorm) @ Eb^T)      (iterated)

Two matmuls an iteration, in f32 (``torch.digamma`` for psi). To give the
JAX package's theta, the port keeps its choices: documents go in uint16
chunks of ``chunk_size`` rows padded with zero rows; each chunk's starting
gamma is drawn from ``np.random.RandomState(random_state).gamma(100, 0.01,
(chunk_size, K))``, padded rows included, one draw a chunk in order; a chunk
stops iterating when the largest per-row mean |Δγ| over the whole chunk is
at most ``mean_change_tol``, or after ``max_doc_update_iter`` iterations;
alpha = 1/K. Matmuls must run in full f32 (PyTorch's default: no TF32).

``fit`` (variational EM) is not ported: the topic model comes from the build
stage's pickle (:class:`~textgcn_tpu_torch.topics.model.TopicModel`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch


def _dirichlet_expectation_exp(alpha: torch.Tensor) -> torch.Tensor:
    """exp(psi(alpha) - psi(sum(alpha, -1)))."""
    return torch.exp(
        torch.digamma(alpha) - torch.digamma(alpha.sum(dim=-1, keepdim=True))
    )


def _e_step(
    x: torch.Tensor,  # [B, V] counts (padded docs are all-zero rows)
    gamma0: torch.Tensor,  # [B, K] starting gamma
    exp_elog_beta: torch.Tensor,  # [K, V]
    alpha: float,
    max_iters: int = 100,
    tol: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterate gamma to convergence; return (gamma, sstats, word_bound).

    A Python loop of at most ``max_iters`` iterations; the change test is
    reduced on the device and read once an iteration. ``word_bound`` is the
    chunk's ELBO word term ``sum_dw x_dw log(phinorm_dw)``, ``sstats`` the
    M-step's statistics.
    """
    x = x.to(torch.float32)
    gamma = gamma0
    for _ in range(max_iters):
        eg = _dirichlet_expectation_exp(gamma)
        phinorm = eg @ exp_elog_beta
        # the 1e-100 guard rounds to 0 in f32, as in the JAX package
        ratio = x / (phinorm + 1e-100)
        new_gamma = alpha + eg * (ratio @ exp_elog_beta.T)
        change = (new_gamma - gamma).abs().mean(dim=-1).max()
        gamma = new_gamma
        if not bool(change > tol):
            break
    eg = _dirichlet_expectation_exp(gamma)
    phinorm = eg @ exp_elog_beta
    ratio = x / (phinorm + 1e-100)
    sstats = eg.T @ ratio
    word_bound = (x * torch.log(phinorm + 1e-100)).sum()
    return gamma, sstats, word_bound


class LDA:
    """Batch variational-Bayes LDA, inference only: ``components_`` [K, V]
    (lambda) is set by the caller, as :meth:`TopicModel.load` does."""

    def __init__(
        self,
        n_components: int = 50,
        random_state: int = 42,
        chunk_size: int = 2048,
        mean_change_tol: float = 1e-3,
        max_doc_update_iter: int = 100,
    ):
        self.n_components = int(n_components)
        self.random_state = int(random_state)
        self.chunk_size = int(chunk_size)
        self.mean_change_tol = float(mean_change_tol)
        self.max_doc_update_iter = int(max_doc_update_iter)
        self.components_: Optional[np.ndarray] = None  # [K, V] lambda

    def _chunks(self, x: sp.csr_matrix):
        # uint16 counts: exact (per-doc word counts never approach 65535)
        n = x.shape[0]
        for lo in range(0, n, self.chunk_size):
            hi = min(lo + self.chunk_size, n)
            chunk = np.zeros((self.chunk_size, x.shape[1]), dtype=np.uint16)
            chunk[: hi - lo] = x[lo:hi].toarray()
            yield lo, hi, chunk

    def transform(self, x: sp.csr_matrix, *, device) -> np.ndarray:
        """Normalized doc-topic distributions theta [D, K] (float32), the
        E-step run on ``device``."""
        if self.components_ is None:
            raise ValueError("LDA has no components")
        x = sp.csr_matrix(x)
        alpha = np.float32(1.0 / self.n_components)  # the JAX package's prior
        rs = np.random.RandomState(self.random_state)
        exp_elog_beta = _dirichlet_expectation_exp(
            torch.tensor(np.asarray(self.components_), dtype=torch.float32, device=device)
        )
        out = np.zeros((x.shape[0], self.n_components), dtype=np.float32)
        for lo, hi, chunk in self._chunks(x):
            gamma0 = rs.gamma(100.0, 0.01, (chunk.shape[0], self.n_components))
            gamma, _, _ = _e_step(
                torch.from_numpy(chunk).to(device),
                torch.from_numpy(gamma0.astype(np.float32)).to(device),
                exp_elog_beta,
                float(alpha),
                max_iters=self.max_doc_update_iter,
                tol=self.mean_change_tol,
            )
            g = gamma[: hi - lo].cpu().numpy()
            out[lo:hi] = g / g.sum(axis=1, keepdims=True)
        return out
