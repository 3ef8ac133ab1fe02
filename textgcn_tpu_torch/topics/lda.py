"""Latent Dirichlet Allocation by batch variational Bayes, on a device.

Port of ``textgcn_tpu/topics/lda.py`` (``_dirichlet_expectation_exp``,
``_e_step``, ``LDA.fit``, ``transform`` and ``perplexity``)::

  Eb      = exp(E[log beta])  = exp(psi(lambda) - psi(sum_w lambda))   [K,V]
  Eg      = exp(E[log theta]) = exp(psi(gamma)  - psi(sum_k gamma))    [D,K]
  phinorm = Eg @ Eb                                                    [D,V]
  gamma  <- alpha + Eg * ((X / phinorm) @ Eb^T)      (E-step, iterated)
  lambda <- eta + Eb * (Eg^T @ (X / phinorm))        (M-step)

Two matmuls an E-step iteration and one for the M-step's statistics, in
full f32 (``torch.digamma`` for psi): every entry point runs its products
under ``torch.set_float32_matmul_precision("highest")`` and restores the
caller's setting after, so TF32 never rounds them. To give the JAX
package's lambda and theta, the port keeps its choices:

- the priors: alpha = eta = 1/K unless given;
- documents go in uint16 chunks of ``chunk_size`` rows padded with zero
  rows; ``fit`` keeps the chunks on the device for the whole fit while the
  densified corpus (2·D·V bytes) is at most ``pin_bytes_limit``, and
  uploads them again on every EM iteration above it;
- every random draw comes from ``np.random.RandomState(random_state)``, in
  the JAX package's order: ``fit`` draws lambda ``gamma(100, 0.01, (K, V))``,
  then one starting gamma ``gamma(100, 0.01, (chunk_size, K))`` a chunk (padded
  rows included) in chunk order on every EM iteration; ``transform`` and
  ``perplexity`` start a fresh stream and draw one a chunk;
- a chunk's E-step stops when the largest per-row mean |Δγ| over the whole
  chunk is at most ``mean_change_tol``, or after ``max_doc_update_iter``
  iterations (a Python loop that reads the change test once an iteration);
- ``sstats`` and the word bound are summed over chunks in f32 on the device;
  the per-word bound of each EM iteration (at the pre-update beta) goes into
  ``bound_trace_``, and ``fit`` stops once its mean gain over the last
  ``bound_window`` iterations is below ``bound_tol``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run the block's f32 matmuls in full f32 (no TF32), then restore the
    caller's setting."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)


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
    iters: Optional[List[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterate gamma to convergence; return (gamma, sstats, word_bound).

    A Python loop of at most ``max_iters`` iterations; the change test is
    reduced on the device and read once an iteration. ``word_bound`` is the
    chunk's ELBO word term ``sum_dw x_dw log(phinorm_dw)``, ``sstats`` the
    M-step's statistics. The number of iterations run is appended to
    ``iters`` when one is given.
    """
    x = x.to(torch.float32)
    gamma = gamma0
    n = 0
    for n in range(1, max_iters + 1):
        eg = _dirichlet_expectation_exp(gamma)
        phinorm = eg @ exp_elog_beta
        # the 1e-100 guard rounds to 0 in f32, as in the JAX package
        ratio = x / (phinorm + 1e-100)
        new_gamma = alpha + eg * (ratio @ exp_elog_beta.T)
        change = (new_gamma - gamma).abs().mean(dim=-1).max()
        gamma = new_gamma
        if not bool(change > tol):
            break
    if iters is not None:
        iters.append(n)
    eg = _dirichlet_expectation_exp(gamma)
    phinorm = eg @ exp_elog_beta
    ratio = x / (phinorm + 1e-100)
    sstats = eg.T @ ratio
    word_bound = (x * torch.log(phinorm + 1e-100)).sum()
    return gamma, sstats, word_bound


class _Stream:
    """Re-iterable chunk uploads: every pass copies each chunk to the device
    again, so the device holds one chunk at a time."""

    def __init__(self, lda: "LDA", x: sp.csr_matrix, device):
        self.lda, self.x, self.device = lda, x, device

    def __iter__(self):
        for lo, hi, chunk in self.lda._chunks(self.x):
            yield lo, hi, torch.from_numpy(chunk).to(self.device)


class LDA:
    """Batch variational-Bayes LDA (the JAX package's defaults).

    ``fit`` sets ``components_`` [K, V] (lambda), ``bound_trace_`` (the
    per-word bound of each EM iteration; perplexity = exp(-bound)),
    ``n_iter_`` and ``e_step_iters_`` (the E-step iterations of each chunk of
    each EM iteration, in order). :meth:`TopicModel.load` sets
    ``components_`` from the build stage's pickle instead.
    """

    def __init__(
        self,
        n_components: int = 50,
        max_iter: int = 20,
        doc_topic_prior: Optional[float] = None,
        topic_word_prior: Optional[float] = None,
        random_state: int = 42,
        chunk_size: int = 2048,
        mean_change_tol: float = 1e-3,
        max_doc_update_iter: int = 100,
        verbose: bool = False,
        pin_bytes_limit: int = 2 << 30,
        bound_tol: float = 2e-5,
        bound_window: int = 5,
    ):
        self.n_components = int(n_components)
        self.max_iter = int(max_iter)
        self.doc_topic_prior = doc_topic_prior
        self.topic_word_prior = topic_word_prior
        self.random_state = int(random_state)
        self.chunk_size = int(chunk_size)
        self.mean_change_tol = float(mean_change_tol)
        self.max_doc_update_iter = int(max_doc_update_iter)
        self.verbose = verbose
        # fit() keeps the densified corpus (uint16 D×V) on the device up to
        # this many bytes; above it, chunks are uploaded every EM iteration
        self.pin_bytes_limit = int(pin_bytes_limit)
        self.bound_tol = float(bound_tol)
        self.bound_window = int(bound_window)
        self.components_: Optional[np.ndarray] = None  # [K, V] lambda
        self.bound_trace_: List[float] = []
        self.n_iter_: int = 0
        self.e_step_iters_: List[int] = []

    def _chunks(self, x: sp.csr_matrix):
        # uint16 counts: exact (per-doc word counts never approach 65535)
        n = x.shape[0]
        for lo in range(0, n, self.chunk_size):
            hi = min(lo + self.chunk_size, n)
            chunk = np.zeros((self.chunk_size, x.shape[1]), dtype=np.uint16)
            chunk[: hi - lo] = x[lo:hi].toarray()
            yield lo, hi, chunk

    def _device_chunks(self, x: sp.csr_matrix, device):
        """The chunks for ``fit``: a list of chunks held on ``device`` for
        the whole fit while the densified corpus is at most
        ``pin_bytes_limit`` bytes, else a :class:`_Stream` that uploads them
        again on every pass."""
        if 2 * x.shape[0] * x.shape[1] <= self.pin_bytes_limit:
            return [
                (lo, hi, torch.from_numpy(chunk).to(device))
                for lo, hi, chunk in self._chunks(x)
            ]
        return _Stream(self, x, device)

    def _priors(self) -> Tuple[np.float32, np.float32]:
        k = self.n_components
        alpha = self.doc_topic_prior if self.doc_topic_prior else 1.0 / k
        eta = self.topic_word_prior if self.topic_word_prior else 1.0 / k
        return np.float32(alpha), np.float32(eta)

    def _gamma0(self, rs: np.random.RandomState, device) -> torch.Tensor:
        g = rs.gamma(100.0, 0.01, (self.chunk_size, self.n_components))
        return torch.from_numpy(g.astype(np.float32)).to(device)

    def _exp_elog_beta(self, device) -> torch.Tensor:
        if self.components_ is None:
            raise ValueError("LDA has no components")
        lam = torch.tensor(np.asarray(self.components_), dtype=torch.float32, device=device)
        return _dirichlet_expectation_exp(lam)

    def fit(self, x: sp.csr_matrix, *, device) -> "LDA":
        """Fit lambda to the document-term counts ``x`` [D, V] by batch
        VB-EM on ``device``."""
        x = sp.csr_matrix(x)
        n_words = x.shape[1]
        k = self.n_components
        alpha, eta = self._priors()
        rs = np.random.RandomState(self.random_state)
        lam0 = rs.gamma(100.0, 0.01, (k, n_words)).astype(np.float32)
        total_words = max(float(x.sum()), 1.0)
        self.bound_trace_, self.n_iter_, self.e_step_iters_ = [], 0, []
        with full_f32():
            lam = torch.from_numpy(lam0).to(device)
            chunks = self._device_chunks(x, device)
            for it in range(self.max_iter):
                exp_elog_beta = _dirichlet_expectation_exp(lam)
                sstats = torch.zeros((k, n_words), dtype=torch.float32, device=device)
                bound = torch.zeros((), dtype=torch.float32, device=device)
                for _, _, chunk in chunks:
                    _, s, wb = _e_step(
                        chunk, self._gamma0(rs, device), exp_elog_beta, float(alpha),
                        max_iters=self.max_doc_update_iter, tol=self.mean_change_tol,
                        iters=self.e_step_iters_,
                    )
                    sstats += s
                    bound += wb
                lam = float(eta) + exp_elog_beta * sstats
                self.n_iter_ = it + 1
                # the per-word word term of the bound at the pre-update beta:
                # EM never lowers it, so a plateau is convergence
                b = float(bound) / total_words
                self.bound_trace_.append(b)
                if self.verbose:
                    print(f"LDA EM iteration {it + 1}/{self.max_iter} per-word bound "
                          f"{b:.6f} (perplexity {np.exp(-b):.1f})")
                wnd = self.bound_window
                if (
                    self.bound_tol > 0
                    and len(self.bound_trace_) >= wnd + 1
                    and (self.bound_trace_[-1] - self.bound_trace_[-1 - wnd]) / wnd
                    < self.bound_tol
                ):
                    if self.verbose:
                        print(f"LDA EM converged at iteration {it + 1} (mean Δbound/word "
                              f"over {wnd} iters < {self.bound_tol})")
                    break
            self.components_ = lam.cpu().numpy()
        return self

    def transform(self, x: sp.csr_matrix, *, device) -> np.ndarray:
        """Normalized doc-topic distributions theta [D, K] (float32), the
        E-step run on ``device``."""
        x = sp.csr_matrix(x)
        alpha, _ = self._priors()
        rs = np.random.RandomState(self.random_state)
        out = np.zeros((x.shape[0], self.n_components), dtype=np.float32)
        with full_f32():
            exp_elog_beta = self._exp_elog_beta(device)
            for lo, hi, chunk in self._chunks(x):
                gamma, _, _ = _e_step(
                    torch.from_numpy(chunk).to(device),
                    self._gamma0(rs, device),
                    exp_elog_beta,
                    float(alpha),
                    max_iters=self.max_doc_update_iter,
                    tol=self.mean_change_tol,
                )
                g = gamma[: hi - lo].cpu().numpy()
                out[lo:hi] = g / g.sum(axis=1, keepdims=True)
        return out

    def perplexity(self, x: sp.csr_matrix, *, device) -> float:
        """Word perplexity bound proxy: exp(-sum log phinorm / total words),
        each chunk's E-step at the default limits (100 iterations, tol
        1e-3), as in the JAX package."""
        x = sp.csr_matrix(x)
        alpha, _ = self._priors()
        rs = np.random.RandomState(self.random_state)
        total = 0.0
        with full_f32():
            exp_elog_beta = self._exp_elog_beta(device)
            for _, _, chunk in self._chunks(x):
                _, _, wb = _e_step(
                    torch.from_numpy(chunk).to(device),
                    self._gamma0(rs, device),
                    exp_elog_beta,
                    float(alpha),
                )
                total += float(wb)
        return float(np.exp(-total / max(float(x.sum()), 1.0)))
