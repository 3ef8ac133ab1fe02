"""Word2Vec (CBOW with negative sampling), trained on a device.

Port of ``textgcn_tpu/topics/word2vec.py``:

- host side, numpy, the same code: the vocabulary (``min_count``; sorted by
  count, then word), gensim's ``sample`` keep-probability, the token → id
  encoding done once a fit, and each epoch's (center, padded context, mask)
  examples with the subsampling and window reductions drawn anew;
- device side, :func:`_cbow_step`: embedding gathers, the context mean,
  sigmoid scores against the center and ``negative`` sampled words, and SGD
  at a learning rate that falls linearly from ``alpha`` to ``min_alpha``.
  Every gradient is formed from the pre-step ``w_in`` / ``w_out`` and then
  scatter-added, duplicate indices summed, as JAX's ``.at[].add`` does.

Every draw comes from one ``np.random.RandomState(seed)`` in the JAX
package's order: the ``w_in`` init, each epoch's examples, its permutation,
then the negatives of each step. Between the permutation and the epoch's
end the negatives are the only draws, so the port draws an epoch's
negatives in one call (numpy gives the same values as one call a step) and
uploads the epoch's batches once. The last batch of an epoch is padded to
``batch_size`` by wrapping around (``np.resize``).

The scatter-adds take :func:`textgcn_tpu_torch.ops.scatter.add_rows_`,
each device's deterministic PyTorch op, so a fit from a seed gives the same
bits every time.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from textgcn_tpu_torch.ops.scatter import add_rows_


def _cbow_step(
    w_in: torch.Tensor,  # [V, D] input (context) embeddings, updated in place
    w_out: torch.Tensor,  # [V, D] output (center) embeddings, updated in place
    centers: torch.Tensor,  # [B] int64
    contexts: torch.Tensor,  # [B, C] int64 (padded)
    ctx_mask: torch.Tensor,  # [B, C] float32
    negatives: torch.Tensor,  # [B, N] int64
    lr: float,
) -> torch.Tensor:
    """One SGD step on a batch; returns the batch's loss (a device scalar)."""
    ctx_vecs = w_in[contexts]  # [B, C, D]
    denom = ctx_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    h = (ctx_vecs * ctx_mask[:, :, None]).sum(dim=1) / denom  # [B, D]

    tgt = torch.cat([centers[:, None], negatives], dim=1)  # [B, 1+N]
    lbl = torch.zeros(tgt.shape, dtype=torch.float32, device=tgt.device)
    lbl[:, 0] = 1.0
    tvecs = w_out[tgt]  # [B, 1+N, D]
    score = torch.einsum("bd,bnd->bn", h, tvecs)
    gscore = torch.sigmoid(score) - lbl  # d loss / d score

    gh = torch.einsum("bn,bnd->bd", gscore, tvecs)  # [B, D]
    gt = gscore[:, :, None] * h[:, None, :]  # [B, 1+N, D]
    gctx = (gh / denom)[:, None, :] * ctx_mask[:, :, None]  # [B, C, D]
    d = w_in.shape[1]
    add_rows_(w_out, tgt.reshape(-1), (-lr * gt).reshape(-1, d))
    # the padded context slots (index 0, mask 0) add signed zeros, which
    # change no value: leave them out, or CUDA's sorted scatter walks tens
    # of thousands of them in one run
    real = ctx_mask.reshape(-1) > 0
    add_rows_(w_in, contexts.reshape(-1)[real], (-lr * gctx).reshape(-1, d)[real])
    return torch.where(lbl > 0, -F.logsigmoid(score), -F.logsigmoid(-score)).sum()


class Word2Vec:
    """CBOW negative-sampling word2vec with a gensim-like surface."""

    def __init__(
        self,
        vector_size: int = 100,
        window: int = 5,
        min_count: int = 2,
        negative: int = 5,
        ns_exponent: float = 0.75,
        sample: float = 1e-3,
        alpha: float = 0.025,
        min_alpha: float = 1e-4,
        epochs: int = 10,
        batch_size: int = 4096,
        seed: int = 1,
    ):
        self.vector_size = vector_size
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.ns_exponent = ns_exponent
        self.sample = sample
        self.alpha = alpha
        self.min_alpha = min_alpha
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.vocab: Dict[str, int] = {}
        self.index_to_key: List[str] = []
        self.vectors: Optional[np.ndarray] = None
        self.steps_: int = 0

    # -- host-side preprocessing (numpy, as the JAX package) --------------
    def _build_vocab(self, sentences: Sequence[List[str]]):
        counts: Counter = Counter()
        for s in sentences:
            counts.update(s)
        items = sorted(
            ((w, c) for w, c in counts.items() if c >= self.min_count),
            key=lambda wc: (-wc[1], wc[0]),
        )
        self.index_to_key = [w for w, _ in items]
        self.vocab = {w: i for i, w in enumerate(self.index_to_key)}
        self.counts = np.asarray([c for _, c in items], dtype=np.float64)

    def _subsample_probs(self) -> np.ndarray:
        """Keep-probability per word (gensim's sample formula)."""
        if not self.sample:
            return np.ones_like(self.counts)
        f = self.counts / self.counts.sum()
        thr = self.sample
        keep = (np.sqrt(f / thr) + 1.0) * (thr / f)
        return np.clip(keep, 0.0, 1.0)

    def _encode(self, sentences) -> None:
        """Token → id once a fit: the flat id stream and sentence lengths."""
        ids: List[int] = []
        lens: List[int] = []
        for s in sentences:
            si = [self.vocab[w] for w in s if w in self.vocab]
            ids.extend(si)
            lens.append(len(si))
        self._corpus_ids = np.asarray(ids, dtype=np.int32)
        self._corpus_lens = np.asarray(lens, dtype=np.int64)

    def _examples(self, rng: np.random.RandomState):
        """(center, padded context, mask) arrays for the whole corpus.

        Draws the keep mask, then the window reductions ``red ~ U{1..window}``
        a kept token; contexts are the kept neighbours within ``red``
        positions inside the same sentence, padded to ``2*window`` with a
        mask; centers with no context left are dropped."""
        keep = self._subsample_probs()
        flat, lens = self._corpus_ids, self._corpus_lens
        n_sent = len(lens)
        sent_of = np.repeat(np.arange(n_sent), lens)
        kmask = rng.rand(len(flat)) < keep[flat]
        flat_k = flat[kmask]
        sent_k = sent_of[kmask]
        n = len(flat_k)
        c_max = 2 * self.window
        if n == 0:
            return (
                np.zeros(0, np.int32),
                np.zeros((0, c_max), np.int32),
                np.zeros((0, c_max), np.float32),
            )
        # kept tokens of a sentence stay contiguous, so a neighbour is a
        # global index guarded by the same-sentence bound
        klens = np.bincount(sent_k, minlength=n_sent)
        kstart = np.concatenate([[0], np.cumsum(klens)[:-1]])
        pos = np.arange(n) - kstart[sent_k]
        slen = klens[sent_k]
        red = rng.randint(1, self.window + 1, n)
        offs = np.concatenate([np.arange(-self.window, 0), np.arange(1, self.window + 1)])
        cpos = pos[:, None] + offs[None, :]
        valid = (
            (np.abs(offs)[None, :] <= red[:, None])
            & (cpos >= 0)
            & (cpos < slen[:, None])
        )
        gidx = np.clip(np.arange(n)[:, None] + offs[None, :], 0, n - 1)
        ctx = np.where(valid, flat_k[gidx], 0).astype(np.int32)
        mask = valid.astype(np.float32)
        has = valid.any(axis=1)
        return flat_k[has].astype(np.int32), ctx[has], mask[has]

    def _epoch_batches(self, rng: np.random.RandomState, n_ex: int, noise: np.ndarray):
        """One epoch's draws after its examples: the permutation, then every
        step's negatives in one call. Returns the example rows of all the
        epoch's batches in order [steps * B] (the last batch wrapped
        around) and their negatives [steps * B, N]."""
        bsz = self.batch_size
        order = rng.permutation(n_ex)
        n_steps = -(-n_ex // bsz)
        full = (n_steps - 1) * bsz
        sel = np.concatenate([order[:full], np.resize(order[full:], bsz)])
        neg = rng.choice(len(noise), size=(n_steps * bsz, self.negative), p=noise)
        return sel, neg.astype(np.int32)

    # -- training (device) -----------------------------------------------
    def fit(self, sentences: Sequence, *, device) -> "Word2Vec":
        """Train on ``sentences`` (strings or token lists) on ``device``."""
        sentences = [s.split() if isinstance(s, str) else list(s) for s in sentences]
        self._build_vocab(sentences)
        v, d = len(self.vocab), self.vector_size
        if v == 0:
            raise ValueError("empty word2vec vocabulary")
        rng = np.random.RandomState(self.seed)
        w_in0 = (rng.rand(v, d).astype(np.float32) - 0.5) / d
        w_in = torch.from_numpy(w_in0).to(device)
        w_out = torch.zeros((v, d), dtype=torch.float32, device=device)

        noise = self.counts ** self.ns_exponent
        noise = (noise / noise.sum()).astype(np.float64)

        bsz = self.batch_size
        self._encode(sentences)
        centers, ctxs, masks = self._examples(rng)
        if len(centers) == 0:
            raise ValueError("no word2vec training examples")
        # the first epoch's examples set the step count of the lr schedule
        total_steps = max(1, self.epochs * (-(-len(centers) // bsz)))
        step = 0
        for epoch in range(self.epochs):
            if epoch > 0:
                centers, ctxs, masks = self._examples(rng)
            sel, neg = self._epoch_batches(rng, len(centers), noise)
            c_dev = torch.from_numpy(centers[sel].astype(np.int64)).to(device)
            x_dev = torch.from_numpy(ctxs[sel].astype(np.int64)).to(device)
            m_dev = torch.from_numpy(masks[sel]).to(device)
            n_dev = torch.from_numpy(neg.astype(np.int64)).to(device)
            for lo in range(0, len(sel), bsz):
                frac = step / total_steps
                lr = float(np.float32(self.alpha - (self.alpha - self.min_alpha) * frac))
                _cbow_step(w_in, w_out, c_dev[lo:lo + bsz], x_dev[lo:lo + bsz],
                           m_dev[lo:lo + bsz], n_dev[lo:lo + bsz], lr)
                step += 1
        self.steps_ = step
        self.vectors = w_in.cpu().numpy()
        return self

    # -- gensim-like lookup ----------------------------------------------
    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def __getitem__(self, word: str) -> np.ndarray:
        return self.vectors[self.vocab[word]]

    def __len__(self) -> int:
        return len(self.vocab)

    def most_similar(self, word: str, topn: int = 10):
        """The ``topn`` words whose vectors have the largest cosine with
        ``word``'s (host work)."""
        v = self[word]
        sims = self.vectors @ v / (
            np.linalg.norm(self.vectors, axis=1) * np.linalg.norm(v) + 1e-12
        )
        out = []
        for i in np.argsort(-sims):
            w = self.index_to_key[i]
            if w != word:
                out.append((w, float(sims[i])))
            if len(out) >= topn:
                break
        return out
