"""The plain reference: a family's training step in plain PyTorch.

It imports nothing of the program. Every propagation ``Â v`` runs over an
float32 CSR matrix rebuilt from the benchmark's own chunks (:class:`Graph`,
``torch.sparse.mm``); the backward multiplies by the explicit transpose, so
the matrix's symmetry is checked rather than assumed. Dense products run in
float32 with TF32 off. Adam is written out.

Where the configuration states a narrower dtype (``precision.low``: the
features, the first layer's weights inside its product, the operand of every
propagation and its cotangent), the values are rounded to it exactly where
the configuration says; everything else is float32. The control is the same
reference with ``low`` one step narrower (float8 for bfloat16, bfloat16
for float32).

A family module (``gpubench/reference/<family>.py``) gives
``param_shapes(cfg)``, ``loss(params, x, y, mask, ops, cfg)``,
``pass_widths(cfg)`` and ``step_work(cfg, graph)``. Under identity
features (the configuration's ``"features": "identity"``, X = I_N) ``x`` is
None and ``param_shapes`` gets the node count as ``n_feat``: the first
layer's product X W1 is its weight itself, of shape [n_nodes, hidden].
"""
from __future__ import annotations

import importlib
import warnings
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}
# the nearest precision below the stated one, for the control
NARROWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn"}


def family(name: str):
    """The reference module of a family."""
    return importlib.import_module(f"gpubench.reference.{name}")


class Graph:
    """The graph as a float32 CSR tensor, and its transpose as another,
    made by PyTorch's conversion to the compressed-column layout, so that
    ``Âᵀ`` is the transpose of what was generated and not assumed to equal
    ``Â``. Built from chunks that cover the rows in order."""

    def __init__(self, chunks: Iterable, n_rows: int, n_edges: int, device):
        crow = torch.empty(n_rows + 1, dtype=torch.int32, device=device)
        col = torch.empty(n_edges, dtype=torch.int32, device=device)
        val = torch.empty(n_edges, dtype=torch.float32, device=device)
        r, e = 0, 0
        for row_ptr, c, v, r0 in chunks:
            rows, k = row_ptr.numel() - 1, c.numel()
            if r0 != r or e + k > n_edges:
                raise ValueError(f"chunk at row {r0} after row {r}, or past {n_edges} edges")
            crow[r:r + rows] = row_ptr[:-1] + e
            col[e:e + k], val[e:e + k] = c, v
            r, e = r + rows, e + k
        if (r, e) != (n_rows, n_edges):
            raise ValueError(f"chunks cover {r} rows and {e} edges of {n_rows} and {n_edges}")
        crow[n_rows] = e
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.a = torch.sparse_csr_tensor(crow, col, val, size=(n_rows, n_rows),
                                             check_invariants=False)
            self.at = self.a.to_sparse_csc().t()

    def matmul(self, v: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        """``Â v`` (``Âᵀ v`` with ``transpose``) in float32."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return torch.sparse.mm(self.at if transpose else self.a, v)


def _round(v: torch.Tensor, dtype) -> torch.Tensor:
    return v if dtype == torch.float32 else v.to(dtype).float()


class _Round(torch.autograd.Function):
    """``v`` rounded to ``dtype`` (held in float32); its cotangent rounded
    to ``grad_dtype`` (None: passed as it is)."""

    @staticmethod
    def forward(ctx, v, dtype, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return _round(v, dtype)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.grad_dtype is None else _round(g, ctx.grad_dtype)), None, None


class _Propagate(torch.autograd.Function):
    """``Â v``; the backward is ``Âᵀ g`` with ``g`` rounded to ``dtype``."""

    @staticmethod
    def forward(ctx, v, graph, dtype):
        ctx.graph, ctx.dtype = graph, dtype
        return graph.matmul(v)

    @staticmethod
    def backward(ctx, g):
        return ctx.graph.matmul(_round(g, ctx.dtype), transpose=True), None, None


class _Product(torch.autograd.Function):
    """``x @ w'`` with ``w' = w`` rounded to ``dtype`` (the features'
    dtype), float32 products; ``dw = xᵀ g'`` with ``g'`` rounded to
    ``dtype``. ``x`` holds float32 values and is a constant."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        ctx.save_for_backward(x)
        ctx.dtype = dtype
        return _blocked(x, lambda blk: blk @ _round(w, dtype))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gl = _round(g, ctx.dtype)
        dw = sum(xb.T @ gb for xb, gb in zip(x.split(1 << 20), gl.split(1 << 20)))
        return None, dw, None


def _blocked(x, fn):
    return torch.cat([fn(blk) for blk in x.split(1 << 20)])


class Ops:
    """What a family's ``loss`` composes: the propagation (a stream node),
    the first layer's product, and the stated roundings, at ``low``."""

    def __init__(self, graph: Graph, low):
        self.graph, self.low = graph, low

    def features(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The features as the configuration stores them, in float32; None
        (identity features) stays None."""
        return None if x is None else _round(x.float(), self.low)

    def round(self, v: torch.Tensor) -> torch.Tensor:
        """``v`` stored at ``low``: rounded, and so is its cotangent."""
        return _Round.apply(v, self.low, self.low)

    def propagate(self, v: torch.Tensor) -> torch.Tensor:
        """A stream node: ``Â`` applied to ``v`` stored at ``low``."""
        return _Propagate.apply(self.round(v), self.graph, self.low)

    def product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _Product.apply(x, w, self.low)


def masked_ce(logits, y, mask):
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None].long())[:, 0]
    return (nll * mask).sum() / mask.sum()


class ReferenceTrainer:
    """The reference's training loop from the benchmark's weights:
    ``step() -> loss``, ``first_grad()`` (step 1's gradients) and
    ``snapshot()`` (the parameters now), the interface the harness reads
    from the program too."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], graph: Graph,
                 x, y, mask, low: str):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.fam = family(cfg["family"])
        self.ops = Ops(graph, DTYPES[low])
        self.x = self.ops.features(x)
        self.y, self.mask = y, mask
        self.params = {k: w.detach().float().clone() for k, w in weights.items()}
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0
        self._first = None

    def step(self) -> float:
        ps = {k: p.clone().requires_grad_(True) for k, p in self.params.items()}
        loss = self.fam.loss(ps, self.x, self.y, self.mask, self.ops, self.cfg)
        loss.backward()
        grads = {k: p.grad for k, p in ps.items()}
        if self._first is None:
            self._first = {k: g.clone() for k, g in grads.items()}
        self._adam(grads)
        return float(loss.detach())

    def _adam(self, grads):
        opt = self.cfg["optimizer"]
        lr, (b1, b2), eps = self.cfg["learning_rate"], opt["betas"], opt["eps"]
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            denom = self.v[k].sqrt() / bc2 ** 0.5 + eps
            self.params[k] = self.params[k] - (lr / bc1) * self.m[k] / denom

    def first_grad(self) -> Dict[str, torch.Tensor]:
        return self._first

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: p.clone() for k, p in self.params.items()}
