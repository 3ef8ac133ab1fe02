"""Model families (port of :mod:`textgcn_tpu.models`).

``MODELS`` maps a family's name (``TrainConfig.model``, ``cli --model``) to
its module class, the JAX registry's eight names. Every class takes
``(n_feat, n_hidden, n_class, dropout, *, device, generator)`` and is called
as ``model(graph, x, generator=...)``, so the trainer builds and runs any
family alike; every family but GAT propagates through ``spmm(graph, ·)``,
so any SpMM format runs it.
"""
from textgcn_tpu_torch.models.appnp import APPNP
from textgcn_tpu_torch.models.gat import GAT
from textgcn_tpu_torch.models.gcn import GCN
from textgcn_tpu_torch.models.gcnii import GCNII
from textgcn_tpu_torch.models.gin import GIN
from textgcn_tpu_torch.models.sage import SAGE
from textgcn_tpu_torch.models.sgc import SGC, SGCPre

MODELS = {
    "gcn": GCN,
    "gat": GAT,
    "sgc": SGC,
    # the linear head over features propagated once by sgc_precompute
    # (train/run.py): the train step holds no sparse op
    "sgc_pre": SGCPre,
    "appnp": APPNP,
    "sage": SAGE,
    "gin": GIN,
    "gcnii": GCNII,
}
