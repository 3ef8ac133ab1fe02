"""Model families (port of :mod:`textgcn_tpu.models`; GCN and GAT so far).

``MODELS`` maps a family's name (``TrainConfig.model``, ``cli --model``) to
its module class. Every class takes ``(n_feat, n_hidden, n_class, dropout,
*, device, generator)`` and is called as ``model(graph, x, generator=...)``,
so the trainer builds and runs any family alike.
"""
from textgcn_tpu_torch.models.gat import GAT
from textgcn_tpu_torch.models.gcn import GCN

MODELS = {"gcn": GCN, "gat": GAT}
