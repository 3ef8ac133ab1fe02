"""Multi-device GCN training over ``torch.distributed`` (port of
:mod:`textgcn_tpu.parallel`): the row partition, the per-rank hybrid tile +
residual aggregation on K1 and K2, the sharded trainer and its launcher."""
