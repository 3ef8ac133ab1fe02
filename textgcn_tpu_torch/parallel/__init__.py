"""Multi-device training of every family over ``torch.distributed`` (port
of :mod:`textgcn_tpu.parallel`): the row partition, the halo ring, the
per-rank aggregation on K1 and K2, sharded GAT on the attention kernels, the
sharded trainer and its launcher."""
