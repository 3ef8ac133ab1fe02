"""Model families (port of :mod:`textgcn_tpu.models`; GCN so far)."""
