"""Data preparation, training, metrics and reports (port of
:mod:`textgcn_tpu.train`)."""
