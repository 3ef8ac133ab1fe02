"""Graph loading, normalization, containers and layouts (port of
:mod:`textgcn_tpu.graph`)."""
