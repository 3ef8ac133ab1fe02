"""Configuration, logging and profiling helpers (port of
:mod:`textgcn_tpu.utils`)."""
