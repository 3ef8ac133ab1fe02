"""Dataset label files (port of :mod:`textgcn_tpu.text`)."""
