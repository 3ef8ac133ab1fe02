"""Dataset label files, the stop-word list and corpus cleaning (port of
:mod:`textgcn_tpu.text`)."""
