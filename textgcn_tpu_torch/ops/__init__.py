"""SpMM dispatch and the hand-written CUDA kernels (port of
:mod:`textgcn_tpu.ops`)."""
