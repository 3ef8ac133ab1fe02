"""Topic inspection reports (port of :mod:`textgcn_tpu.inspect`)."""
