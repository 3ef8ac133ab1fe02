"""PyTorch + CUDA port of :mod:`textgcn_tpu` for one NVIDIA Hopper GPU.

The JAX package stays as the reference; each module here names the JAX
module it ports. Importing this package imports neither ``jax`` nor
``textgcn_tpu``, and needs no GPU, ``nvcc`` or ``triton``: the CUDA kernels in
``csrc/`` are built at their first launch (:mod:`textgcn_tpu_torch.ops._build`).
"""
