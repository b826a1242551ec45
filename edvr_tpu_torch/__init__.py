"""edvr_tpu_torch: the PyTorch and CUDA port of edvr_tpu for NVIDIA Hopper.

The JAX package ``edvr_tpu`` is the reference that each module here is held
against; this package imports nothing of it, nor JAX. Plain tensor code is
PyTorch (NCHW, BasicSR parameter names); each TPU kernel of the ported path
is a hand-written CUDA kernel under ``csrc/``, built and bound by
``edvr_tpu_torch.native``.
"""
