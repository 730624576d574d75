"""ldmae_tpu_torch — the PyTorch/CUDA port of ``ldmae_tpu``.

Same module layout and names as ``ldmae_tpu``; plain tensor code is PyTorch
and every Pallas kernel of the ported path is a hand-written CUDA kernel for
Hopper (``csrc/``, built at first use by ``kernels``). The package imports
neither JAX nor ``ldmae_tpu``; only the tests import both.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors each kernel wrapper runs its plain PyTorch version.
"""
