"""PyTorch/CUDA port of the ViTMAlis serving path.

Mirrors the layout of the JAX package ``repro`` module for module, so a
reader can find each counterpart by its path.  Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas is a CUDA kernel
written for Hopper (``csrc/``), built at first use and bound through
``ctypes`` (``kernels/build.py``).  The package imports neither ``jax``
nor ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
