"""PyTorch + CUDA port of the GraphStorm reproduction (``repro``).

The package mirrors ``repro``'s layout so each module's counterpart is
easy to find, but imports only ``torch`` and ``numpy``: it never imports
``jax`` or anything of ``repro``.  Hot loops that ``repro`` wrote as
Pallas kernels are CUDA C++ kernels here (``csrc/``), each with a plain
PyTorch version beside it that runs on CPU tensors.

So far the port covers node-classification serving:
``python -m repro_torch.cli.gs --serve --cf <config>``.
"""
