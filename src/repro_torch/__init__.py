"""PyTorch and CUDA port of the CARLS reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout and is held against it by the ``tests/test_torch_*.py`` files. It
imports ``torch``, never ``jax`` and nothing of ``repro``. Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
