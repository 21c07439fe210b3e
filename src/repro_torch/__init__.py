"""PyTorch/CUDA port of the CLoQ reproduction (``repro``).

Mirrors ``repro``'s layout (``core``, ``kernels``, ``models``, ``configs``,
``data``, ``launch``) and never imports ``jax`` or ``repro``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``."""
