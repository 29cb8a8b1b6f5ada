"""repro_torch — the PyTorch + CUDA port of the one-shot FL system.

A package beside the JAX reference (``repro``), with the same module
layout. It imports ``torch`` and ``numpy`` and never ``jax`` or
anything of ``repro``; its entry points run on a CUDA device unless the
caller passes ``device="cpu"``, and its hand-written CUDA kernels live
under ``kernels/csrc``. Import submodules directly, e.g.
``from repro_torch.core.protocol import run_protocol``.
"""
