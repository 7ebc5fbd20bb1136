"""ShortcutFusion's compiler in PyTorch and CUDA.

The counterpart of the JAX package ``repro``, module for module under the
same sub-package names; it imports ``torch`` and ``numpy`` only.  See
``core/compiler.py::compile_graph`` for the entry point and ``kernels/`` for
the CUDA kernels of the cut search.
"""
