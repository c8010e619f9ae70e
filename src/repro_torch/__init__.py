"""Work-Stealing simulator, PyTorch/CUDA port.

Same sub-packages and module names as the JAX package it was ported from, so
the counterpart of any module is found under the same relative path. Imports
``torch`` and ``numpy`` only.
"""
