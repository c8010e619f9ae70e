"""Hand-written GPU kernels of the port, their wrappers and plain versions.

Nothing here is compiled when the package is imported: a kernel is built from
``csrc/`` at the first call that launches it (``_build.load``).
"""
