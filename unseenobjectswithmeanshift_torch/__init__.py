"""PyTorch / CUDA port of the MSMFormer and UCN two-stage unseen-object
segmenters.

The package mirrors ``unseenobjectswithmeanshift_tpu`` module by module
(``config``, ``models``, ``ops``, ``pipeline``, ``utils``, ``cli``) and imports
nothing from it: the JAX package is the reference the port is tested against.
Plain tensor code is PyTorch; every Pallas kernel of the JAX package is a CUDA
kernel written for Hopper (``csrc/``), built with nvcc on first use and loaded
with ctypes (``ops/_build.py``).
"""
