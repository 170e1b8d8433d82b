"""PyTorch/CUDA port of the EBBkC k-clique system (see ``repro`` for the
JAX reference).  It imports torch and numpy, never jax or ``repro``."""
