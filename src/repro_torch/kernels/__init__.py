"""Hand-written Hopper kernels (``csrc/``) with their wrappers and plain
torch versions."""
