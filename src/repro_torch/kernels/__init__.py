"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain versions."""
