"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  ``ops`` dispatches by operand device; ``build`` compiles
``csrc/*.cu`` at first use."""
