"""Training steps.  Only the single-device step is ported so far; the
pixel- and depth-sharded forms of the JAX package's ``parallel/`` come with
``torch.distributed``."""
