"""The plain reference: the reference renderer's camera (``camera``), its
shader's march with autograd for gradients (``march``) and Adam written
out (``adam``).  It imports neither JAX nor anything of the renderer under
test, and takes none of its outputs but those it judges."""
