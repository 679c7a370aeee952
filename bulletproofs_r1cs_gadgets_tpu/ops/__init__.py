"""Device compute primitives (jax.numpy programs compiled by XLA).

Importing this package configures the persistent JAX compilation cache
(see utils/jaxcfg) - the proof kernels are large graphs worth caching.
"""

from ..utils import jaxcfg as _jaxcfg

_jaxcfg.configure()
