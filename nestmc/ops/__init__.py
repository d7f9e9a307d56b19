"""Hot likelihood reductions over the chains x groups x observations lattice.

``nestmc.ops.loglik`` holds the pure-jnp reference implementations;
``nestmc.ops.loglik_triton`` the fused GPU kernel held to them by parity
tests; ``nestmc.ops.dispatch`` chooses between the two by platform.
"""

from nestmc.ops.loglik import (
    logistic_loglik_padded,
    logistic_loglik_segment,
    normal_loglik_padded,
    poisson_loglik_padded,
    poisson_loglik_segment,
)

__all__ = [
    "logistic_loglik_padded",
    "logistic_loglik_segment",
    "normal_loglik_padded",
    "poisson_loglik_padded",
    "poisson_loglik_segment",
]
