"""The one place that asks JAX which backend the program runs on.

Routing decisions (which scan a bucket takes, whether the winner is
finalized on the device) follow from this answer; tests substitute it to
check the GPU routes on the CPU.
"""

import jax


def on_gpu():
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"
