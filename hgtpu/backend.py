"""The one decision about the backend.

Every choice between the device program and the host engine asks this
module, so the program has a single answer to "does this process run on
an accelerator?".  The accelerator hgtpu targets is an NVIDIA GPU; the
CPU backend (tests, laptops) runs the host engine under the "auto"
options.
"""
from __future__ import annotations


def on_accelerator() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"
