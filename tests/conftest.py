"""Test configuration: force an 8-device CPU backend before JAX initializes.

This is the JAX analogue of the reference's ``nompi4py.MPIDummy`` fake
backend (nompi4py.py:1-37): multi-device code paths run on virtual CPU
devices so swap/sharding logic is exercised without an accelerator. Tests
always run on the CPU: the platform is forced both in the environment and
through jax.config, so a machine with a GPU does not hand the tests its card.
Checks that need the card run in ``chip_smoke.py``, not here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
