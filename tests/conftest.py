import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without several accelerators.  The tests marked ``gpu`` need a
# card and skip elsewhere; on a GPU host run them with
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU JAX sees; skips the test when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
    return dev
