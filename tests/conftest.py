"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without several accelerators via
``--xla_force_host_platform_device_count`` (SURVEY.md section 4d).  The
platform is pinned to the CPU unless ``TOPFUSION_TEST_PLATFORM`` names
another one: ``chip_smoke.py`` sets it to ``cuda`` to run the tests marked
``gpu`` on the card.  Those tests take the ``gpu_device`` fixture, which
skips them on any other platform.
"""

import os

import pytest

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update(
    "jax_platforms", os.environ.get("TOPFUSION_TEST_PLATFORM", "cpu")
)
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs a CUDA GPU (run `python chip_smoke.py` on the card)"
        )
    return dev
