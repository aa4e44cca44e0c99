"""Test config: an 8-virtual-device CPU mesh, set up before JAX's backends.

All multi-device sharding tests run against fake CPU devices (the "mesh
without a cluster" strategy of SURVEY.md §4 item 4).  Tests that need an
NVIDIA GPU carry the ``gpu`` marker and the ``gpu`` fixture, which skips
them where JAX finds no GPU; ``python chip_smoke.py`` runs them on the card,
in its own process, with ``--card``: that option leaves JAX on the
accelerator the process already holds instead of forcing the CPU.
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--card", action="store_true",
                     help="run on the process's accelerator (the gpu tests) "
                          "instead of forcing 8 virtual CPU devices")


def pytest_configure(config):
    if config.getoption("--card"):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu():
    """Skips the test unless JAX's first device is an NVIDIA GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on the "
                    "card")
