"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated the way the reference validates
"distributed" training without a cluster (SURVEY.md §4): N virtual devices
on one host.  The platform is set through jax.config before any backend
initializes, so the tests stay on the CPU whatever JAX_PLATFORMS says.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "evals"))

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE.exists():
        pytest.skip("reference repo not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def seeded_tiny(tmp_path_factory):
    """The seeded models (evals/seeded.py) at their reduced test width."""
    from seeded import TINY, write_models
    return write_models(str(tmp_path_factory.mktemp("seeded")), 0, TINY)
