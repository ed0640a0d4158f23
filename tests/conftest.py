"""Suite setup: an 8-device virtual CPU mesh, the stand-in scenes, and the
`gpu` marker.

The virtual mesh makes the sharding paths testable on one host.  A caller
that sets JAX_PLATFORMS itself (e.g. JAX_PLATFORMS=cuda to run the `gpu`
tests on a card) keeps its choice.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs only on an NVIDIA GPU (skips elsewhere)")


@pytest.fixture(scope="session")
def scenes(tmp_path_factory) -> pathlib.Path:
    """Directory holding every small stand-in as NAME.crtscene
    (simd_raytracer/models/scenegen.py), written once per session."""
    from simd_raytracer.models.scenegen import SMALL, write_scene
    d = tmp_path_factory.mktemp("scenes")
    for name in SMALL:
        write_scene(name, str(d))
    return d


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs in chip_smoke.py")
