"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere. Tests that need the
GPU carry the `gpu` marker and take the `gpu_env` fixture: they run their
device work in a child process that leaves this CPU-only test process off
the card, and skip where there is no card (README.md names the command).
"""
import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the config, not only the env: a jax imported earlier in the process
# latched jax_platforms from the environment it saw then
jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_env():
    """Environment for a child process that runs on the GPU, or a skip
    where no GPU answers. Decided at run time, never at collection, so
    every xdist worker collects the same tests."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env
