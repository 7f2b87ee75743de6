import os
import subprocess
import sys
import textwrap

import pytest

# Tests run single-device (the dry-run alone forces 512 host devices).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without CUDA)")


def run_with_devices(code: str, n_devices: int, timeout: int = 600) -> str:
    """Run a python snippet in a subprocess with N fake host devices.

    Multi-device behaviour (shard_map/ppermute/meshes) can't run in the
    main pytest process, which must keep seeing 1 device.
    """
    prog = textwrap.dedent(code)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=timeout, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_with_devices
