import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
if os.path.abspath(SRC) not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))


def pytest_addoption(parser):
    parser.addoption(
        "--regen-goldens", action="store_true", default=False,
        help="regenerate tests/golden/*.npz from the wavefront oracle "
             "(then re-run without the flag to verify; see "
             "tests/golden/README.md)")


@pytest.fixture
def regen_goldens(request):
    """Whether this run should rewrite the golden-trace fixtures."""
    return request.config.getoption("--regen-goldens")


def make_test_mesh(axis_shape, axis_names):
    """Version-tolerant mesh construction.

    jax >= 0.5 exposes ``jax.sharding.AxisType`` and ``jax.make_mesh`` grew
    an ``axis_types=`` keyword; on 0.4.x neither exists (every axis is
    implicitly Auto).  Feature-detect so the multi-device tests run on both.
    """
    import jax

    axis_type = getattr(jax.sharding, "AxisType", None)
    if axis_type is not None:
        return jax.make_mesh(axis_shape, axis_names,
                             axis_types=(axis_type.Auto,) * len(axis_names))
    if hasattr(jax, "make_mesh"):
        return jax.make_mesh(axis_shape, axis_names)
    import math

    import numpy as np

    n = math.prod(axis_shape)
    devices = np.asarray(jax.devices()[:n]).reshape(axis_shape)
    return jax.sharding.Mesh(devices, axis_names)


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run ``code`` in a subprocess with n fake CPU devices.

    Multi-device tests need XLA_FLAGS set before jax import, which cannot
    happen inside an already-initialized test process.  The tests directory
    is on the subprocess path so code strings can import helpers from this
    conftest (``from conftest import make_test_mesh``).
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    # prepend (not replace): packages reachable only via the caller's
    # PYTHONPATH (e.g. hypothesis in some setups) stay importable
    inherited = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(SRC), TESTS] + ([inherited] if inherited else []))
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], env=env,
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


@pytest.fixture
def multidev():
    return run_with_devices


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skipped without one "
        "(run: PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py)")
