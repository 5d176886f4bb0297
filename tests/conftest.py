import os
import sys

# Tests run on the host CPU: pin the platform and expose an 8-device virtual
# CPU platform so sharding tests can build meshes of 2, 4 and 8 devices.
# Both must be set before jax is imported. The few tests that need a GPU
# carry the ``gpu`` marker and skip on the CPU; on a GPU host run them with
# ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

# Validation tests compare against float64 C++ goldens (1e-9 relative Poisson
# tolerances are below float32 resolution, SURVEY.md section 7).
jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch):
    """Entry points called in-process (cli.main) compile without the
    persistent cache: tests write nothing into the checkout."""
    from cfd_tpu import runtime

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda: None)



@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default device is a GPU
    (decided when the test runs, never at collection: every xdist worker
    must collect the same tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU")
