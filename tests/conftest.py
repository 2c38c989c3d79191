import os

# 8 virtual CPU devices so sharding tests run without a device mesh.
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')
# CPU unless the caller names platforms (JAX_PLATFORMS=cuda,cpu on a
# machine with a card runs the `gpu`-marked tests there)
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update('jax_enable_x64', True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none.  Tests
    that need it also carry the `gpu` marker."""
    try:
        devices = jax.devices('gpu')
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip('needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a '
                    'machine with a card)')
    return devices[0]
