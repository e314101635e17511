"""Test configuration: an 8-device CPU JAX runtime with float64.

The in-process config update below must run before JAX initializes its
backends — hence it lives at conftest import time, ahead of any test import
of jax-using modules.  CPU × 8 virtual devices exercises the
shard_map/ppermute distribution layer (T9/T10/T16) without several cards.
The package has no GPU-only code path, so every test runs here;
``python chip_smoke.py`` is the end-to-end check on a GPU.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
