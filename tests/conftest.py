"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware via
``xla_force_host_platform_device_count`` (SURVEY.md section 4 test strategy).
Must be set before JAX initializes, hence module scope here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# A pytest plugin may have imported jax before this conftest ran, in which
# case the env var above was read too late; the config update below still
# wins as long as no backend has been initialized yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
