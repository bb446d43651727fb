"""Test config: force an 8-fake-device CPU platform BEFORE jax is imported.

This exercises the multi-device shard_map paths deterministically on one
process (SURVEY.md section 4, item 4). Tests marked ``gpu`` need a card and
skip elsewhere; `chip_smoke.py` and bench.py run on the GPU.
"""

import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# DISABLE the persistent compile cache for tests: CPU compiles are cheap and
# jit caches in-process, while concurrent cache writes from many test
# workers only add risk (runtime.py).
os.environ.setdefault("ZOTPU_JAX_CACHE", "off")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA card is visible (decided here, at run time --
    never at import, so every test worker collects the same tests)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no NVIDIA GPU: nvidia-smi not found")
    r = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("no NVIDIA GPU visible to nvidia-smi")


def random_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables after each test module.

    jaxlib 0.9.0's CPU backend_compile_and_load crashes (SIGSEGV/SIGABRT)
    on a LATE compile once a single long-lived process has accumulated
    hundreds of loaded executables (reproduced late in full-suite runs;
    any prefix subset passes). Dropping the
    jit caches per module keeps the live-executable count bounded; CPU
    recompiles are cheap.
    """
    yield
    import jax
    jax.clear_caches()
