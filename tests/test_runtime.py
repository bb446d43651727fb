"""Compile-cache placement (runtime.setup) and the native library's build
key (io/native)."""

import os
import subprocess
import sys

from zotpu import runtime
from zotpu.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import os, sys
sys.path.insert(0, {repo!r})
from zotpu import runtime
runtime.setup()
import jax, jax.numpy as jnp
print("DIR", jax.config.jax_compilation_cache_dir)
print("ON", jax.config.jax_enable_compilation_cache)
jax.jit(lambda x: jnp.sort(x * 3 + 1))(jnp.arange(97.0)).block_until_ready()
"""


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "ZOTPU_JAX_CACHE")}
    env.update(env_extra)
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "0"
    r = subprocess.run([sys.executable, "-c", PROBE.format(repo=REPO)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                if ln.startswith(("DIR ", "ON ")))


def test_cache_goes_to_env_dir_when_set(tmp_path):
    cache = tmp_path / "cc"
    got = _probe({"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert got["DIR"] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())   # an entry landed there
    assert runtime.cache_dir({"JAX_COMPILATION_CACHE_DIR": str(cache)}) \
        is None                                      # code sets no path


def test_cache_defaults_to_checkout_dir():
    assert runtime.cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert runtime.CHECKOUT_CACHE == os.path.join(REPO, ".jax_cache")


def test_cache_off_switch():
    got = _probe({"ZOTPU_JAX_CACHE": "off"})
    assert got["ON"] == "False"
    assert runtime.cache_dir({"ZOTPU_JAX_CACHE": "off"}) is None


def test_native_build_key_tracks_source_machine_and_compiler():
    base = native.build_key(b"src", "x86_64", "g++ 12.2.0")
    assert base == native.build_key(b"src", "x86_64", "g++ 12.2.0")
    assert base != native.build_key(b"src2", "x86_64", "g++ 12.2.0")
    assert base != native.build_key(b"src", "aarch64", "g++ 12.2.0")
    assert base != native.build_key(b"src", "x86_64", "g++ 13.1.0")


def test_native_foreign_binary_is_rebuilt(tmp_path, monkeypatch):
    """A library whose recorded key does not match this host (a copy of
    the checkout from another machine) is rebuilt, not loaded."""
    if native.get_lib() is None:
        import pytest
        pytest.skip(f"native library unavailable: {native.load_error()}")
    so, key = tmp_path / "lib.so", tmp_path / "lib.so.srchash"
    so.write_bytes(b"not a shared object")
    key.write_text("key-from-another-machine")
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_HASH", str(key))
    native._build()
    assert so.read_bytes()[:4] == b"\x7fELF"
    assert key.read_text() != "key-from-another-machine"
