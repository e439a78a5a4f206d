"""Runtime plumbing: the compile-cache directory and the native build."""
import os
import shutil

import jax
import pytest

from orbslam_jpminipc import native
from orbslam_jpminipc.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert jaxcache.cache_dir() == str(tmp_path / "cc")
    assert jaxcache.enable_persistent_cache() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")


def test_cache_default_is_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")


def _ignored(rel: str) -> bool:
    with open(os.path.join(REPO, ".gitignore")) as f:
        patterns = [ln.strip().rstrip("/") for ln in f if ln.strip()]
    return any(rel == p or rel.startswith(p + "/") for p in patterns)


def test_native_library_builds_into_ignored_dir(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    rel = os.path.relpath(native.lib_path(), REPO)
    assert _ignored(rel), rel
    # build a copy of the source: the library lands in the build dir under
    # a name keyed by the source's content, and an edit gets its own build
    src = tmp_path / "mapgraph.cpp"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    first = native.lib_path()
    assert os.path.dirname(first) == str(tmp_path / "build")
    assert native._build(first) and os.path.exists(first)
    with open(src, "a") as f:
        f.write("\n// edited\n")
    assert native.lib_path() != first
