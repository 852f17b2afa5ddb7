"""The compile-cache rule (core/platform.py): the environment variable wins
and nothing else is set; without it, one fixed directory in the checkout."""

import pytest

from fluidsims_tpu.core import platform


class _Config:
    def __init__(self):
        self.updates = {}

    def update(self, key, value):
        self.updates[key] = value


class _Jax:
    def __init__(self):
        self.config = _Config()


def test_env_var_set_means_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv(platform.CACHE_ENV, str(tmp_path))
    fake = _Jax()
    assert platform.enable_compile_cache(fake) == str(tmp_path)
    assert fake.config.updates == {}


@pytest.mark.parametrize("value", [None, ""])
def test_env_var_unset_uses_fixed_dir_in_checkout(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(platform.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(platform.CACHE_ENV, value)
    fake = _Jax()
    path = platform.enable_compile_cache(fake)
    assert path == str(platform.DEFAULT_CACHE_DIR)
    assert fake.config.updates["jax_compilation_cache_dir"] == path
    assert platform.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (platform.DEFAULT_CACHE_DIR.parent / "chip_smoke.py").exists()
