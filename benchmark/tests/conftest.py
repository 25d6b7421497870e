import os

import pytest


@pytest.fixture(autouse=True)
def _tmpdir_env(tmp_path, monkeypatch):
    """Each test's runs write under its own TMPDIR; the variables a run
    sets are put back afterwards."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("SIFT4G_TPU_IN_DAEMON", "1")
    monkeypatch.setattr(tempfile, "tempdir", None)
    os.makedirs(tmp_path, exist_ok=True)
