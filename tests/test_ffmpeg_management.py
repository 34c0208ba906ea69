"""static_ffmpeg binary management: crumb parsing + pre-v6 eviction."""
import sys
import types

import pytest

from describealign_jax.media import ffmpeg as ff


@pytest.fixture()
def fake_static_ffmpeg(tmp_path, monkeypatch):
    pkg = types.ModuleType("static_ffmpeg")
    run = types.ModuleType("static_ffmpeg.run")
    run.get_platform_dir = lambda: str(tmp_path)
    pkg.run = run
    monkeypatch.setitem(sys.modules, "static_ffmpeg", pkg)
    monkeypatch.setitem(sys.modules, "static_ffmpeg.run", run)
    return tmp_path


def _crumb(tmp_path, version):
    (tmp_path / "installed.crumb").write_text(
        f"installed from https://github.com/zackees/ffmpeg_bins/raw/main/"
        f"v{version}/manylinux_2_17_x86_64.zip on 2024-01-01 01:09:01\n")


def test_no_crumb_means_not_installed(fake_static_ffmpeg):
    assert ff.evict_stale_static_binaries() is False


def test_v6_crumb_is_kept(fake_static_ffmpeg):
    _crumb(fake_static_ffmpeg, "6.0")
    assert ff.evict_stale_static_binaries() is True
    assert (fake_static_ffmpeg / "installed.crumb").exists()


def test_old_crumb_is_evicted(fake_static_ffmpeg, capsys):
    _crumb(fake_static_ffmpeg, "5.0")
    assert ff.evict_stale_static_binaries() is False
    assert not (fake_static_ffmpeg / "installed.crumb").exists()
    assert "Old ffmpeg version detected" in capsys.readouterr().out


def test_malformed_crumb_is_not_trusted(fake_static_ffmpeg):
    (fake_static_ffmpeg / "installed.crumb").write_text("garbage\n")
    assert ff.evict_stale_static_binaries() is False


@pytest.fixture()
def no_system_ffmpeg(monkeypatch):
    """Hide PATH/env binaries so discovery depends on static_ffmpeg only."""
    monkeypatch.delenv("DESCRIBEALIGN_FFMPEG", raising=False)
    monkeypatch.delenv("DESCRIBEALIGN_FFPROBE", raising=False)
    monkeypatch.setattr(ff.shutil, "which", lambda name: None)
    ff._reset_discovery_cache()
    yield
    ff._reset_discovery_cache()


def _install_on_fetch(tmp_path, version="6.0"):
    """A fetch function that materializes binaries + crumb like
    static_ffmpeg does."""
    def fetch():
        _crumb(tmp_path, version)
        ffmpeg = tmp_path / "ffmpeg"
        ffprobe = tmp_path / "ffprobe"
        ffmpeg.write_text("#!/bin/sh\n")
        ffprobe.write_text("#!/bin/sh\n")
        return str(ffmpeg), str(ffprobe)
    return fetch


def test_install_flow_messages_and_verify(fake_static_ffmpeg, monkeypatch,
                                          no_system_ffmpeg, capsys):
    """Reference combine() install flow (describealign.py:1065-1073):
    download message -> fetch -> re-verify -> success message."""
    run = __import__("sys").modules["static_ffmpeg.run"]
    run._get_or_fetch_platform_executables_else_raise_no_lock = \
        _install_on_fetch(fake_static_ffmpeg)
    monkeypatch.setattr(ff, "get_static_ffmpeg_version", lambda: 3.0)
    assert ff.is_ffmpeg_installed() is False
    ff.install_ffmpeg_with_prompts()
    out = capsys.readouterr().out
    d = out.find("Downloading and installing ffmpeg "
                 "(media editor, 50 MB download)...")
    s = out.find("Successfully installed ffmpeg.")
    assert 0 <= d < s
    assert ff.is_ffmpeg_installed() is True


def test_install_flow_failure_message(fake_static_ffmpeg, monkeypatch,
                                      no_system_ffmpeg, capsys):
    """A fetch that produces nothing surfaces the reference's failure
    message (describealign.py:1071-1072)."""
    run = __import__("sys").modules["static_ffmpeg.run"]
    run._get_or_fetch_platform_executables_else_raise_no_lock = \
        lambda: (_ for _ in ()).throw(RuntimeError("download failed"))
    monkeypatch.setattr(ff, "get_static_ffmpeg_version", lambda: 3.0)
    with pytest.raises(RuntimeError, match="Failed to install ffmpeg."):
        ff.install_ffmpeg_with_prompts()
    assert ("Downloading and installing ffmpeg"
            in capsys.readouterr().out)


def test_install_flow_old_static_ffmpeg(fake_static_ffmpeg, monkeypatch,
                                        no_system_ffmpeg, capsys):
    """static_ffmpeg < 3 is rejected before any download
    (describealign.py:1066-1068)."""
    monkeypatch.setattr(ff, "get_static_ffmpeg_version", lambda: 2.0)
    with pytest.raises(ImportError, match="at least version 3.0"):
        ff.install_ffmpeg_with_prompts()
    assert "ERROR: outdated static_ffmpeg version" in capsys.readouterr().out


def test_install_flow_hermetic_env(monkeypatch, no_system_ffmpeg):
    """Without static_ffmpeg importable, the flow raises the hermetic-env
    guidance instead of attempting a download."""
    import builtins
    real_import = builtins.__import__

    def block_static(name, *a, **k):
        if name.startswith("static_ffmpeg"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block_static)
    import sys as _sys
    monkeypatch.delitem(_sys.modules, "static_ffmpeg", raising=False)
    monkeypatch.delitem(_sys.modules, "static_ffmpeg.run", raising=False)
    with pytest.raises(RuntimeError, match="DESCRIBEALIGN_FFMPEG"):
        ff.install_ffmpeg_with_prompts()


def test_is_ffmpeg_installed_does_not_fetch(fake_static_ffmpeg, monkeypatch,
                                            no_system_ffmpeg):
    """The presence check must never download (reference is_ffmpeg_installed
    only reads the crumb, describealign.py:528-543)."""
    run = __import__("sys").modules["static_ffmpeg.run"]

    def boom():
        raise AssertionError("is_ffmpeg_installed must not fetch")
    run._get_or_fetch_platform_executables_else_raise_no_lock = boom
    assert ff.is_ffmpeg_installed() is False
    # an existing install (crumb + binaries) is recognized without fetching
    _install_on_fetch(fake_static_ffmpeg)()
    assert ff.is_ffmpeg_installed() is True
