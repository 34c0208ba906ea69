#!/usr/bin/env python
"""Packaging smoke run.

PyInstaller itself is not installed in this image, so the closest
executable validation of the packaging layer is three checks:

1. wheel build: `python -m build --wheel --no-isolation` from
   pyproject.toml must succeed and ship the native .cpp sources
   (they compile lazily at first run, mirroring the reference's
   resource-file shipping in describealign.spec).
2. installed-package run: install the wheel into a throwaway
   --target dir (no network, no deps) and run
   `python -m describealign_jax --version` from it - this exercises
   the "installed package" provenance branch of the CLI.
3. spec lint: execute describealign_jax.spec with stubbed
   Analysis/PYZ/EXE/COLLECT/BUNDLE classes and assert the entry
   script exists, every datas source exists, and every hiddenimport
   resolves - the failure modes a real `pyinstaller` run would hit
   first.

Exit 0 iff all three pass. Run from the repo root.
"""
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # hiddenimport resolution in the spec lint


def sh(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, check=True, cwd=REPO, **kw)


def main():
    tmp = tempfile.mkdtemp(prefix="da_pkg_smoke_")
    dist = os.path.join(tmp, "dist")
    target = os.path.join(tmp, "site")
    try:
        # 1. wheel build
        sh([sys.executable, "-m", "build", "--wheel", "--no-isolation",
            "-o", dist, "."])
        whl = [f for f in os.listdir(dist) if f.endswith(".whl")]
        assert len(whl) == 1, whl
        whl_path = os.path.join(dist, whl[0])
        import zipfile
        names = zipfile.ZipFile(whl_path).namelist()
        for need in ("describealign_jax/native/dp.cpp",
                     "describealign_jax/native/features.cpp",
                     "describealign_jax/__main__.py"):
            assert need in names, f"wheel missing {need}"

        # 2. installed-package --version (provenance branch)
        sh([sys.executable, "-m", "pip", "install", "--no-index",
            "--no-deps", "--quiet", "--target", target, whl_path])
        env = dict(os.environ, PYTHONPATH=target, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-m", "describealign_jax", "--version"],
            check=True, capture_output=True, text=True, env=env,
            cwd=tmp).stdout
        assert "version:" in out and "installed package" in out, out
        print(out.strip())

        # 3. spec lint with stubbed PyInstaller API
        captured = {}

        class _Stub:
            def __init__(self, *a, **kw):
                captured.setdefault(type(self).__name__, []).append((a, kw))
                self.pure = self.zipped_data = self.scripts = []
                self.binaries = self.zipfiles = self.datas = []

        stubs = {n: type(n, (_Stub,), {})
                 for n in ("Analysis", "PYZ", "EXE", "COLLECT", "BUNDLE")}
        g = dict(stubs, __file__="describealign_jax.spec")
        spec_path = os.path.join(REPO, "describealign_jax.spec")
        exec(compile(open(spec_path).read(), spec_path, "exec"), g)
        (a_args, a_kw), = captured["Analysis"]
        entry = a_args[0][0]
        assert os.path.exists(os.path.join(REPO, entry)), entry
        for srcpath, _dest in a_kw["datas"]:
            assert os.path.exists(os.path.join(REPO, srcpath)), srcpath
        for mod in a_kw["hiddenimports"]:
            assert importlib.util.find_spec(mod) is not None, mod
        assert "EXE" in captured and "COLLECT" in captured
        print("SPEC-LINT-OK:", entry, a_kw["hiddenimports"])
        print("PACKAGING-SMOKE-OK")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
