"""chip_smoke.py's contract off the card, the compile-cache location, and
the GPU-against-CPU matcher check on the card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from describealign_jax.utils import jaxsetup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line('gpu', 'NVIDIA H100 80GB HBM3', 1)
    assert '\n' not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_chip_smoke_refuses_a_cpu_backend():
    r = _run(['chip_smoke.py'], REPO,
             env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert 'needs a GPU' in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    r = _run(['chip_smoke.py'], str(tmp_path),
             env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_cache_dir_rules():
    assert jaxsetup.cache_dir_for('cuda', {}) == jaxsetup.CACHE_DIR
    assert jaxsetup.cache_dir_for('', {}) == jaxsetup.CACHE_DIR
    assert jaxsetup.cache_dir_for('cpu', {}) is None
    assert jaxsetup.cache_dir_for(
        'cuda', {'JAX_COMPILATION_CACHE_DIR': '/elsewhere'}) is None
    assert jaxsetup.cache_dir_for(
        'cuda', {'DESCRIBEALIGN_NO_JAX_CACHE': '1'}) is None
    # one fixed directory inside the checkout, listed in .gitignore
    assert jaxsetup.CACHE_DIR == os.path.join(REPO, '.jax_cache')
    with open(os.path.join(REPO, '.gitignore')) as f:
        assert '.jax_cache/' in f.read().split()


def test_installed_package_caches_per_user(tmp_path, monkeypatch):
    """Outside a checkout (no pyproject.toml beside the package, as in
    site-packages or an app bundle) the cache goes to the user's cache
    directory, never next to the installed package."""
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'xdg'))
    site = tmp_path / 'site-packages'
    got = jaxsetup.default_cache_dir(str(site / 'describealign_jax'))
    assert got == str(tmp_path / 'xdg' / 'describealign-jax' / 'jax_cache')
    (tmp_path / 'src' / 'pyproject.toml').parent.mkdir()
    (tmp_path / 'src' / 'pyproject.toml').write_text('')
    assert jaxsetup.default_cache_dir(
        str(tmp_path / 'src' / 'describealign_jax')) == str(
            tmp_path / 'src' / '.jax_cache')


def _copy_package(dest):
    shutil.copytree(os.path.join(REPO, 'describealign_jax'),
                    os.path.join(dest, 'describealign_jax'),
                    ignore=shutil.ignore_patterns('__pycache__', '*.so',
                                                  '*.buildinfo'))


@pytest.mark.parametrize('layout', ['checkout', 'installed'])
def test_import_survives_an_unusable_cache_dir(tmp_path, layout):
    """A cache directory that cannot be created (read-only install, a file
    in its place) turns persistence off instead of failing the import."""
    root = tmp_path / 'root'
    root.mkdir()
    _copy_package(str(root))
    blocker = tmp_path / 'blocker'
    blocker.write_text('')
    env = {**os.environ, 'JAX_PLATFORMS': 'cuda', 'PYTHONPATH': str(root),
           'XDG_CACHE_HOME': str(blocker), 'HOME': str(blocker)}
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    env.pop('DESCRIBEALIGN_NO_JAX_CACHE', None)
    if layout == 'checkout':
        (root / 'pyproject.toml').write_text('')
        (root / '.jax_cache').write_text('')     # a file where the dir goes
    r = _run(['-c', 'import describealign_jax, jax; '
              'print(describealign_jax.__file__); '
              'print(jax.config.jax_compilation_cache_dir)'],
             str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr
    where, cache = r.stdout.split()
    assert where.startswith(str(root))
    assert cache == 'None'


@pytest.mark.parametrize('env_dir', [None, 'given'])
def test_package_import_sets_the_cache_dir(tmp_path, env_dir):
    """Importing the package on a GPU platform points JAX at the checkout's
    cache directory, unless JAX_COMPILATION_CACHE_DIR names one (importing
    initialises no backend, so this runs without a card)."""
    env = {**os.environ, 'JAX_PLATFORMS': 'cuda'}
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    env.pop('DESCRIBEALIGN_NO_JAX_CACHE', None)
    want = jaxsetup.CACHE_DIR
    if env_dir:
        want = env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path / env_dir)
    r = _run(['-c', 'import describealign_jax, jax; '
              'print(jax.config.jax_compilation_cache_dir)'], REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


GPU_CHECK = """
import jax, numpy as np
import chip_smoke as cs
from describealign_jax.alignment import api
from describealign_jax.utils.synthmedia import build_pair
gpu = cs.require_gpu()[0]
video, audio, _ = build_pair(content_seconds=90.0,
                             narration=((30.0, 4.0), (60.0, 5.0)),
                             lead_in=8.0, seed=5)
video, audio = cs.to_i16(video), cs.to_i16(audio)
sv, sa = video.shape[1], audio.shape[1]
npad = max(api._bucket_pad(sv // 210), api._bucket_pad(sa // 210))
fv, nv = api.host_features_padded(video, sv, npad)
fa, na = api.host_features_padded(audio, sa, npad)
g = cs.match_on(gpu, fa, na, fv, nv)
c = cs.match_on(jax.devices('cpu')[0], fa, na, fv, nv)
assert np.array_equal(g[0], c[0])
dg, dc = cs.candidate_dict(*g[2:]), cs.candidate_dict(*c[2:])
assert len(set(dg) ^ set(dc)) <= cs.FINE_SET_DIFF_MAX * len(dc) + 2
rel = np.array([abs(dg[k] - dc[k]) / dc[k] for k in set(dg) & set(dc)])
assert np.percentile(rel, 99) <= cs.FINE_QUAL_RTOL_P99
print("ok")
"""


@pytest.mark.gpu
def test_matcher_on_gpu_matches_cpu(gpu_env):
    """Coarse tracks equal and fine candidates within chip_smoke's stated
    tolerances, GPU against the CPU reference, on a 90-s pair."""
    r = _run(['-c', GPU_CHECK], REPO, env=gpu_env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().endswith('ok')
