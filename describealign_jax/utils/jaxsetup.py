"""JAX runtime setup: persistent compilation cache.

Alignment programs are shape-bucketed but still take seconds to compile;
a persistent cache lets every run after the first skip that. Where
JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise the cache lives in one fixed directory (JAX keys
entries by path, so a directory that moved between runs would never hit):
`<checkout>/.jax_cache` (gitignored) when the package runs from a source
checkout, the user's cache directory when it is installed (site-packages,
a frozen app bundle). A directory that cannot be created or written turns
persistence off; it never fails the import. Disable with
DESCRIBEALIGN_NO_JAX_CACHE=1.
"""
import os

from ..config import APP_NAME

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DONE = False


def default_cache_dir(package_dir=PACKAGE_DIR):
    """`<checkout>/.jax_cache` when `package_dir` sits in a source checkout
    (pyproject.toml beside it), else the user's cache directory."""
    root = os.path.dirname(package_dir)
    if os.path.isfile(os.path.join(root, 'pyproject.toml')):
        return os.path.join(root, '.jax_cache')
    try:
        import platformdirs
        base = platformdirs.user_cache_dir(APP_NAME, appauthor=False)
    except ImportError:
        base = os.path.join(
            os.environ.get('XDG_CACHE_HOME')
            or os.path.join(os.path.expanduser('~'), '.cache'), APP_NAME)
    return os.path.join(base, 'jax_cache')


CACHE_DIR = default_cache_dir()


def cache_dir_for(platform, environ=os.environ):
    """The directory this module configures for `platform`, or None when
    it configures none: the CPU backend (its compiles are fast, and a
    cached CPU binary may target another host's instruction set), an
    explicit JAX_COMPILATION_CACHE_DIR (JAX's own setting wins), or the
    opt-out switch."""
    if (platform == 'cpu' or environ.get('JAX_COMPILATION_CACHE_DIR')
            or environ.get('DESCRIBEALIGN_NO_JAX_CACHE')):
        return None
    return CACHE_DIR


def writable_dir(path):
    """Create `path` if needed; True when it is a directory we may write."""
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return False
    return os.access(path, os.W_OK)


def setup_jax_cache():
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax
    # the configured platform list, not jax.default_backend(): this runs at
    # package import and must not initialise a backend
    platform = (jax.config.jax_platforms
                or os.environ.get('JAX_PLATFORMS', '')).split(',')[0]
    cache_dir = cache_dir_for(platform)
    if cache_dir is None or not writable_dir(cache_dir):
        return
    jax.config.update('jax_compilation_cache_dir', cache_dir)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
