"""Persistent JAX compilation cache for the programs that drive the GPU.

Compiling the f64 MALI iteration takes tens of seconds, so the drivers
(chip_smoke.py, bench.py and the autotuner `benchmark()`) keep compiled
programs across processes.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX reads it itself and nothing here overrides it.  Otherwise the cache
goes to one fixed directory inside the checkout (listed in .gitignore):
the path is part of the cache's key, so it never depends on a temporary
name, a process id or the time.
"""
import os
from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parent.parent / '.jax_cache'


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache before the first compile;
    returns the directory in use."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', str(CACHE_DIR))
    return str(CACHE_DIR)
