"""What the port's test files share: the JAX side's compiled functions.

The port's tests hold it against the JAX package on the CPU, and most of
their time is the JAX side compiling: the eager ops of a model's init
(one small XLA computation per op and shape, ~20 s for the ResNet-50
backbone's), and the jitted embed(), gradient and train-step functions,
which several files compile again for models of the same configuration
(one Predictor instance's jit cache misses another's with the same
computation). `shared_jax_compiles` points JAX's persistent compilation
cache at a directory of this worker's for the length of one test module,
so that a computation compiled once (in this module, or an earlier one
of this worker) is loaded and not compiled again. The cache keys on the
computation, its compile options and the backend, so a hit runs the same
executable a compile would have built. Outside the port's modules the
cache is off, as JAX's default leaves it.

The same fixture gives torch a share of the cores while the module runs:
under pytest-xdist every worker's torch would otherwise run as many threads
as the machine has cores, and the workers' threads together oversubscribe
them many times over, which made the port's files several times slower
beside the other workers than alone.

Each test file that imports `shared_jax_compiles` takes it as an autouse
module fixture.
"""

import os
import tempfile

import jax
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

# one directory per pytest-xdist worker: a worker runs its files one after
# another, so no two processes write one entry at once
CACHE_DIR = os.path.join(tempfile.gettempdir(),
                         "duoformer_tcga_tpu_torch_tests_jax_cache",
                         os.environ.get("PYTEST_XDIST_WORKER", "main"))
# every compile is cached, however short or small (the eager ops' are)
SETTINGS = {"jax_compilation_cache_dir": CACHE_DIR,
            "jax_persistent_cache_min_compile_time_secs": 0.0,
            "jax_persistent_cache_min_entry_size_bytes": -1}


# torch's threads in a worker: the cores over the workers (all of them
# without pytest-xdist)
TORCH_THREADS = max(1, (os.cpu_count() or 1)
                    // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


@pytest.fixture(scope="module", autouse=True)
def shared_jax_compiles():
    saved = {k: getattr(jax.config, k) for k in SETTINGS}
    threads = torch.get_num_threads()
    for k, v in SETTINGS.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    torch.set_num_threads(min(threads, TORCH_THREADS))
    try:
        yield CACHE_DIR
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
        torch.set_num_threads(threads)
