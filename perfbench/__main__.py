import os
import pathlib
import sys
import time

from perfbench import run

# caches of the program live at fixed paths inside the checkout, so only
# a cell's first run there builds or compiles
_BUILD = pathlib.Path.cwd() / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(_BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_BUILD / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

run.T0 = time.perf_counter() - run.process_age_s()
rc = run.main()
sys.stdout.flush()
sys.stderr.flush()
# every thread of the cell has been stopped by its driver; leave without
# waiting on interpreter teardown
os._exit(rc)
