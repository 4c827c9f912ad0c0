import os
import sys
import time

STARTED = time.time()
_HERE = os.path.dirname(os.path.abspath(__file__))
# compiler caches at fixed places inside the checkout, so that only a
# checkout's first run compiles
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_HERE, "cache", _sub)
os.environ["USE_FLAX"] = "0"

from h100_bench.run import main  # noqa: E402

sys.exit(main(started=STARTED))
