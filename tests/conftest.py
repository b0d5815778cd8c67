"""Suite-wide isolation: never read or write the developer's real
autotune cache (~/.cache/repro/autotune.json).  sampler_method defaults
to "auto" across the repo, so without this any test touching a sampler
would depend on — and mutate — host cache state.  Force-set (not
setdefault): a dev environment exporting REPRO_AUTOTUNE_CACHE or
REPRO_AUTOTUNE=measure must not leak into the suite either."""

import os
import tempfile

os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="repro-autotune-test-"), "autotune.json"
)
os.environ["REPRO_AUTOTUNE"] = "model"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (multi-device subprocesses, full sweeps)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (skips, with its reason, without them)",
    )
