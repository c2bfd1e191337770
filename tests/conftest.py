"""Test configuration: force an 8-device virtual CPU platform (SURVEY.md §4:
shard-count invariance is validated on virtual devices, no pod needed).

Set MERPCR_TEST_BACKEND=gpu to run the suite on JAX's default accelerator
instead.
"""

import io
import os
import sys
from contextlib import redirect_stdout

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The suite's corpora are deliberately small, which would route nearly
# every search through the host (NumPy) fast path and starve the DEVICE
# pipeline — the riskier code — of coverage. Disable host routing by
# default; tests/test_host_path.py re-enables it explicitly, and the
# differential fuzzer runs every case through BOTH paths.
os.environ.setdefault("MERPCR_TPU_HOST_MAX", "0")

import jax  # noqa: E402

if os.environ.get("MERPCR_TEST_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

REFERENCE_ROOT = "/root/reference"
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN_STS = os.path.join(_DATA, "test.sts")
GOLDEN_FA = os.path.join(_DATA, "test.fa")
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"

have_golden = os.path.exists(GOLDEN_STS)
have_oracle = os.path.isdir(os.path.join(REFERENCE_ROOT, "src"))

needs_golden = pytest.mark.skipif(not have_golden, reason="golden data not mounted")
needs_oracle = pytest.mark.skipif(not have_oracle, reason="reference not mounted")


# Every compiled XLA CPU executable mmaps ~9+ code regions and the suite
# compiles thousands of distinct programs (fuzz-random shapes); one process
# crosses the kernel's vm.max_map_count (65530 here) and XLA segfaults or
# aborts inside mmap (observed at maps=65506 — jaxlib 0.9.0 does not fail
# gracefully). jax.clear_caches() releases executables (measured 2315->528
# maps) and live jitted wrappers transparently recompile, so: watch the map
# count after each test and clear when it gets high.
_MAP_CLEAR_THRESHOLD = 20000


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as fh:
            return sum(1 for _ in fh)
    except OSError:  # non-Linux
        return 0


@pytest.fixture(autouse=True)
def _bound_memory_maps():
    yield
    if _n_maps() > _MAP_CLEAR_THRESHOLD:
        jax.clear_caches()


def run_search(engine, records) -> str:
    """Capture an engine's stdout hit report."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        engine.search(records, None)
    return buf.getvalue()


def oracle_engine(**params):
    """Instantiate the reference implementation (oracle)."""
    sys.path.insert(0, os.path.join(REFERENCE_ROOT, "src"))
    import merpcr as ref

    return ref.MerPCR(**params)


@pytest.fixture
def tmp_sts(tmp_path):
    def make(content: str) -> str:
        p = tmp_path / "t.sts"
        p.write_text(content)
        return str(p)

    return make


@pytest.fixture
def tmp_fa(tmp_path):
    def make(content: str) -> str:
        p = tmp_path / "t.fa"
        p.write_text(content)
        return str(p)

    return make
