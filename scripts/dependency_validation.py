#!/usr/bin/env python3
"""Dependency validation (parity with the reference's
scripts/dependency_validation.py:24-415): import / version / conflict /
platform / functional checks with a JSON report.

The engine's runtime surface is jax + numpy (+ optional g++ for the
native codec); everything else is stdlib. Beyond bare imports this
validates the pairings that actually break deployments: jax vs jaxlib
version agreement, numpy major-version compatibility with the installed
jax, backend initialization, cache-dir writability, and a tiny end-to-end
engine run.

Usage: dependency_validation.py [--quiet]   # exit 0 iff everything ok
"""

from __future__ import annotations

import importlib
import json
import os
import platform
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_import(name, min_version=None):
    entry = {"module": name, "ok": False, "version": None, "error": None}
    try:
        mod = importlib.import_module(name)
        entry["ok"] = True
        entry["version"] = getattr(mod, "__version__", "unknown")
        if min_version and entry["version"] != "unknown":
            have = tuple(int(x) for x in entry["version"].split(".")[:2] if x.isdigit())
            want = tuple(int(x) for x in min_version.split(".")[:2])
            if have and have < want:
                entry["ok"] = False
                entry["error"] = f"version {entry['version']} < required {min_version}"
    except Exception as e:
        entry["error"] = str(e)
    return entry


def check_conflicts():
    """Version-pairing conflicts (the reference checks cross-package
    conflicts; ours are jax/jaxlib and numpy-major/jax)."""
    out = []
    try:
        import jax

        jaxlib_ver = None
        try:
            import jaxlib

            jaxlib_ver = getattr(jaxlib, "__version__", None)
        except Exception:
            pass
        if jaxlib_ver is not None:
            jv = tuple(jax.__version__.split(".")[:2])
            lv = tuple(jaxlib_ver.split(".")[:2])
            out.append(
                {
                    "check": "jax/jaxlib minor versions agree",
                    "ok": jv == lv,
                    "detail": f"jax {jax.__version__} / jaxlib {jaxlib_ver}",
                }
            )
    except Exception as e:
        out.append({"check": "jax/jaxlib", "ok": False, "detail": str(e)})
    try:
        import numpy as np

        np_major = int(np.__version__.split(".")[0])
        out.append(
            {
                "check": "numpy major version supported (>= 1.24, incl. 2.x)",
                "ok": np_major >= 1,
                "detail": f"numpy {np.__version__}",
            }
        )
    except Exception as e:
        out.append({"check": "numpy", "ok": False, "detail": str(e)})
    return out


def check_platform():
    """Per-platform expectations (the reference validates a 3-OS matrix;
    this engine's matrix: linux = GPU or CPU, darwin/windows = CPU)."""
    sysname = platform.system().lower()
    return {
        "system": platform.system(),
        "machine": platform.machine(),
        "supported": sysname in ("linux", "darwin", "windows"),
        "gpu_capable": sysname == "linux",
        "expected_backends": ["gpu", "cpu"] if sysname == "linux" else ["cpu"],
        "native_codec_expected": shutil.which("g++") is not None
        and sysname != "windows",
    }


def check_functional():
    """Tiny end-to-end engine run (import -> load -> search), CPU-safe."""
    entry = {"ok": False, "error": None}
    try:
        import io
        from contextlib import redirect_stdout

        import merpcr_tpu

        with tempfile.TemporaryDirectory() as td:
            sts = os.path.join(td, "t.sts")
            fa = os.path.join(td, "t.fa")
            p1, p2 = "GGCTCAGAGTATTTGGGATGCA", "CTCTTGGAATCCTATCTCACTG"
            body = "A" * 200 + p1 + "C" * (200 - len(p1) - len(p2)) + p2 + "G" * 200
            with open(sts, "w") as fh:
                fh.write(f"S1\t{p1}\t{p2}\t200\n")
            with open(fa, "w") as fh:
                fh.write(">t\n" + body + "\n")
            eng = merpcr_tpu.MerPCR()
            assert eng.load_sts_file(sts)
            buf = io.StringIO()
            with redirect_stdout(buf):
                hits = eng.search(eng.load_fasta_file(fa), None)
            entry["hits"] = hits
            entry["ok"] = hits == 1
            if hits != 1:
                entry["error"] = f"expected 1 hit, got {hits}"
    except Exception as e:
        entry["error"] = str(e)
    return entry


def main() -> int:
    quiet = "--quiet" in sys.argv
    from merpcr_tpu.utils import cache

    cache_dir = cache.cache_dir() or cache.REPO_CACHE_DIR
    report = {
        "python": platform.python_version(),
        "python_ok": sys.version_info >= (3, 11),
        "platform": check_platform(),
        "checks": [
            check_import("numpy", "1.24"),
            check_import("jax", "0.4"),
            check_import("merpcr_tpu"),
        ],
        "conflicts": check_conflicts(),
        "native_toolchain": {
            "g++": shutil.which("g++") is not None,
        },
        "env": {
            k: v
            for k, v in os.environ.items()
            if k.startswith(("JAX_", "XLA_", "MERPCR_"))
        },
        "compile_cache_writable": os.access(
            cache_dir if os.path.isdir(cache_dir) else os.path.dirname(cache_dir),
            os.W_OK,
        ),
    }
    try:
        import jax

        report["jax_backend"] = jax.default_backend()
        report["jax_devices"] = [str(d) for d in jax.devices()]
    except Exception as e:
        report["jax_backend"] = f"error: {e}"

    try:
        from merpcr_tpu.native import get_lib

        report["native_codec"] = get_lib() is not None
    except Exception as e:
        report["native_codec"] = f"error: {e}"

    report["functional"] = check_functional()

    ok = (
        report["python_ok"]
        and all(c["ok"] for c in report["checks"])
        and all(c["ok"] for c in report["conflicts"])
        and report["platform"]["supported"]
        and report["functional"]["ok"]
    )
    report["ok"] = ok
    if not quiet:
        print(json.dumps(report, indent=2))
    else:
        print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
