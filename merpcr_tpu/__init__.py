"""merpcr_tpu — an accelerated electronic-PCR (STS marker mapping) framework.

Built from scratch in JAX/XLA (run on NVIDIA GPUs), with the full capabilities of the
reference merPCR tool (FOI-Bioinformatics/merpcr): mapping STS markers
(primer pairs + expected amplicon size) onto genomic FASTA sequences with
me-PCR-compatible flags, semantics, and byte-identical tab-delimited output.

Public API mirrors the reference's ``src/merpcr/__init__.py:7-14``:
``MerPCR``, ``STSRecord``, ``FASTARecord``, ``STSHit``.
"""

import os as _os

if _os.environ.get("MERPCR_TPU_PLATFORM"):
    # Honor an explicit platform override (e.g. "cpu" for tests/subprocesses)
    # before any backend initializes.
    import jax as _jax

    try:
        _jax.config.update("jax_platforms", _os.environ["MERPCR_TPU_PLATFORM"])
    except Exception:
        pass

from .engine import MerPCR
from .models import FASTARecord, STSHit, STSRecord

__version__ = "1.4.0"

__all__ = ["MerPCR", "STSRecord", "FASTARecord", "STSHit", "__version__"]
