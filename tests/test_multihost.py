"""Multi-host orchestration tests (SURVEY.md §2.3).

The reference fans out across a local process pool inside ``search``
(reference engine.py:414-434); the equivalent here is
``MerPCR.enable_multihost()`` — jax.distributed init + a global device
mesh + host-0-gated emission. Validated here three ways:

* the single-process no-op path (initialize() is a logged no-op, host 0
  emits, output byte-identical to the plain single-device engine);
* the CLI ``--multihost`` flag on the same oracle;
* a REAL 2-process ``jax.distributed`` run over loopback (CPU backend,
  2 local devices per process -> a 4-device global mesh), asserting host 0's
  output equals the single-process ground truth and host 1 writes nothing.
"""

import os
import random
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import merpcr_tpu
from merpcr_tpu.parallel import distributed

from .conftest import run_search

pytestmark = [pytest.mark.integration, pytest.mark.parallel]

BASES = "ACGT"


def _corpus(tmp_path, n=30000, seed=5):
    rng = random.Random(seed)
    g = list("".join(rng.choices(BASES, k=n)))
    p1 = "GGCTCAGAGTATTTGGGATGCA"
    p2 = "CTCTTGGAATCCTATCTCACTG"
    prod = 200
    for pos in (500, 9000, 21000, n - prod - 3):
        g[pos : pos + len(p1)] = p1
        g[pos + prod - len(p2) : pos + prod] = p2
    sts = tmp_path / "m.sts"
    fa = tmp_path / "m.fa"
    sts.write_text(f"S1\t{p1}\t{p2}\t{prod}\nS2\t{p2}\t{p1}\t300\n")
    body = "".join(g)
    fa.write_text(
        ">mh multihost corpus\n"
        + "\n".join(body[i : i + 70] for i in range(0, n, 70))
        + "\n"
    )
    return str(sts), str(fa)


def test_single_process_noop(tmp_path):
    """enable_multihost() on a single process: initialize() must be a
    logged no-op, this process is the output host, and output is
    byte-identical to the plain single-device engine."""
    sts, fa = _corpus(tmp_path)
    base = merpcr_tpu.MerPCR()
    assert base.load_sts_file(sts)
    recs = base.load_fasta_file(fa)
    want = run_search(base, recs)
    assert want.count("\n") >= 4

    eng = merpcr_tpu.MerPCR().enable_multihost()
    assert eng._multihost and eng.mesh is not None
    assert distributed.is_output_host()
    assert eng.load_sts_file(sts)
    got = run_search(eng, recs)
    assert got == want


def test_cli_multihost_flag(tmp_path, capsys):
    """--multihost on a single host: same exit code and bytes as without."""
    from merpcr_tpu.cli import main

    sts, fa = _corpus(tmp_path, seed=6)
    assert main([sts, fa]) == 0
    plain = capsys.readouterr().out
    assert main([sts, fa, "--multihost"]) == 0
    flagged = capsys.readouterr().out
    assert plain == flagged and plain.count("\n") >= 4


_WORKER = textwrap.dedent(
    """
    import os, sys
    pid, port, sts, fa, out = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["MERPCR_TPU_CACHE"] = "0"
    sys.path.insert(0, sys.argv[6])
    import jax
    jax.config.update("jax_num_cpu_devices", 2)
    import merpcr_tpu
    eng = merpcr_tpu.MerPCR().enable_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert eng.load_sts_file(sts)
    hits = eng.search(eng.load_fasta_file(fa), out)
    print(f"WORKER {pid} hits={hits}", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.skipif(
    sys.platform == "win32",
    reason="jax.distributed loopback coordinator is not supported on "
    "Windows runners; the mesh/multihost logic is covered by the "
    "in-process gating tests above",
)
def test_two_process_distributed(tmp_path):
    """Real jax.distributed over loopback: 2 processes x 2 CPU devices.

    Host 0's output file must equal the single-process ground truth;
    host 1's must stay empty (emission gated by is_output_host); both
    processes must agree on the hit count (the all_gather merge is
    replicated)."""
    sts, fa = _corpus(tmp_path, seed=7)
    base = merpcr_tpu.MerPCR()
    assert base.load_sts_file(sts)
    want = run_search(base, base.load_fasta_file(fa))
    assert want.count("\n") >= 4

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = [str(tmp_path / f"out{i}.txt") for i in (0, 1)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_FLAGS")}

    # _free_port() has an inherent bind-then-release race (another process
    # can grab the port before the coordinator binds it), and a loaded box
    # can push two cold-start jax processes past a tight deadline — retry
    # once on a FRESH port before calling the run a failure.
    for attempt in (0, 1):
        port = _free_port()
        for o in outs:
            if os.path.exists(o):
                os.unlink(o)
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(i), str(port), sts, fa,
                 outs[i], repo],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env,
            )
            for i in (0, 1)
        ]
        try:
            results = [p.communicate(timeout=420) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            if attempt == 0:
                continue
            raise
        if all(p.returncode == 0 for p in procs):
            break
        if attempt == 0:
            continue
        for i, p in enumerate(procs):
            assert p.returncode == 0, (
                i, results[i][0][-2000:], results[i][1][-2000:]
            )
    counts = [
        line for r in results for line in r[0].splitlines() if line.startswith("WORKER")
    ]
    assert len(counts) == 2 and len({c.split("hits=")[1] for c in counts}) == 1, counts

    with open(outs[0]) as fh:
        assert fh.read() == want
    # host 1 opened /dev/null instead — its file must not even exist
    assert not os.path.exists(outs[1])
