"""CPU tests of chip_smoke.py: its device guard, its comparison helper and
its phases at tiny sizes (the script itself needs a GPU)."""

import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

CARD = "cpu test run"


def test_phase0_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_script_exits_nonzero_without_gpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_check_same_names_first_difference():
    chip_smoke.check_same("same", "a\nb\n", "a\nb\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="line 1: got 'c'"):
        chip_smoke.check_same("diff", "a\nc\n", "a\nb\n")
    with pytest.raises(chip_smoke.SmokeFailure, match="1 lines vs 2"):
        chip_smoke.check_same("short", "a\n", "a\nb\n")


@pytest.mark.parametrize(
    "phase, kwargs",
    [
        (chip_smoke.phase_chromosome, dict(mbp=0.2, nsts=60, planted=10)),
        (chip_smoke.phase_stream,
         dict(mbp=0.2, nsts=60, records=40, planted=10)),
        (chip_smoke.phase_flood, dict(mbp=0.05, nsts=200, planted=5)),
    ],
    ids=["chromosome", "stream", "flood"],
)
def test_phase_matches_reference_tiny(tmp_path, capsys, monkeypatch, phase,
                                      kwargs):
    """Each phase at a tiny size on the CPU: device output equals the
    lifted-cap host reference and the phase reports its route."""
    monkeypatch.setattr(chip_smoke, "WARM", 1)
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    phase(str(tmp_path), CARD, **kwargs)
    out = capsys.readouterr().out
    assert "route=" in out and f"[{CARD}]" in out


def test_device_route_rejects_host_search(tmp_path, monkeypatch):
    sts, fa, _n = chip_smoke.bench.gen_data(str(tmp_path), 0.01, 10)
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "100000000")
    eng, recs = chip_smoke.load(sts, fa)
    chip_smoke.search_output(eng, recs)
    with pytest.raises(chip_smoke.SmokeFailure, match="host route"):
        chip_smoke.device_route(eng)


def test_mesh_phase_matches_reference_tiny(tmp_path, capsys, monkeypatch):
    """The --four phase on four virtual CPU devices: mesh output equals
    the one-device run and the host reference for every case."""
    monkeypatch.setattr(chip_smoke, "WARM", 1)
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    chip_smoke.phase_mesh(
        str(tmp_path), CARD, jax.devices()[:4],
        chrom=(0.1, 40, 8), stream=(0.1, 40, 8, 20),
    )
    out = capsys.readouterr().out
    assert out.count("phase mesh 4 devices") == 5
