#!/usr/bin/env python3
"""GPU smoke test: the e-PCR scan's main path on the card, checked byte for byte.

Drives the entry points a user calls — ``merpcr_tpu.cli.main`` and
``MerPCR.load_sts_file`` / ``load_fasta_file`` / ``search`` — at
chromosome scale, and compares every output with the plain NumPy
reference (``ops.host_scan.host_scan_record`` with its small-input caps
lifted), formatted by the engine's own emitter. Data is generated from a
fixed seed (``bench.gen_data``).

Phases, all in this one process (it never starts another JAX process):

  0. device: JAX's first device must be a GPU; there is no CPU fallback;
  1. the golden STS/FASTA pair through the CLI, device route forced;
  2. 47 Mbp single record x 1,000 STS (W=11 M=50 N=0 X=1, 200 planted
     amplicons) on the device route, then -N 1, -I 1 and -M 1000 on the
     same records;
  3. 30 Mbp as 3,000 records: the gap-separated stream path;
  4. flood content (low-complexity genome, repeat-bearing primers) at
     FLOOD_MBP Mbp: capacity escalation must run on the card.

``--four`` runs phase 0 and then phases 2 and 3 on a 4-GPU mesh instead,
each checked against the 1-GPU run and the reference; per-device peak
memory shows whether anything piles up on the first card.

Each phase prints its hits, first-search time (compile included), the
median of WARM warm searches in Mbp/s and the route taken, beside the
card's name and power limit. The last line is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any mismatch
or error exits non-zero before it.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import merpcr_tpu  # noqa: E402
from merpcr_tpu.io.fasta import record_seq_bytes  # noqa: E402
from merpcr_tpu.ops.host_scan import host_scan_record  # noqa: E402

GOLDEN_STS = os.path.join(REPO, "tests", "data", "test.sts")
GOLDEN_FA = os.path.join(REPO, "tests", "data", "test.fa")
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"

WARM = 3
# Flood size: the host reference's Python candidate loop takes under a
# minute here (about 30 s on one x86 core), and the device side still
# overflows its first-dispatch capacities and escalates.
FLOOD_MBP = 0.75
# Phase 2's flag variants on the same records: (label, MerPCR overrides).
CHROMOSOME_CASES = (
    ("N=0", {}),
    ("-N 1", {"mismatches": 1}),
    ("-I 1", {"iupac_mode": 1}),
    ("-M 1000", {"margin": 1000}),
)
BASE_PARAMS = dict(wordsize=11, margin=50, mismatches=0, three_prime_match=1)


class SmokeFailure(Exception):
    """A phase's output or route was wrong; the run must exit non-zero."""


def require_gpu(devices) -> None:
    """Phase 0: refuse anything but a GPU as JAX's first device."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SmokeFailure(f"phase 0: needs a GPU; JAX's first device is {platform}")


def card_labels() -> list[str]:
    """One "name, power limit" line per card, as nvidia-smi reports it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


@contextlib.contextmanager
def host_max(value: str):
    """Set MERPCR_TPU_HOST_MAX (the host-route threshold) for a block;
    "0" forces the device route on inputs of any size."""
    old = os.environ.get("MERPCR_TPU_HOST_MAX")
    os.environ["MERPCR_TPU_HOST_MAX"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MERPCR_TPU_HOST_MAX")
        else:
            os.environ["MERPCR_TPU_HOST_MAX"] = old


def check_same(what: str, got: str, want: str) -> None:
    """Raise SmokeFailure naming the first differing line."""
    if got == want:
        return
    g, w = got.splitlines(), want.splitlines()
    i = next(
        (k for k, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w))
    )
    raise SmokeFailure(
        f"{what}: {len(g)} lines vs {len(w)} in the reference; first "
        f"difference at line {i}: got {g[i] if i < len(g) else '<end>'!r}, "
        f"want {w[i] if i < len(w) else '<end>'!r}"
    )


def reference_output(eng, records) -> str:
    """The plain NumPy scan of every record (caps lifted), emitted as the
    engine emits device hits."""
    buf = io.StringIO()
    for rec in records:
        rows = host_scan_record(
            eng._table_host, eng._meta, record_seq_bytes(rec),
            eng.margin, eng.mismatches, eng.three_prime_match, capped=False,
        )
        eng.emit_hits(rec.label, rows, buf)
    return buf.getvalue()


def search_output(eng, records) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng.search(records, None)
    return buf.getvalue()


def timed(run):
    """(output, first-call seconds, WARM warm-call seconds); every warm
    call must repeat the first call's output exactly."""
    t0 = time.perf_counter()
    out = run()
    first = time.perf_counter() - t0
    warm_s = []
    for _ in range(WARM):
        t0 = time.perf_counter()
        again = run()
        warm_s.append(time.perf_counter() - t0)
        check_same("warm repeat", again, out)
    return out, first, warm_s


def device_route(eng) -> str:
    """Plan item kinds of the engine's last device-planned search; fails
    when the search was served by the host route."""
    pc = getattr(eng, "_plan_cache", None)
    if pc is None:
        raise SmokeFailure("the search took the host route, not the device")
    return "+".join(sorted({item[0] for item in pc[1]}))


def report(phase: str, mbp: float, out: str, first: float, warm: list,
           route: str, card: str, extra: str = "") -> float:
    med = statistics.median(warm)
    print(
        f"phase {phase}: hits={out.count(chr(10))} first_search_s={first:.6f} "
        f"warm_median_s={med:.6f} rate_Mbp_per_s={mbp / med:.6f} "
        f"route={route}{extra} [{card}]",
        flush=True,
    )
    return med


def scan_case(phase: str, eng, records, mbp: float, card: str,
              want_route: str | None = None) -> tuple[str, float]:
    """Device search of ``records`` (warm-timed) checked against the
    reference; returns the output and the warm median in seconds."""
    t0 = time.perf_counter()
    ref = reference_output(eng, records)
    ref_s = time.perf_counter() - t0
    out, first, warm = timed(lambda: search_output(eng, records))
    route = device_route(eng)
    if want_route is not None and route != want_route:
        raise SmokeFailure(f"phase {phase}: route {route}, expected {want_route}")
    check_same(f"phase {phase}", out, ref)
    med = report(phase, mbp, out, first, warm, route, card,
                 f" reference_s={ref_s:.6f}")
    return out, med


def load(sts: str, fa: str, records=None, **params):
    eng = merpcr_tpu.MerPCR(**{**BASE_PARAMS, **params})
    if not eng.load_sts_file(sts):
        raise SmokeFailure(f"STS load failed: {sts}")
    return eng, records if records is not None else eng.load_fasta_file(fa)


def phase_golden(card: str) -> None:
    from merpcr_tpu import cli

    def run():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([GOLDEN_STS, GOLDEN_FA])
        if rc != 0:
            raise SmokeFailure(f"phase 1: CLI exit code {rc}")
        return buf.getvalue()

    with host_max("0"):
        out, first, warm = timed(run)
    check_same("phase 1 golden CLI", out, GOLDEN_LINE + "\n")
    _eng, recs = load(GOLDEN_STS, GOLDEN_FA)
    mbp = sum(len(r.sequence) for r in recs) / 1e6
    report("1 golden CLI", mbp, out, first, warm, "device (HOST_MAX=0)", card)


def phase_chromosome(td: str, card: str, mbp: float = 47.0, nsts: int = 1000,
                     planted: int = 200, cases=CHROMOSOME_CASES) -> None:
    sts, fa, n = bench.gen_data(td, mbp, nsts, planted=planted)
    records = None
    for label, params in cases:
        eng, records = load(sts, fa, records, **params)
        out, med = scan_case(f"2 chromosome {label}", eng, records, n / 1e6,
                             card, want_route="single")
        if label == "N=0" and out.count("\n") < planted:
            raise SmokeFailure(
                f"phase 2: {out.count(chr(10))} hits < {planted} planted"
            )
        total_scan = n - eng.wordsize + 1
        tile_len = eng._pick_tile_len(total_scan)
        tiles = -(-total_scan // tile_len)
        print(f"phase 2 tiles {label}: {tiles} tiles of {tile_len} positions, "
              f"warm_ms_per_tile={1e3 * med / tiles:.6f} [{card}]", flush=True)


def phase_stream(td: str, card: str, mbp: float = 30.0, nsts: int = 1000,
                 records: int = 3000, planted: int = 200) -> None:
    sts, fa, n = bench.gen_data(td, mbp, nsts, planted=planted,
                                n_records=records)
    eng, recs = load(sts, fa)
    scan_case("3 stream", eng, recs, n / 1e6, card, want_route="stream")


def phase_flood(td: str, card: str, mbp: float = FLOOD_MBP,
                nsts: int = 1000, planted: int = 20) -> None:
    sts, fa, n = bench.gen_data(td, mbp, nsts, planted=planted,
                                content="lowcomplex", stsgen="repeat")
    eng, recs = load(sts, fa)
    with host_max("0"):
        scan_case(f"4 flood {mbp} Mbp", eng, recs, n / 1e6, card)
    if eng._rescan_count < 1:
        raise SmokeFailure("phase 4: no capacity rescan ran on the card")
    print(f"phase 4 rescans: {eng._rescan_count} over {1 + WARM} searches "
          f"[{card}]", flush=True)


def phase_mesh(td: str, card: str, devices, chrom=(47.0, 1000, 200),
               stream=(30.0, 1000, 200, 3000)) -> None:
    """Phases 2 and 3 on a 4-device mesh vs one device and the reference.
    ``chrom`` = (Mbp, STS, planted); ``stream`` adds the record count."""
    from merpcr_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(devices[:4])
    sub = os.path.join(td, "stream")
    os.makedirs(sub)
    chrom_data = bench.gen_data(td, chrom[0], chrom[1], planted=chrom[2])
    stream_data = bench.gen_data(sub, stream[0], stream[1], planted=stream[2],
                                 n_records=stream[3])
    runs = [("chromosome " + lbl, chrom_data, p, "single")
            for lbl, p in CHROMOSOME_CASES]
    runs.append(("stream", stream_data, {}, "stream"))
    records, fours = {}, []
    for label, (sts, fa, n), params, route in runs:
        eng4, records[fa] = load(sts, fa, records.get(fa), **params)
        eng4.use_mesh(mesh)
        four, first, warm = timed(lambda: search_output(eng4, records[fa]))
        got_route = device_route(eng4)
        if got_route != route:
            raise SmokeFailure(f"mesh {label}: route {got_route}, not {route}")
        report(f"mesh 4 devices {label}", n / 1e6, four, first, warm, route,
               card)
        fours.append(four)
    # read before the one-device runs, which only use the first card
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices[:4]]
    print(f"mesh peak_bytes_in_use per device: {peaks} [{card}]", flush=True)
    for (label, (sts, fa, n), params, route), four in zip(runs, fours):
        eng1, recs = load(sts, fa, records[fa], **params)
        one, first, warm = timed(lambda: search_output(eng1, recs))
        check_same(f"mesh {label} vs reference", four,
                   reference_output(eng1, recs))
        check_same(f"mesh {label} vs 1 device", four, one)
        report(f"mesh 1 device {label}", n / 1e6, one, first, warm, route,
               card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run phases 2 and 3 on a 4-GPU mesh (needs 4 cards)")
    args = ap.parse_args(argv)

    import jax

    t_start = time.perf_counter()
    devices = jax.devices()
    require_gpu(devices)
    count = 4 if args.four else 1
    if len(devices) < count:
        raise SmokeFailure(f"--four needs 4 GPUs, JAX sees {len(devices)}")
    labels = card_labels()
    for i, lbl in enumerate(labels[:count]):
        print(f"card {i}: {lbl}", flush=True)
    card = labels[0]
    with tempfile.TemporaryDirectory() as td:
        if args.four:
            phase_mesh(td, card, devices)
        else:
            phase_golden(card)
            for phase in (phase_chromosome, phase_stream, phase_flood):
                sub = os.path.join(td, phase.__name__)
                os.makedirs(sub)
                phase(sub, card)
    print(f"total_s={time.perf_counter() - t_start:.6f} [{card}]", flush=True)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
