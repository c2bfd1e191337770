"""Fault injection and malformed-input tests (mirrors reference
tests/test_error_injection.py strategy: I/O failures — PermissionError /
ENOSPC / EMFILE — MemoryError, corrupted and binary inputs, recovery from
mixed good/bad data; reference :31-236 and :315-501), plus device-specific
faults the reference has no analogue for: device OOM at table build and
the tile-capacity escalation path (engine._rescan_tile), including its
RuntimeError exhaustion guard."""

import errno
import os
import random
from unittest import mock

import pytest

import merpcr_tpu
from merpcr_tpu.cli import main
from .conftest import (
    GOLDEN_FA,
    GOLDEN_STS,
    have_oracle,
    needs_golden,
    needs_oracle,
    oracle_engine,
    run_search,
)

pytestmark = pytest.mark.integration

P1 = "GGCTCAGAGTATTTGGGATG"
P2 = "CTCTTGGAATCCTATCTCACTG"


class TestSTSFileErrors:
    def test_nonexistent_file_raises_to_cli(self, tmp_fa):
        fa = tmp_fa(">s\nACGT\n")
        assert main(["/nonexistent/path.sts", fa]) == 1

    def test_permission_denied(self, tmp_sts, tmp_fa):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa(">s\nACGT\n")
        real_open = open

        def deny(path, *a, **k):
            if str(path) == sts:
                raise PermissionError("denied")
            return real_open(path, *a, **k)

        with mock.patch("builtins.open", side_effect=deny):
            assert main([sts, fa]) == 1

    def test_binary_garbage_sts(self, tmp_path, tmp_fa):
        p = tmp_path / "bin.sts"
        p.write_bytes(bytes(range(256)) * 4)
        fa = tmp_fa(">s\nACGT\n")
        # binary junk has no 4-field tab lines -> load fails -> exit 1
        assert main([str(p), fa]) == 1

    def test_mixed_good_bad_lines_fail_whole_load(self, tmp_sts):
        eng = merpcr_tpu.MerPCR()
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\nnot a valid line\n")
        assert eng.load_sts_file(sts) is False
        assert eng.sts_records == []


class TestFASTAErrors:
    def test_nonexistent_fasta(self, tmp_sts):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        assert main([sts, "/nonexistent/genome.fa"]) == 1

    def test_empty_fasta(self, tmp_sts, tmp_fa):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa("")
        assert main([sts, fa]) == 1  # loader returns [] -> exit 1

    def test_fasta_only_garbage_chars(self, tmp_sts, tmp_fa):
        eng = merpcr_tpu.MerPCR()
        eng.load_sts_file(tmp_sts(f"S1\t{P1}\t{P2}\t200\n"))
        recs = eng.load_fasta_file(tmp_fa(">s\n0123456789!@#$\n"))
        assert len(recs) == 1 and recs[0].sequence == ""
        assert run_search(eng, recs) == ""


@needs_golden
class TestOutputErrors:
    def test_unwritable_output_file(self):
        rc = main([GOLDEN_STS, GOLDEN_FA, "-O", "/nonexistent_dir/out.txt"])
        assert rc == 1

    def test_output_write_failure_mid_search(self, tmp_path):
        eng = merpcr_tpu.MerPCR()
        assert eng.load_sts_file(GOLDEN_STS)
        recs = eng.load_fasta_file(GOLDEN_FA)
        out = tmp_path / "o.txt"
        with mock.patch("builtins.print", side_effect=OSError("disk full")):
            with pytest.raises(OSError):
                eng.search(recs, str(out))

    def test_disk_full_enospc_during_output(self, tmp_path):
        """ENOSPC mid-emission (reference :125-153): the errno must
        propagate (no silent hit loss) and the CLI must exit 1."""
        eng = merpcr_tpu.MerPCR()
        assert eng.load_sts_file(GOLDEN_STS)
        recs = eng.load_fasta_file(GOLDEN_FA)
        err = OSError(errno.ENOSPC, "No space left on device")
        with mock.patch("builtins.print", side_effect=err):
            with pytest.raises(OSError) as ei:
                eng.search(recs, str(tmp_path / "o.txt"))
        assert ei.value.errno == errno.ENOSPC
        with mock.patch("builtins.print", side_effect=err):
            assert main([GOLDEN_STS, GOLDEN_FA, "-O", str(tmp_path / "p.txt")]) == 1


class TestResourceExhaustion:
    """Reference :115-236 and :415-470: EMFILE / MemoryError injection."""

    def test_fd_exhaustion_during_sts_load(self, tmp_sts, tmp_fa):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa(">s\nACGT\n")
        real_open = open
        state = {"n": 0}

        def limited(path, *a, **k):
            state["n"] += 1
            if str(path) == sts:
                raise OSError(errno.EMFILE, "Too many open files")
            return real_open(path, *a, **k)

        with mock.patch("builtins.open", side_effect=limited):
            assert main([sts, fa]) == 1  # clean exit, not a crash

    def test_memory_error_during_sts_load(self, tmp_sts, tmp_fa):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa(">s\nACGT\n")
        real_open = open

        class OOMFile:
            def __init__(self, fh):
                self._fh = fh

            def __enter__(self):
                return self

            def __exit__(self, *a):
                self._fh.close()

            def __iter__(self):
                raise MemoryError("Out of memory")

            def read(self, *a):
                raise MemoryError("Out of memory")

            def readlines(self, *a):
                raise MemoryError("Out of memory")

        def oom_open(path, *a, **k):
            fh = real_open(path, *a, **k)
            if str(path) == sts:
                return OOMFile(fh)
            return fh

        with mock.patch("builtins.open", side_effect=oom_open):
            assert main([sts, fa]) == 1

    def test_memory_error_during_fasta_load(self, tmp_sts, tmp_fa):
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa(">s\nACGTACGT\n")
        import merpcr_tpu.io.fasta as fasta_mod

        with mock.patch.object(
            fasta_mod.FASTALoader,
            "load_file",
            side_effect=MemoryError("Cannot allocate memory for large sequence"),
        ):
            assert main([sts, fa]) == 1

    def test_partial_file_read_error(self, tmp_sts, tmp_fa):
        """I/O error mid-read (reference :93-113): clean CLI failure."""
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        fa = tmp_fa(">s\nACGT\n")
        real_open = open

        class FlakyFile:
            def __init__(self, fh):
                self._fh = fh

            def __enter__(self):
                return self

            def __exit__(self, *a):
                self._fh.close()

            def __iter__(self):
                yield f"S1\t{P1}\t{P2}\t200\n"
                raise OSError(errno.EIO, "Input/output error")

            def read(self, *a):
                raise OSError(errno.EIO, "Input/output error")

            def readlines(self, *a):
                raise OSError(errno.EIO, "Input/output error")

        def flaky_open(path, *a, **k):
            fh = real_open(path, *a, **k)
            if str(path) == sts:
                return FlakyFile(fh)
            return fh

        with mock.patch("builtins.open", side_effect=flaky_open):
            assert main([sts, fa]) == 1


class TestDataCorruption:
    """Corrupted-input variants (reference :315-402) — asserted as ORACLE
    PARITY, not just 'does not crash': the loaders must accept/reject and
    count records exactly like the reference."""

    STS_VARIANTS = [
        "TEST\t\t\t\n",  # empty fields
        "TEST\tATCGATCGATCG\n",  # missing fields -> whole load fails
        f"TEST\t{P1}\t{P2}\tNOT_A_NUMBER\n",  # bad size -> default Z
        f"TEST\t{P1}\t{P2}\t-100\n",  # negative size -> default Z
        f"\t{P1}\t{P2}\t100\n",  # empty ID (allowed)
        f"TEST\t\t{P2}\t100\n",  # empty primer1 -> too short
        f"TEST\t{P1}\t\t100\n",  # empty primer2 -> too short
        f"TEST\tXXXXXXXXXXXXXXXX\t{P2}\t100\n",  # no valid W-mer in p1
        f"TEST\t{P1}\t{P2}\t100\textra\tfields\tok\n",  # >4 fields
        "\x00\x01\x02\t\x03\t\x04\t100\n",  # control bytes
    ]

    @needs_oracle
    @pytest.mark.parametrize("idx", range(len(STS_VARIANTS)))
    def test_corrupted_sts_matches_oracle(self, idx, tmp_sts):
        text = self.STS_VARIANTS[idx]
        sts = tmp_sts(text)
        ours = merpcr_tpu.MerPCR()
        ref = oracle_engine()
        ok_ours = ours.load_sts_file(sts)
        ok_ref = ref.load_sts_file(sts)
        assert ok_ours == ok_ref, text
        assert len(ours.sts_records) == len(ref.sts_records), text

    FASTA_VARIANTS = [
        "not a fasta file\n",
        ">seq1\n",  # header without sequence
        "ATCGATCG\n",  # sequence without header
        ">seq1\nATCG\n>seq2\n",  # incomplete second entry
        ">seq1\nATCGXYZ123\n",  # invalid chars filtered
        ">\n\nATCGATCG\n",  # empty header
        ">a\r\nAC\r\nGT\r\n",  # CRLF endings
    ]

    @needs_oracle
    @pytest.mark.parametrize("idx", range(len(FASTA_VARIANTS)))
    def test_corrupted_fasta_matches_oracle(self, idx, tmp_fa):
        text = self.FASTA_VARIANTS[idx]
        fa = tmp_fa(text)
        ours = merpcr_tpu.MerPCR().load_fasta_file(fa)
        try:
            ref = oracle_engine().load_fasta_file(fa)
        except IndexError:
            # The reference CRASHES on an empty defline (models.py:49
            # `defline.split()[0]` -> IndexError; reproduced on the ">\n"
            # variant). That is an unintended bug, not contract: we only
            # require graceful handling here — a well-formed record list.
            assert all(isinstance(r.sequence, str) for r in ours), text
            return
        assert [(r.label, r.sequence) for r in ours] == [
            (r.label, r.sequence) for r in ref
        ], text

    def test_binary_fasta_file(self, tmp_path, tmp_sts):
        """Binary garbage as FASTA (reference :402-430): graceful result —
        a clean CLI failure or an empty/parsed record list, never a crash."""
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        p = tmp_path / "bin.fa"
        p.write_bytes(bytes(range(256)) * 8)
        rc = main([sts, str(p)])
        assert rc in (0, 1)

    def test_binary_sts_matches_oracle_when_decodable(self, tmp_path):
        """Binary STS bytes that happen to decode: load must fail cleanly
        (no 4-field tab lines) in both implementations."""
        p = tmp_path / "bin.sts"
        p.write_bytes(bytes(b % 128 for b in range(512)))
        ours = merpcr_tpu.MerPCR()
        try:
            ok = ours.load_sts_file(str(p))
        except UnicodeDecodeError:
            ok = False
        assert not ok


class TestTPUFaults:
    """Device-side fault injection — no reference analogue (SURVEY.md §5:
    the reference has no runtime recovery; these cover this engine's own
    failure surfaces)."""

    def _hitty_corpus(self, tmp_path):
        """A corpus producing many hits (margin window repeats)."""
        rng = random.Random(3)
        g = list("".join(rng.choices("ACGT", k=4000)))
        prod = 120
        for pos in (200, 900, 1700, 2500, 3300):
            g[pos : pos + len(P1)] = P1
            # several non-overlapping primer2 sites inside the +/-60 margin
            for off in (0, 25, 50):
                s = pos + prod - len(P2) + off
                g[s : s + len(P2)] = P2
        sts = tmp_path / "h.sts"
        fa = tmp_path / "h.fa"
        sts.write_text(f"S1\t{P1}\t{P2}\t{prod}\n")
        body = "".join(g)
        fa.write_text(
            ">h hitty\n"
            + "\n".join(body[i : i + 70] for i in range(0, len(body), 70))
            + "\n"
        )
        return str(sts), str(fa)

    def test_device_oom_at_table_build_fails_cleanly(self, tmp_sts, tmp_fa):
        """RESOURCE_EXHAUSTED while shipping the table to HBM: the CLI
        must fail with exit 1, not a traceback crash."""
        sts = tmp_sts(f"S1\t{P1}\t{P2}\t200\n")
        # long enough to actually dispatch a device scan (the table ships
        # to HBM lazily on first dispatch; sub-wordsize records skip it)
        fa = tmp_fa(">s\n" + "ACGT" * 64 + "\n")
        # the host->device conversion happens lazily in the engine's
        # _table property (jnp.asarray per field) — patch the jnp module
        import jax.numpy as jnp_mod

        err = RuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory allocating 33554432 bytes"
        )
        with mock.patch.object(jnp_mod, "asarray", side_effect=err):
            assert main([sts, fa]) == 1

    def test_forced_escalation_keeps_output_exact(self, tmp_path, monkeypatch):
        """Shrink every capacity so tiles overflow and _rescan_tile must
        escalate repeatedly — the no-hit-dropped invariant (CLAUDE.md #4):
        output must stay byte-identical to an untampered engine."""
        sts, fa = self._hitty_corpus(tmp_path)
        clean = merpcr_tpu.MerPCR(margin=60)
        assert clean.load_sts_file(sts)
        recs = clean.load_fasta_file(fa)
        want = run_search(clean, recs)
        assert want.count("\n") >= 10  # really a hit-dense corpus

        from merpcr_tpu.engine import MerPCR
        from merpcr_tpu.ops.scan import ScanConfig

        real_base = MerPCR._base_config
        n_escalations = {"n": 0}

        def tiny_base(self, tile_len, packed=True, **kw):
            cfg = real_base(self, tile_len, packed=packed, **kw)
            return ScanConfig(
                **{
                    **cfg.__dict__,
                    "cand_cap": 2,
                    "anch_cap": 1,
                    "hit_cap": 1,
                }
            )

        real_escalate = ScanConfig.escalate_measured

        def counting_escalate(self, *meas, **kw):
            cfg = real_escalate(self, *meas, **kw)
            if cfg is not None:  # a real escalation (some stage grew)
                n_escalations["n"] += 1
                # caps stay bounded by the measured workload scaled by
                # the worst upstream truncation ratio (downstream totals
                # are lower bounds while an upstream stage truncates),
                # rounded up to the next power of two (>= 1024)
                ratio = max(
                    [1.0]
                    + [
                        t / float(cap)
                        for t, cap in zip(
                            meas,
                            (self.cpos_cap, self.pos_cap, self.cand_cap,
                             self.anch_cap, self.hit_cap),
                        )
                        if t > cap
                    ]
                )
                p2 = 1024
                while p2 < max(meas) * ratio:
                    p2 <<= 1
                for k in ("cand_cap", "anch_cap", "hit_cap"):
                    assert getattr(cfg, k) <= max(getattr(self, k), p2)
            return cfg

        monkeypatch.setattr(MerPCR, "_base_config", tiny_base)
        monkeypatch.setattr(ScanConfig, "escalate_measured", counting_escalate)
        eng = merpcr_tpu.MerPCR(margin=60)
        assert eng.load_sts_file(sts)
        got = run_search(eng, recs)
        assert got == want
        assert n_escalations["n"] >= 1  # escalation really happened
        # measured escalation converges in one retry per overflowing tile:
        # every retry must end within the engine's safety bound
        assert eng._rescan_count <= 2 * n_escalations["n"]

    def test_escalation_exhaustion_raises(self, tmp_path, monkeypatch):
        """When escalation cannot converge, the engine must raise (never
        silently truncate hits): MAX_ESCALATIONS=0 forces the
        engine._rescan_tile RuntimeError path."""
        sts, fa = self._hitty_corpus(tmp_path)
        import merpcr_tpu.engine as engine_mod
        from merpcr_tpu.engine import MerPCR
        from merpcr_tpu.ops.scan import ScanConfig

        real_base = MerPCR._base_config

        def tiny_base(self, tile_len, packed=True, **kw):
            cfg = real_base(self, tile_len, packed=packed, **kw)
            return ScanConfig(**{**cfg.__dict__, "hit_cap": 1})

        monkeypatch.setattr(MerPCR, "_base_config", tiny_base)
        monkeypatch.setattr(engine_mod, "MAX_ESCALATIONS", 0)
        eng = merpcr_tpu.MerPCR(margin=60)
        assert eng.load_sts_file(sts)
        recs = eng.load_fasta_file(fa)
        with pytest.raises(RuntimeError, match="escalation"):
            run_search(eng, recs)

    def test_escalation_exhaustion_clean_cli_exit(self, tmp_path, monkeypatch):
        """The same failure through the CLI: exit code 1, no crash."""
        sts, fa = self._hitty_corpus(tmp_path)
        import merpcr_tpu.engine as engine_mod
        from merpcr_tpu.engine import MerPCR
        from merpcr_tpu.ops.scan import ScanConfig

        real_base = MerPCR._base_config

        def tiny_base(self, tile_len, packed=True, **kw):
            cfg = real_base(self, tile_len, packed=packed, **kw)
            return ScanConfig(**{**cfg.__dict__, "hit_cap": 1})

        monkeypatch.setattr(MerPCR, "_base_config", tiny_base)
        monkeypatch.setattr(engine_mod, "MAX_ESCALATIONS", 0)
        assert main([sts, fa]) == 1
