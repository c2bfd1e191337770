"""Differential fuzzer: merpcr_tpu vs the reference merpcr (run as oracle).

Generates random STS sets + genomes (with planted amplicons so hits are
common), runs both engines in-process, and compares stdout byte-for-byte.

Usage: MERPCR_REFERENCE_SRC=<reference>/src JAX_PLATFORMS=cpu \
           python tools/difffuzz.py [n_cases] [seed]
"""

from __future__ import annotations

import io
import os
import random
import sys
import tempfile
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import merpcr_tpu as eng_pkg  # noqa: E402
import workloads  # noqa: E402  (realistic/adversarial content generators)

def load_reference():
    """Import the reference merpcr package (the oracle) from the directory
    MERPCR_REFERENCE_SRC names. Only the fuzz driver needs it;
    ``gen_case`` and ``run_engine`` work without it."""
    src = os.environ.get("MERPCR_REFERENCE_SRC")
    if not src:
        raise SystemExit(
            "set MERPCR_REFERENCE_SRC to the reference merpcr's src directory"
        )
    sys.path.insert(0, src)
    import merpcr

    return merpcr


BASES = "ACGT"
AMBIGS = "NRYKMSWBDHV"


def rand_seq(rng, n, amb_rate=0.0, lower_rate=0.0):
    out = []
    for _ in range(n):
        c = rng.choice(AMBIGS) if rng.random() < amb_rate else rng.choice(BASES)
        if rng.random() < lower_rate:
            c = c.lower()
        out.append(c)
    return "".join(out)


def revcomp(s):
    m = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "R": "Y", "Y": "R",
         "K": "M", "M": "K", "S": "S", "W": "W", "B": "V", "V": "B", "D": "H",
         "H": "D"}
    return "".join(m.get(c.upper(), "N") for c in reversed(s))


def mutate(rng, s, n_mut):
    s = list(s)
    for _ in range(n_mut):
        i = rng.randrange(len(s))
        s[i] = rng.choice(BASES)
    return "".join(s)


IUPAC_EXP = {
    "R": "AG", "Y": "CT", "K": "GT", "M": "AC", "S": "CG", "W": "AT",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def resolve_iupac(rng, s):
    """Replace each primer IUPAC letter with a random member of its
    expansion set — a CLEAN genome site that matches the degenerate
    primer through IUPAC semantics. Planting the primer verbatim puts
    the ambiguity letter into the GENOME, which routes those units
    through the dirty-bypass path; resolved plants exercise the strict
    TABLE path for degenerate primers instead (the round-5 lost-hits
    bug hid in exactly that corner for four rounds)."""
    return "".join(
        rng.choice(IUPAC_EXP[c.upper()]) if c.upper() in IUPAC_EXP else c
        for c in s
    )


def gen_case(rng, case_idx):
    wordsize = rng.choice([5, 7, 11, 11, 11, 13, 14, 16])
    margin = rng.choice([0, 5, 50, 50, 137])
    mismatches = rng.choice([0, 0, 1, 2])
    three_prime = rng.choice([0, 1, 1, 3])
    iupac = rng.choice([0, 0, 0, 1])
    default_z = rng.choice([240, 100])
    # Content mode (FUZZ_MODE forces one): beyond uniform scatter, cases
    # exercise N/softmask RUNS, low-complexity repeat tracts colliding
    # with repeat-bearing primers, and shared-W-mer-heavy sets
    mode = os.environ.get("FUZZ_MODE") or rng.choice(
        ("scatter",) * 3 + ("runs", "repeat", "shared")
    )
    shared_wmer = (
        "".join(rng.choice(BASES) for _ in range(wordsize))
        if mode == "shared"
        else None
    )

    n_sts = rng.randrange(1, 12)
    sts_lines = []
    primers = []
    for i in range(n_sts):
        lp1 = rng.randrange(max(wordsize, 10), 30)
        lp2 = rng.randrange(max(wordsize, 10), 30)
        p1 = rand_seq(rng, lp1, amb_rate=0.05 if iupac else 0.02)
        p2 = rand_seq(rng, lp2, amb_rate=0.05 if iupac else 0.02)
        if mode == "repeat" and rng.random() < 0.4:
            p1 = workloads._tract(rng, lp1)
        elif mode == "shared" and rng.random() < 0.7:
            ext = (
                (shared_wmer * 4)[:lp1]
                if rng.random() < 0.3
                else shared_wmer + rand_seq(rng, max(0, lp1 - wordsize))
            )
            p1 = ext[:lp1] if len(ext) >= lp1 else ext + rand_seq(
                rng, lp1 - len(ext)
            )
        size_kind = rng.random()
        size = rng.randrange(lp1 + lp2, 400)
        if size_kind < 0.15:
            fld = f"{size - 10}-{size + 10}"
        elif size_kind < 0.25:
            fld = rng.choice(["", "0", "xyz", "100-", "-100", "50-60-70"])
        else:
            fld = str(size)
        alias = rng.choice(["", f"alias{i}", "Chr.17, 63.7 cM"])
        line = f"STS{case_idx}_{i}\t{p1}\t{p2}\t{fld}"
        if alias or rng.random() < 0.5:
            line += f"\t{alias}"
        sts_lines.append(line)
        primers.append((p1, p2, size))

    # genome with planted amplicons in both the reference's orientations:
    # '+' = p1 ... p2 as written; '-' = p2 ... revcomp(p1)  (SURVEY.md §2.1)
    glen = int(os.environ.get("FUZZ_GLEN", "0")) or rng.randrange(2000, 20000)
    boundary = int(os.environ.get("FUZZ_BOUNDARY", "0"))  # plant near k*boundary
    if mode == "runs":
        # megabase-style N/softmask runs at fuzz scale: run length is
        # drawn up to half the genome, so runs dwarf primer windows
        g = list(
            workloads.gen_masked_nruns(
                rng, glen, n_frac=0.1, mask_frac=0.5,
                run_len=(100, max(200, glen // 2)),
            )
        )
    elif mode == "repeat":
        g = list(
            workloads.gen_lowcomplex(
                rng, glen, tract_frac=0.3, tract_len=(50, max(100, glen // 4))
            )
        )
    elif mode == "shared":
        g = list(
            workloads.gen_tandem_tract(rng, glen, shared_wmer, tract_frac=0.2)
        )
    else:
        g = list(rand_seq(rng, glen, amb_rate=0.01, lower_rate=0.1))
    for p1, p2, size in primers:
        for _ in range(rng.randrange(0, 4)):
            direct = rng.random() < 0.5
            prod = min(size + rng.randrange(-margin - 5, margin + 6),
                       glen - 1)
            prod = max(prod, len(p1) + len(p2))
            if boundary and rng.random() < 0.8:
                b = boundary * rng.randrange(1, max(2, glen // boundary))
                pos = min(max(0, b + rng.randrange(-prod - 3, 4)),
                          max(0, glen - prod - 1))
            else:
                pos = rng.randrange(0, max(1, glen - prod))
            a = mutate(rng, p1, rng.randrange(0, mismatches + 2))
            b = mutate(rng, p2, rng.randrange(0, mismatches + 2))
            if rng.random() < 0.7:  # see resolve_iupac: clean-site plants
                a = resolve_iupac(rng, a)
                b = resolve_iupac(rng, b)
            if direct:
                g[pos : pos + len(a)] = a
                g[pos + prod - len(b) : pos + prod] = b
            else:
                g[pos : pos + len(b)] = b
                rc = revcomp(a)
                g[pos + prod - len(rc) : pos + prod] = rc
    genome = "".join(g)

    # ~1/4 of cases are scaffold-shaped (many UNEVEN records, some tiny /
    # sub-wordsize) to exercise the stream path's record mapping; the rest
    # split evenly into 1-2 records
    if rng.random() < 0.25:
        n_rec = rng.randrange(3, 14)
        cuts = sorted(
            rng.randrange(0, len(genome) + 1) for _ in range(n_rec - 1)
        )
        bounds = [0, *cuts, len(genome)]
    else:
        n_rec = rng.randrange(1, 3)
        per = max(1, len(genome) // n_rec)
        bounds = [min(r * per, len(genome)) for r in range(n_rec)] + [
            len(genome)
        ]
    fasta_lines = []
    for r in range(len(bounds) - 1):
        fasta_lines.append(f">rec{case_idx}_{r} some description")
        chunk = genome[bounds[r] : bounds[r + 1]]
        for i in range(0, len(chunk), 70):
            fasta_lines.append(chunk[i : i + 70])

    params = dict(
        wordsize=wordsize, margin=margin, mismatches=mismatches,
        three_prime_match=three_prime, iupac_mode=iupac,
        default_pcr_size=default_z, threads=1,
    )
    return "\n".join(sts_lines) + "\n", "\n".join(fasta_lines) + "\n", params


def run_engine(pkg, sts_path, fa_path, params, host_path=False):
    if pkg is eng_pkg:
        # every case runs this engine TWICE: once through the device
        # pipeline (host routing off) and once through the host (NumPy)
        # fast path — both must match the reference byte-for-byte
        os.environ["MERPCR_TPU_HOST_MAX"] = "1000000000" if host_path else "0"
    eng = pkg.MerPCR(**params)
    tile_override = os.environ.get("MERPCR_TPU_TILE_LEN")
    if tile_override and pkg is eng_pkg:
        eng._tile_len_override = int(tile_override)
    if os.environ.get("FUZZ_MESH") and pkg is eng_pkg:
        # stress the shard_map path against the oracle (run with
        # XLA_FLAGS=--xla_force_host_platform_device_count=8)
        from merpcr_tpu.parallel import make_mesh

        eng.use_mesh(make_mesh())
    if not eng.load_sts_file(sts_path):
        return None
    recs = eng.load_fasta_file(fa_path)
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs, None)
    return buf.getvalue()


def save_failure(case, sts, fa):
    """Keep a failing case's inputs under <tempdir>/fuzzfail for replay."""
    d = os.path.join(tempfile.gettempdir(), "fuzzfail")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, f"case{case}.sts"), "w").write(sts)
    open(os.path.join(d, f"case{case}.fa"), "w").write(fa)


def main():
    n_cases = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    ref_pkg = load_reference()
    fails = 0
    for case in range(n_cases):
        sts, fa, params = gen_case(rng, case)
        with tempfile.TemporaryDirectory() as td:
            sp = os.path.join(td, "t.sts")
            fp = os.path.join(td, "t.fa")
            open(sp, "w").write(sts)
            open(fp, "w").write(fa)
            ref_out = run_engine(ref_pkg, sp, fp, params)
            eng_out = run_engine(eng_pkg, sp, fp, params)
            host_out = run_engine(eng_pkg, sp, fp, params, host_path=True)
            if host_out != ref_out and eng_out == ref_out:
                fails += 1
                print(f"=== HOST-PATH MISMATCH case {case} params={params}")
                save_failure(case, sts, fa)
                continue
            if ref_out != eng_out:
                fails += 1
                print(f"=== MISMATCH case {case} params={params}")
                ref_lines = (ref_out or "").splitlines()
                eng_lines = (eng_out or "").splitlines()
                print(f"ref {len(ref_lines)} lines, eng {len(eng_lines)} lines")
                for a, b in zip(ref_lines, eng_lines):
                    if a != b:
                        print(f"  ref: {a}\n  eng: {b}")
                for extra in ref_lines[len(eng_lines):]:
                    print(f"  ref only: {extra}")
                for extra in eng_lines[len(ref_lines):]:
                    print(f"  eng only: {extra}")
                save_failure(case, sts, fa)
            else:
                nl = len((ref_out or "").splitlines())
                print(f"case {case}: OK ({nl} hits)")
        if case % 10 == 9:
            # long runs compile hundreds of fresh XLA executables; clear
            # periodically or the process crosses vm.max_map_count and
            # dies with LLVM "Cannot allocate memory" (~case 85 observed)
            import jax

            jax.clear_caches()
    print(f"\n{n_cases - fails}/{n_cases} cases identical")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
