"""Command-line interface.

Flag-for-flag compatible with the reference CLI (``src/merpcr/cli.py``):
same 12 flags, same defaults, same bounds validators (cli.py:79-124), same
legacy me-PCR ``X=value`` argument conversion (cli.py:19-62), same exit
codes (0 success / 1 failure, cli.py:256-266), diagnostics to stderr and
results to stdout (cli.py:65-76).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from .engine import (
    DEFAULT_IUPAC_MODE,
    DEFAULT_MARGIN,
    DEFAULT_MISMATCHES,
    DEFAULT_PCR_SIZE,
    DEFAULT_THREADS,
    DEFAULT_THREE_PRIME_MATCH,
    DEFAULT_WORDSIZE,
    MerPCR,
)

DEFAULT_MAX_STS_LINE_LENGTH = 1022


def convert_mepcr_arguments(args: List[str]) -> List[str]:
    """Convert me-PCR style arguments (M=50) to argparse style (-M 50).

    Mirrors reference cli.py:19-62: recognized keys MNWXTQZISO; the
    Mac-specific P= priority key is silently dropped; '-help' becomes
    '--help'; everything else passes through.
    """
    converted: List[str] = []
    for arg in args:
        if len(arg) >= 3 and arg[1] == "=" and arg[0] in "MNWXTQZISOP":
            param, value = arg[0], arg[2:]
            if param == "P":
                continue  # cli.py:51-53
            converted.extend([f"-{param}", value])
        elif arg == "-help":
            converted.append("--help")
        else:
            converted.append(arg)
    return converted


def setup_logging(quiet: int, debug: bool) -> None:
    """Reference cli.py:65-76: diagnostics to stderr via logging."""
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    logger = logging.getLogger("merpcr_tpu")
    if debug:
        logger.setLevel(logging.DEBUG)
    elif quiet == 0:
        logger.setLevel(logging.INFO)
    else:
        logger.setLevel(logging.WARNING)


def margin_type(value):
    ivalue = int(value)
    if ivalue < 0 or ivalue > 10000:
        raise argparse.ArgumentTypeError(f"Margin must be between 0-10000, got {ivalue}")
    return ivalue


def mismatch_type(value):
    ivalue = int(value)
    if ivalue < 0 or ivalue > 10:
        raise argparse.ArgumentTypeError(f"Mismatches must be between 0-10, got {ivalue}")
    return ivalue


def wordsize_type(value):
    ivalue = int(value)
    if ivalue < 3 or ivalue > 16:
        raise argparse.ArgumentTypeError(f"Word size must be between 3-16, got {ivalue}")
    return ivalue


def threads_type(value):
    ivalue = int(value)
    if ivalue <= 0:
        raise argparse.ArgumentTypeError(f"Threads must be > 0, got {ivalue}")
    return ivalue


def pcr_size_type(value):
    ivalue = int(value)
    if ivalue < 1 or ivalue > 10000:
        raise argparse.ArgumentTypeError(f"PCR size must be between 1-10000, got {ivalue}")
    return ivalue


def sts_line_length_type(value):
    ivalue = int(value)
    if ivalue < 1:
        raise argparse.ArgumentTypeError(f"STS line length must be > 0, got {ivalue}")
    return ivalue


def create_parser() -> argparse.ArgumentParser:
    """Reference cli.py:127-214 — identical flags and defaults."""
    parser = argparse.ArgumentParser(
        description="merPCR - accelerated Electronic Rapid PCR (JAX)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("sts_file", type=str, help="STS file (tab-delimited)")
    parser.add_argument("fasta_file", type=str, help="FASTA sequence file")
    parser.add_argument(
        "-M", "--margin", type=margin_type, default=DEFAULT_MARGIN,
        help=f"Margin (default: {DEFAULT_MARGIN})",
    )
    parser.add_argument(
        "-N", "--mismatches", type=mismatch_type, default=DEFAULT_MISMATCHES,
        help=f"Number of mismatches allowed (default: {DEFAULT_MISMATCHES})",
    )
    parser.add_argument(
        "-W", "--wordsize", type=wordsize_type, default=DEFAULT_WORDSIZE,
        help=f"Word size (default: {DEFAULT_WORDSIZE})",
    )
    parser.add_argument(
        "-T", "--threads", type=threads_type, default=DEFAULT_THREADS,
        help=f"Number of threads (default: {DEFAULT_THREADS})",
    )
    parser.add_argument(
        "-X", "--three-prime-match", type=int, default=DEFAULT_THREE_PRIME_MATCH,
        help=(
            "Number of 3'-ward bases in which to disallow mismatches "
            f"(default: {DEFAULT_THREE_PRIME_MATCH})"
        ),
    )
    parser.add_argument(
        "-O", "--output", type=str, default=None,
        help="Output file name (default: stdout)",
    )
    parser.add_argument(
        "-Q", "--quiet", type=int, choices=[0, 1], default=1,
        help="Quiet flag (0=verbose, 1=quiet)",
    )
    parser.add_argument(
        "-Z", "--default-pcr-size", type=pcr_size_type, default=DEFAULT_PCR_SIZE,
        help=f"Default PCR size (default: {DEFAULT_PCR_SIZE})",
    )
    parser.add_argument(
        "-I", "--iupac", type=int, choices=[0, 1], default=DEFAULT_IUPAC_MODE,
        help="IUPAC flag (0=don't honor IUPAC ambiguity symbols, 1=honor IUPAC symbols)",
    )
    parser.add_argument(
        "-S", "--max-sts-line-length", type=sts_line_length_type,
        default=DEFAULT_MAX_STS_LINE_LENGTH,
        help=f"Max. line length for the STS file (default: {DEFAULT_MAX_STS_LINE_LENGTH})",
    )
    parser.add_argument(
        "-v", "--version", action="version", version="merPCR-TPU version 1.3.0"
    )
    parser.add_argument("--debug", action="store_true", help="Enable debug logging")
    # Addition with no reference counterpart (the reference's -T process
    # pool maps to device tiling here): shard the search over every
    # device of several hosts via jax.distributed; launch one process
    # per host with this flag (or MERPCR_TPU_MULTIHOST=1) and only host 0
    # writes output.
    parser.add_argument(
        "--multihost", action="store_true",
        default=os.environ.get("MERPCR_TPU_MULTIHOST", "") == "1",
        help="Distribute the search across all hosts/chips in the slice "
        "(jax.distributed; output written by host 0 only)",
    )
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    """Reference cli.py:217-266 — same control flow and exit codes."""
    converted_argv = convert_mepcr_arguments(
        sys.argv[1:] if argv is None else list(argv)
    )
    parser = create_parser()
    args = parser.parse_args(converted_argv)

    setup_logging(args.quiet, args.debug)
    logger = logging.getLogger("merpcr_tpu")

    try:
        mer_pcr = MerPCR(
            wordsize=args.wordsize,
            margin=args.margin,
            mismatches=args.mismatches,
            three_prime_match=args.three_prime_match,
            iupac_mode=args.iupac,
            default_pcr_size=args.default_pcr_size,
            threads=args.threads,
            max_sts_line_length=args.max_sts_line_length,
        )

        if args.multihost:
            mer_pcr.enable_multihost()

        if not mer_pcr.load_sts_file(args.sts_file):
            logger.error(f"Failed to load STS file: {args.sts_file}")
            return 1

        fasta_records = mer_pcr.load_fasta_file(args.fasta_file)
        if not fasta_records:
            logger.error(f"Failed to load FASTA file: {args.fasta_file}")
            return 1

        hit_count = mer_pcr.search(fasta_records, args.output)
        logger.info(f"Search complete: {hit_count} hits found")
        return 0

    except Exception as e:
        logger.error(f"Error: {str(e)}")
        if args.debug:
            import traceback

            traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
