"""CLI: ``python -m ofdm_sync_tpu_torch fused_rx [options]``.

Only the receive chains of `fused_rx` are ported so far ([A][A], the
default, and the flagship Minn-RTL); the other subcommands of
``python -m ofdm_sync_tpu`` wait for later slices.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from ofdm_sync_tpu_torch.pipelines import fused_rx

    parser = argparse.ArgumentParser(
        prog="python -m ofdm_sync_tpu_torch",
        description="PyTorch/CUDA port of the OFDM preamble-synchronization framework",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_rx = sub.add_parser(
        "fused_rx",
        help="receive chain on the fused detector kernels: detect -> frame "
             "re-emission -> CFO -> LS EQ -> EVM",
    )
    fused_rx.add_cli_args(p_rx)
    args = parser.parse_args(argv)
    if args.command == "fused_rx":
        fused_rx.run_cli(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
