"""CLI: ``python -m ofdm_sync_tpu_torch <command> [options]``.

Ported so far: the receive chains of `fused_rx` ([A][A], the default, and
the flagship Minn-RTL) and the Zadoff-Chu simulations `zc` and `zc_v2`
(without their plots); the other subcommands of ``python -m
ofdm_sync_tpu`` wait for later slices.
"""

from __future__ import annotations

import argparse
import importlib
import sys

_SIMULATIONS = {
    "zc": "Zadoff-Chu time-domain matched filter (reference zc.py)",
    "zc_v2": "streaming/CFAR Zadoff-Chu detector (reference zc_v2.py)",
}


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
    for name, help_text in _SIMULATIONS.items():
        p = sub.add_parser(name, help=help_text)
        p.add_argument(
            "--device", default="cuda",
            help="cuda (the default) or cpu.  The simulation runs the plain `detect` "
                 "there, as the JAX pipeline does; the ZC kernels (D, E, B) run through "
                 "ZCStreamingDetector.detect_fused / detect_fused_iq")
    args = parser.parse_args(argv)
    if args.command == "fused_rx":
        fused_rx.run_cli(args)
    else:
        importlib.import_module(f"ofdm_sync_tpu_torch.pipelines.{args.command}").main(
            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
