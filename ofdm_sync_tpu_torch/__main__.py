"""CLI: ``python -m ofdm_sync_tpu_torch <command> [options]``.

The reference-parity simulations of every detector family (without their
plots), the CP/FFT demo, the receive chains of `fused_rx` ([A][A], the
default, and the flagship Minn-RTL) and `list`.  Every command runs on the
card unless ``--device cpu`` is given.  The JAX CLI's `aa`, `bench` and
`waveform` commands wait for later slices.
"""

from __future__ import annotations

import argparse
import importlib
import sys

_SIMULATIONS = {
    "sc": "Schmidl-Cox end-to-end simulation (reference sc.py)",
    "minn": "standard Minn detector simulation + block-length sweep (reference minn.py)",
    "minn_rtl": "RTL-style adjacent-quarter Minn + sequence / Q sweeps (reference minn_rtl.py)",
    "park": "Park detector simulation (reference park.py)",
    "zc": "Zadoff-Chu time-domain matched filter (reference zc.py)",
    "zc_freq": "Zadoff-Chu frequency-domain search (reference zc_freq.py)",
    "zc_v2": "streaming/CFAR Zadoff-Chu detector (reference zc_v2.py)",
    "combined_sc_minn": "S&C gate + Minn peak (reference combined_sc_min.py)",
    "cp_fft_demo": "CP/FFT STO pedagogy demo (reference ofdm_cp_fft_demo.py)",
}

_DEVICE_HELP = (
    "cuda (the default) or cpu.  The simulation runs the plain `detect` there, as the JAX "
    "pipeline does; the kernels run through the fused detectors (`fused_rx`, "
    "ZCStreamingDetector.detect_fused / detect_fused_iq)")


def _list() -> None:
    from ofdm_sync_tpu_torch.models import detectors

    for name, help_text in _SIMULATIONS.items():
        print(f"{name:18s} {help_text}")
    print()
    for cls in (detectors.SCDetector, detectors.MinnDetector, detectors.MinnRTLDetector,
                detectors.ParkDetector, detectors.ZCTimeDetector, detectors.ZCFreqDetector,
                detectors.ZCStreamingDetector, detectors.CombinedSCMinnDetector,
                detectors.AADetector):
        print(f"model: {cls.__name__}")


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
        sub.add_parser(name, help=help_text).add_argument("--device", default="cuda",
                                                          help=_DEVICE_HELP)
    sub.add_parser("list", help="list the simulations and detector families").add_argument(
        "--device", default="cuda", help="accepted like every command's; list runs nothing")
    args = parser.parse_args(argv)
    if args.command == "fused_rx":
        fused_rx.run_cli(args)
    elif args.command == "list":
        _list()
    else:
        importlib.import_module(f"ofdm_sync_tpu_torch.pipelines.{args.command}").main(
            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
