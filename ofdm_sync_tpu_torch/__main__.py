"""CLI: ``python -m ofdm_sync_tpu_torch <command> [options]``.

The reference-parity simulations of every detector family and the [A][A]
grid test (`aa`), the CP/FFT demo, the receive chains of `fused_rx`
([A][A], the default, and the flagship Minn-RTL), `waveform` (plots of a
preamble, a QPSK symbol or a frame), `bench` (the benchmark on one card,
`ofdm_sync_tpu_torch.bench`; its scaling counterpart runs as
``python -m ofdm_sync_tpu_torch.bench_scaling``) and `list`.  Every command
but `bench` runs on the card unless ``--device cpu`` is given; `bench`
runs on the card only and exits non-zero without one.  The simulations
write the reference's plots under ``plots/`` (this needs matplotlib);
``--no-plots`` runs them without plots, and without matplotlib.
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
    "aa": "[A][A] detector grid test (reference sync_aa.py)",
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
        p_sim = sub.add_parser(name, help=help_text)
        p_sim.add_argument("--device", default="cuda", help=_DEVICE_HELP)
        p_sim.add_argument("--no-plots", dest="plots", action="store_false",
                           help="write no plots (and import no matplotlib)")
    p_wave = sub.add_parser(
        "waveform", help="plot preamble / QPSK symbol / frame views "
                         "(reference ref/ofdm.py:286-331 CLI)")
    p_wave.add_argument("kind", choices=["preamble", "qpsk", "frame", "aa_preamble"],
                        help="waveform to render")
    p_wave.add_argument("--out", default="plots/waveforms", help="output directory")
    p_wave.add_argument("--seed", type=int, default=0)
    p_bench = sub.add_parser(
        "bench", help="the benchmark on one card: on-card checks, headline, block latency, "
                      "secondary workloads; one JSON line (the card only, no --device)")
    p_bench.add_argument("--seed", type=int, default=0, help="seed of every stimulus")
    p_bench.add_argument("--out", default=None, help="also write the result line to this file")
    sub.add_parser("list", help="list the simulations and detector families").add_argument(
        "--device", default="cuda", help="accepted like every command's; list runs nothing")
    args = parser.parse_args(argv)
    if args.command == "bench":
        from ofdm_sync_tpu_torch import bench

        return bench.main(["--seed", str(args.seed)] + (["--out", args.out] if args.out else []))
    if args.command == "fused_rx":
        fused_rx.run_cli(args)
    elif args.command == "list":
        _list()
    elif args.command == "waveform":
        _waveform_cmd(args)
    else:
        importlib.import_module(f"ofdm_sync_tpu_torch.pipelines.{args.command}").main(
            device=args.device, plots=args.plots)
    return 0


def _waveform_cmd(args) -> None:
    """Render one waveform's I/Q and magnitude to ``<out>/<kind>.png`` (the
    packaged twin of the reference's ref/ofdm.py argparse demo); the
    waveforms come from `ops.waveforms`, on the host."""
    from pathlib import Path

    import numpy as np

    from ofdm_sync_tpu_torch.ops import waveforms as W
    from ofdm_sync_tpu_torch.params import SYS_30M72, SYS_AA_10M
    from ofdm_sync_tpu_torch.utils.report import pyplot

    plt = pyplot()
    rng = np.random.default_rng(args.seed)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.kind == "preamble":
        sig, _ = W.build_hermitian_minn_preamble(SYS_30M72, rng)
        title = "Minn [A A -A -A] preamble (Hermitian-symmetric values)"
    elif args.kind == "qpsk":
        sig, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        title = "Random QPSK OFDM symbol"
    elif args.kind == "aa_preamble":
        sig, _, papr = W.build_aa_preamble(1024, SYS_AA_10M)
        title = f"[A][A] preamble (PAPR {papr:.2f} dB)"
    else:  # frame
        pre, _ = W.build_hermitian_minn_preamble(SYS_30M72, rng)
        pilot, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        data, _ = W.build_random_qpsk_symbol(rng, SYS_30M72)
        sig = W.assemble_frame(pre, pilot, data, pre_pad=SYS_30M72.tx_pre_pad)
        title = "Full frame: [guard | preamble | pilot | data]"
    sig = np.asarray(sig)
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(11, 6))
    a1.plot(sig.real, linewidth=0.6, label="I")
    a1.plot(sig.imag, linewidth=0.6, label="Q")
    a1.set_title(title)
    a1.legend()
    a1.grid(True, alpha=0.4)
    a2.plot(np.abs(sig), linewidth=0.6)
    a2.set_title("Magnitude")
    a2.set_xlabel("Sample")
    a2.grid(True, alpha=0.4)
    fig.tight_layout()
    path = out / f"{args.kind}.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"{title}: {sig.size} samples -> {path}")


if __name__ == "__main__":
    sys.exit(main())
