"""Plain reference of the `minn_rtl_rx` configuration: the flagship
Minn-RTL receiver of the upstream link simulation (minn_rtl.py:849-1184),
detection and then every detected frame demodulated, in PyTorch.

Detection and the judgement of the event tables are `minn_rtl_fpga.py`'s,
imported, on this configuration's 16 event slots: `unexcused_events` and
`peak_value_gap` under that file's limits.

The receive is held at the program's own slots, on the inputs' codes,
against a demodulation of the same windows in float64 (complex128): the
frame opens at ``peak + timing_offset - 6Q``, clipped into the stream; the
CP CFO is ``-angle(P) fs / (2 pi N)`` with P the lag-N products of the
pilot's CP (local offset 5Q) summed over the CP and the branches
(core.py:179-196); the frame is turned back by that CFO on its local index
and the branches averaged; the pilot and data symbols' used bins come from
their CP-stripped FFTs (core.py:171-176); H = Y_p / (X_p + 1e-9), the data
equalized as Y_d / (H + 1e-9), aligned by the LS gain g = <eq, X_d> /
(<eq, eq> + 1e-12), and its EVM taken against X_d (core.py:339-370).

Each input's last call is compared (the entry keeps its slot outputs):
`start_mismatch` counts slots whose validity is not the table's (a valid
event below the row's count, among the first max_frames) or whose start
is not their event's peak - 6Q (clipped), the event that `unexcused_events`
holds to the reference's; at the valid slots, `cfo_gap_hz` is the largest
CFO difference, `evm_gap` the largest relative EVM difference and `eq_gap`
the largest difference of an equalized data bin, in constellation units
(over max(1, |eq_ref|), so a bin that noise has blown up counts
relatively), left out at the weak bins (`WEAK`).  The control demodulates
the reference's own slots with the frame samples and the FFT bins stored
in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.preambles import minn_rtl_frame
from benchmark.reference import gates as G
from benchmark.reference import minn_rtl_fpga as FPGA

#: each number compared, and its limit, with the reason for it (PERF.md
#: section 2 gives the readings: sound runs and the bfloat16 control)
LIMITS = {
    # the detection's own limits (minn_rtl_fpga.py)
    "unexcused_events": FPGA.LIMITS["unexcused_events"],
    "peak_value_gap": FPGA.LIMITS["peak_value_gap"],
    # a slot that the table does not give, or a window that does not open
    # where its event says: an integer rule, exact
    "start_mismatch": 0,
    # float32 sums of the CP's 1,024 products turn P by ~1e-7 rad, ~2e-4 Hz
    # at fs / (2 pi N) = 2,387 Hz a radian: at most 2.46e-4 Hz over 26 sound
    # seeds on the H100; bfloat16 samples and bins: at least 0.52 Hz
    "cfo_gap_hz": 0.01,
    # float32 rounding through the FFT, LS and gain: at most 1.07e-5
    # relative; bfloat16: at least 0.062
    "evm_gap": 1e-3,
    # float32 rounding of the bins, amplified at most 10x by the division
    # outside the weak bins: at most 2.81e-4; bfloat16 bins: at least 1.24;
    # the equalized bins alone stored in bfloat16 read ~3.8e-3
    "eq_gap": 1e-3,
}
RX_CHECKS = ("cfo_gap_hz", "evm_gap", "eq_gap")
#: a bin whose |H| lies below this share of its slot's RMS |H| is left out
#: of eq_gap: dividing by H there amplifies the float32 rounding of the
#: FFT as 1/|H|, without bound (a noise-only pilot bin near zero; sound runs
#: on the H100 read up to 1.17e-3 there, over the limit, and a limit above
#: that tail would let the bfloat16-stored bins through), while EVM still
#: judges the slot whole; ~1% of the bins of a noise-dominated slot, none
#: of a clean one
WEAK = 0.1
#: the LS estimate's, the equalizer's and the gain's guards (core.py:339-362)
LS_EPS, GAIN_EPS = 1e-9, 1e-12
#: streams per block of the reference's demodulation (bounds its memory)
ROWS = 32


def layout(config: dict) -> dict:
    """The frame's numbers: the window's offset from the peak, the pilot
    CP's local offset, the frame's length, the span the receive reads."""
    det, sys, rx = config["detector"], config["system"], config["receive"]
    Q, N, cp = det["quarter_len"], sys["n_fft"], sys["cp_len"]
    return {"offset": rx["timing_offset"] - 6 * Q, "pilot_cp": rx["pilot_cp_offset"],
            "frame_len": 5 * Q + 2 * (N + cp), "span": 2 * (N + cp), "K": rx["max_frames"]}


def slots(peak_idx, valid, count, config: dict, L: int):
    """(starts (rows, K) int64, valid (rows, K) bool) of a table's first K
    slots: the frame's start clipped into the stream, valid events below
    the row's count."""
    lay = layout(config)
    K = min(lay["K"], peak_idx.shape[-1])
    peak = torch.as_tensor(np.asarray(peak_idx))[:, :K].to(torch.int64)
    ok = torch.as_tensor(np.asarray(valid))[:, :K].bool() & (
        torch.arange(K) < torch.as_tensor(np.asarray(count)).reshape(-1, 1))
    return (peak + lay["offset"]).clamp(0, L - lay["frame_len"]), ok


def _stored(v, precision: str):
    """v (real or complex float64) held in ``precision`` and back."""
    if precision == "float64":
        return v
    if v.is_complex():
        return torch.complex(_stored(v.real, precision), _stored(v.imag, precision))
    return v.to(torch.bfloat16).double()


def demod(x, starts, config: dict, pilot, data, precision: str = "float64") -> dict:
    """x (C, rows, L) codes, starts (rows, K) frame starts -> {cfo (rows,
    K), evm (rows, K), eq (rows, K, num_active)} in float64 / complex128;
    ``precision`` "bfloat16" stores the frame samples and the FFT bins in
    bfloat16 (the control)."""
    sys, lay = config["system"], layout(config)
    N, cp, fs, A = sys["n_fft"], sys["cp_len"], sys["sample_rate_hz"], sys["num_active"]
    C, rows, L = x.shape
    local = lay["pilot_cp"] + torch.arange(lay["span"], device=x.device)
    at = (starts.to(x.device).unsqueeze(-1) + local).reshape(rows, -1)
    xs = torch.stack([x[c].gather(-1, at) for c in range(C)]).to(torch.float64)
    xs = _stored(xs.view(C, rows, -1, lay["span"]), precision)
    ants = torch.complex(xs[0::2], xs[1::2])                     # (branches, rows, K, span)
    P = (ants[..., :cp] * ants[..., N: N + cp].conj()).sum(dim=(0, -1))
    cfo = -torch.angle(P) * fs / (2.0 * math.pi * N)
    turn = torch.polar(torch.ones((), dtype=torch.float64, device=x.device),
                       -2.0 * math.pi * cfo.unsqueeze(-1) / fs * local.double())
    comb = (ants * turn).mean(dim=0)
    half = A // 2
    used = torch.cat([torch.arange(N - half, N), torch.arange(1, half + 1)]).to(x.device)
    Yp = _stored(torch.fft.fft(comb[..., cp: cp + N])[..., used], precision)
    Yd = _stored(torch.fft.fft(comb[..., 2 * cp + N: 2 * cp + 2 * N])[..., used], precision)
    H = Yp / (pilot + LS_EPS)
    eq = Yd / (H + LS_EPS)
    g = (eq.conj() * data).sum(-1) / ((eq.conj() * eq).sum(-1) + GAIN_EPS)
    eq = eq * g.unsqueeze(-1)
    evm = torch.sqrt((eq - data).abs().square().mean(-1) / data.abs().square().mean(-1))
    return {"cfo": cfo, "evm": evm, "eq": eq, "h": H}


def rx_gaps(prog: dict, ref: dict, valid) -> tuple[dict, dict]:
    """(the largest CFO, relative EVM and equalized-bin differences at the
    valid slots; {"bins": weak bins left out of eq_gap, "gap": their largest
    difference}); prog: float32 / complex64 tensors of the same shapes."""
    v = valid.to(ref["cfo"].device)
    if not bool(v.any()):
        return dict.fromkeys(RX_CHECKS, 0.0), {"bins": 0, "gap": 0.0}
    dc = (prog["cfo"].double() - ref["cfo"]).abs()
    de = (prog["evm"].double() - ref["evm"]).abs() / ref["evm"].clamp_min(1e-30)
    mag = ref["h"].abs()
    weak = (mag < WEAK * mag.square().mean(-1, keepdim=True).sqrt()) & v.unsqueeze(-1)
    dq = ((prog["eq"].to(torch.complex128) - ref["eq"]).abs()
          / ref["eq"].abs().clamp_min(1.0)).masked_fill(~v.unsqueeze(-1), 0.0)
    return ({"cfo_gap_hz": float(dc[v].max()), "evm_gap": float(de[v].max()),
             "eq_gap": float(dq.masked_fill(weak, 0.0).max())},
            {"bins": int(weak.sum()), "gap": float(dq.masked_fill(~weak, 0.0).max())})


def judge_rx(config: dict, x, out: dict, pilot, data, control: bool = False) -> tuple:
    """(start_mismatch, {check: gap}, valid slots compared, {weak bins,
    their largest eq difference}) of one input's receive: ``out`` is the
    program's kept slot outputs with its table's peak_idx, table_valid and
    count, or (control) the reference's table as NumPy, demodulated in
    bfloat16."""
    L = x.shape[-1]
    dev = x.device
    if control:
        starts, valid = slots(out["peak_idx"], out["valid"], out["count"], config, L)
        mism = 0
    else:
        host = lambda t: t.detach().cpu()  # noqa: E731
        want_s, want_v = slots(host(out["peak_idx"]), host(out["table_valid"]),
                               host(out["count"]), config, L)
        starts, valid = host(out["starts"]).to(torch.int64), host(out["valid"]).bool()
        mism = int((valid != want_v).sum()) + int((valid & want_v & (starts != want_s)).sum())
    gaps, compared = dict.fromkeys(RX_CHECKS, 0.0), int(valid.sum())
    weak = {"bins": 0, "gap": 0.0}
    for r in range(0, x.shape[1], ROWS):
        rows = slice(r, r + ROWS)
        s = starts[rows].clamp(0, L - layout(config)["frame_len"])
        ref = demod(x[:, rows], s, config, pilot, data)
        if control:
            prog = demod(x[:, rows], s, config, pilot, data, "bfloat16")
        else:
            prog = {"cfo": out["cfo_hz"][rows], "evm": out["evm_rms"][rows],
                    "eq": out["eq"][rows]}
        prog = {k: v.to(dev) for k, v in prog.items()}
        block, w = rx_gaps(prog, ref, valid[rows])
        gaps = {k: max(gaps[k], block[k]) for k in RX_CHECKS}
        weak = {"bins": weak["bins"] + w["bins"], "gap": max(weak["gap"], w["gap"])}
    return mism, gaps, compared, weak


def judge(config: dict, record: dict, control: bool = False, want_work: bool = False) -> dict:
    """The numbers compared for one run: {"checks": {name: (value, limit)},
    "failed": answers found wrong, "info": {...}, "gated": per input}."""
    det, h = config["detector"], config["detector"]["hysteresis"]
    used = [torch.as_tensor(v, dtype=torch.complex128) for v in minn_rtl_frame.symbols(config)]
    bad_total, gap, failed, excused, events, gated = 0, 0.0, 0, 0, 0, {}
    mism_total, rx, compared = 0, dict.fromkeys(RX_CHECKS, 0.0), 0
    weak = {"bins": 0, "gap": 0.0}
    for i, x in enumerate(record["inputs"]):
        ref, amb, gated[i] = FPGA.detect(x, det)
        events += int(ref["valid"].sum())
        outs = ([(FPGA.detect(x, det, "bfloat16")[0], record["calls"].get(i, 1))] if control
                else record["variants"].get(i, []))
        for table, count in outs:
            bad, exc, g = G.compare(table, ref, amb, h)
            bad_total += int(bad.sum())
            excused += exc
            gap = max(gap, g)
            failed += count if bad.any() else 0
        pilot, data = (u.to(x.device) for u in used)
        mism, gaps, n, w = judge_rx(config, x, ref if control else record["kept"][i], pilot,
                                    data, control)
        mism_total, compared = mism_total + mism, compared + n
        weak = {"bins": weak["bins"] + w["bins"], "gap": max(weak["gap"], w["gap"])}
        rx = {k: max(rx[k], gaps[k]) for k in RX_CHECKS}
        if mism or any(gaps[k] > LIMITS[k] for k in RX_CHECKS):
            failed += 1
    checks = {"unexcused_events": bad_total, "peak_value_gap": gap,
              "start_mismatch": mism_total, **rx}
    return {"checks": {k: (v, LIMITS[k]) for k, v in checks.items()}, "failed": failed,
            "gated": gated,
            "info": {"events": events, "excused_events": excused,
                     "variants": sum(len(v) for v in record["variants"].values()),
                     "slots_compared": compared, "weak_bins": weak["bins"],
                     "weak_bins_eq_gap": weak["gap"]}}
