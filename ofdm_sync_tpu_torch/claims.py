"""Claims check of the port: every number that README.md's port section
and PERF.md's section 5 quote from the port's committed bench lines
(`BENCH_torch_r*.json` from `python -m ofdm_sync_tpu_torch bench`,
`SCALING_torch_r*.json` from `python -m ofdm_sync_tpu_torch.bench_scaling`,
the latest of each) is registered here with the field it quotes and its
band; the counterpart of the JAX package's `tools/check_claims.py`.

    python -m ofdm_sync_tpu_torch.claims        # exit 0: consistent

A claim fails when its pattern no longer matches its document (the wording
changed, or the number went) or when the artifact's value lies outside the
quoted band: a point ``v`` quoted to d decimals holds a value that rounds
to it (within half a unit of its last digit), a range ``lo-hi`` one within
it.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Claim(NamedTuple):
    doc: str          # document, relative to the repository's root
    pattern: str      # regex; group 1 the number (group 2 the top of a range)
    artifact: str     # "bench" or "scaling"
    path: tuple       # keys into the artifact's JSON object (its units)


ARTIFACTS = {"bench": "BENCH_torch_r*.json", "scaling": "SCALING_torch_r*.json"}
_NUM = r"(\d+(?:\.\d+)?(?:e[+-]?\d+)?)"


def _claims() -> tuple:
    out = []
    for doc in ("README.md", "PERF.md"):
        out += [
            Claim(doc, rf"`bench` headline, A \+ B f32: {_NUM} ms median",
                  "bench", ("headline", "median_ms")),
            Claim(doc, rf"`bench` headline, A \+ B f32: [\d.]+ ms median \(p90 {_NUM} ms",
                  "bench", ("headline", "p90_ms")),
            Claim(doc, rf"= {_NUM} IQ samples/s on one card", "bench", ("value",)),
            Claim(doc, rf"int16 ADC codes {_NUM} samples/s", "bench",
                  ("headline", "int16_samples_per_sec")),
            Claim(doc, rf"fused step p50 {_NUM} us", "bench", ("latency", "fused", "p50_us")),
            Claim(doc, rf"fused step p50 [\d.]+ us, marginal {_NUM} us", "bench",
                  ("latency", "fused", "marginal_us")),
            Claim(doc, rf"marginal [\d.]+ us, host enqueue p50 {_NUM} us", "bench",
                  ("latency", "fused", "enqueue_p50_us")),
            Claim(doc, rf"composed A \+ B step p50 {_NUM} us", "bench",
                  ("latency", "composed", "p50_us")),
            Claim(doc, rf"`aa_fused` {_NUM} ms", "bench",
                  ("secondary", "aa_fused", "median_ms")),
            Claim(doc, rf"`zc_iq` f32 {_NUM} ms", "bench",
                  ("secondary", "zc_iq_f32", "median_ms")),
            Claim(doc, rf"`zc_e2e_iq` {_NUM} ms", "bench",
                  ("secondary", "zc_e2e_iq", "median_ms")),
            Claim(doc, rf"mesh \(1, 1\) over NCCL {_NUM}x the one-shot", "scaling",
                  ("card", "sharded_overhead_ratio")),
            Claim(doc, rf"serialized weak-seq efficiency over NVLink {_NUM}", "scaling",
                  ("projection", "halo_f32", "weak_seq_8card_nvlink")),
        ]
    return tuple(out)


CLAIMS = _claims()


def latest(root: str, pattern: str):
    """(path, object) of the last artifact matching ``pattern``, or (None, None)."""
    files = sorted(glob.glob(os.path.join(root, pattern)))
    if not files:
        return None, None
    with open(files[-1]) as f:
        return files[-1], json.load(f)


def band(m: re.Match) -> tuple[float, float]:
    """The quoted band: a range as written, a point widened by half a unit
    of its last digit (mantissa digit for e-notation)."""
    lo = float(m.group(1))
    if m.lastindex and m.lastindex >= 2 and m.group(2):
        hi = float(m.group(2))
        return min(lo, hi), max(lo, hi)
    s = m.group(1)
    mant, _, exp = s.partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    half = 0.5 * 10.0 ** (-decimals) * (10.0 ** int(exp) if exp else 1.0)
    return lo - half, lo + half


def check(root: str = ROOT, claims=CLAIMS) -> tuple[int, list[str]]:
    """(claims checked, contradictions)."""
    errors, arts = [], {}
    for name, pattern in ARTIFACTS.items():
        path, obj = latest(root, pattern)
        if obj is None:
            errors.append(f"no {pattern} in {root}")
        arts[name] = obj
    docs = {}
    for c in claims:
        if arts[c.artifact] is None:
            continue
        if c.doc not in docs:
            with open(os.path.join(root, c.doc)) as f:
                docs[c.doc] = f.read()
        m = re.search(c.pattern, docs[c.doc])
        if m is None:
            errors.append(f"{c.doc}: claim not found: {c.pattern!r}")
            continue
        value = arts[c.artifact]
        for key in c.path:
            value = value[key]
        lo, hi = band(m)
        if not lo <= value <= hi:
            errors.append(f"{c.doc}: {m.group(0)!r} does not hold {c.artifact} "
                          f"{'.'.join(c.path)} = {value!r}")
    return len(claims), errors


def main() -> int:
    n, errors = check()
    print(f"port claims: {n} checked against {', '.join(ARTIFACTS.values())}")
    for e in errors:
        print(f"  CONTRADICTION: {e}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
