"""Report prints (port of the banner part of `ofdm_sync_tpu.utils.report`;
the plots are not ported)."""

from __future__ import annotations

BANNER = "=" * 70


def banner(title: str) -> None:
    print(f"\n{BANNER}")
    print(title)
    print(BANNER)
