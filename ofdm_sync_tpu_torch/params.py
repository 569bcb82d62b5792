"""System and detector parameters, shared with the JAX package.

`ofdm_sync_tpu.params` is pure-Python dataclasses and importing it imports
no JAX (`ofdm_sync_tpu/__init__.py` only imports `params`), so the port
re-exports it instead of keeping a fork that could drift.
"""

from ofdm_sync_tpu.params import (  # noqa: F401
    AADetectorParams,
    MinnDetectorParams,
    MinnRTLParams,
    SCDetectorParams,
    SYS_30M72,
    SYS_AA_10M,
    SYS_DEMO_512,
    SystemParams,
    ZCParams,
    ZCStreamingParams,
)
