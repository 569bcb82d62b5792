"""Scale-out over `torch.distributed` (port of `ofdm_sync_tpu.parallel`).

`distributed` joins the process group and launches local ranks; `shard`
holds the (data, seq) mesh, the halo exchange, the event-table merge and
the sharded detectors.  Nothing here runs at import time.
"""
