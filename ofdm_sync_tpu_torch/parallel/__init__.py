"""Scale-out over `torch.distributed` (port of `ofdm_sync_tpu.parallel`).

`distributed` joins the process group and launches local ranks; `shard`
holds the (data, seq) mesh, the halo exchange, the blocked IIR, the event
merges and the sharded metrics and detectors; `dryrun` runs one step of
each on n ranks (the port of `__graft_entry__.dryrun_multichip`).  Nothing
here runs at import time.
"""
