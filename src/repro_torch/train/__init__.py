"""The training substrate, ported from ``repro.train``: the synthetic
token stream, AdamW with a cosine schedule and global-norm clipping, the
train step and loop on one device or on a device mesh (DTensor
parameters), checkpoint/restart with a re-meshed restore, and ``fault``
(straggler watchdog and elastic re-mesh plans)."""
