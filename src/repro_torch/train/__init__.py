"""The training substrate, ported from ``repro.train``: the synthetic
token stream, AdamW with a cosine schedule and global-norm clipping, the
train step and loop, and checkpoint/restart.  Single device; the sharded
paths and ``fault`` wait for ``repro_torch.dist`` (ROADMAP Queue 1 item
12)."""
