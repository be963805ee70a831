"""Entry points, ported from ``repro.launch``: ``train`` (single device).
The mesh, sharding, dry-run, roofline and serving launchers wait for
``repro_torch.dist`` (ROADMAP Queue 1 item 12)."""
