"""Entry points, ported from ``repro.launch``: ``train`` (one device, or a
``("data", "model")`` device mesh under ``torchrun``), ``serve``, and the
meshes (``mesh``) and placements (``shardings``) they use.  The dry-run
and roofline wait for ROADMAP Queue 1 item 12."""
