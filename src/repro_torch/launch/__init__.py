"""Entry points, ported from ``repro.launch``: ``train`` (one device, or a
``("data", "model")`` device mesh under ``torchrun``), ``serve``, the
meshes (``mesh``) and placements (``shardings``) they use, and the
multi-card dry-run (``dryrun``) with its H100 roofline terms
(``roofline``)."""
