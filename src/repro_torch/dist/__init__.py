"""Distribution utilities, ported from ``repro.dist``: logical-axis
sharding rules and DTensor placements (``sharding``), and int8 gradient
all-reduce with error feedback (``compression``)."""
