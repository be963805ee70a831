"""The reference's decode, train or prefill step compiled by XLA on eight
fake CPU devices in a (2, 4) ("data", "model") mesh, and what its
collectives move.

    python tests/_torch_xla_layout.py ARCH [--kind decode|train|prefill]
        [--full-width] [--layers N] [--batch B] [--seq S] [--hlo PATH]

prints one JSON object: ``gathers``, each all-gather of the compiled
step as {"axis", "shape", "dtype"} (``axis`` is "data" or "model" when
its groups run along that mesh axis alone, "model-part" for groups
inside one 'model' row, else "mixed"; ``shape`` is the gathered
result's), ``collective_bytes`` by kind and axis, and ``lookup``, each
collective of the embedding lookup (``jnp.take``'s, by its op name) as
{"kind", "axis", "backward", "arrays": [[dtype, shape], ...]} (a tuple
collective lists each of its results: XLA may combine another op's
into the lookup's).  ARCH's smoke
config in float32 by default, its published widths with
``--full-width``; ``--hlo`` also writes the compiled module's text to
PATH.  It sets ``XLA_FLAGS`` before JAX starts, so it runs in
a process of its own (``tests/test_torch_dryrun.py`` starts it).
"""
import argparse
import json
import os
import re
import sys

import numpy as np

MESH = (2, 4)
_COLLECTIVE = re.compile(
    r"= (\(?[a-z0-9]+\[[^=]*?)\s(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)(?:-start)?\(")
_ARRAY = re.compile(r"([a-z]+[0-9]*)\[([0-9,]*)\]")
_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                   r"(?:T\(([\d,]+)\))?")
_LISTED = re.compile(r"replica_groups=\{(\{[\d,{} ]*\})\}")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_BYTES = {"f32": 4, "s32": 4, "bf16": 2, "f16": 2, "u32": 4, "pred": 1,
          "s8": 1, "u8": 1, "f64": 8, "s64": 8}


def _groups(line):
    """The device ids of each replica group of an HLO collective."""
    m = _IOTA.search(line)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(n) for n in m.group(3).split(",")]
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(n) for n in m.group(4).split(",")])
        return ids.reshape(g, s).tolist()
    m = _LISTED.search(line)
    if m:
        return [[int(n) for n in grp.split(",") if n]
                for grp in re.findall(r"\{([\d,]*)\}", m.group(1))]
    return [list(range(int(np.prod(MESH))))]


def _axis(groups):
    """The mesh axis a collective's groups run along (device id = data *
    model_size + model)."""
    coords = [[divmod(i, MESH[1]) for i in grp] for grp in groups]
    if all(len({m for _, m in c}) == 1 for c in coords):
        return "data"
    if all(len({d for d, _ in c}) == 1 for c in coords):
        return ("model" if all(len(c) == MESH[1] for c in coords)
                else "model-part")
    return "mixed"


def analyse(hlo_text):
    """{"gathers": [...], "collective_bytes": {"kind@axis": bytes},
    "lookup": [...]} of a compiled module's text."""
    gathers, moved, lookup = [], {}, []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE.search(line)
        if not m:
            continue
        kind, axis = m.group(2), _axis(_groups(line))
        arrays = _ARRAY.findall(m.group(1))
        size = sum(_BYTES.get(dt, 4) * int(np.prod(
            [int(n) for n in dims.split(",") if n] or [1]))
            for dt, dims in arrays)
        key = f"{kind}@{axis}"
        moved[key] = moved.get(key, 0) + size
        shapes = [[dt, [int(n) for n in dims.split(",") if n]]
                  for dt, dims in arrays]
        if kind == "all-gather":
            gathers.append({"axis": axis, "dtype": shapes[0][0],
                            "shape": shapes[0][1]})
        op = _OP_NAME.search(line)
        if op and "jit(_take)" in op.group(1):
            lookup.append({"kind": kind, "axis": axis, "arrays": shapes,
                           "backward": "transpose(" in op.group(1)})
    return {"gathers": gathers, "collective_bytes": moved, "lookup": lookup}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--kind", default="decode",
                    choices=("decode", "train", "prefill"))
    ap.add_argument("--hlo", default="")
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                               f"{int(np.prod(MESH))}")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config, get_smoke_config
    from repro.dist.sharding import use_mesh
    from repro.launch.dryrun import BUILDERS
    from repro.launch.mesh import model_axis_size
    from repro.models.config import ShapeConfig
    from repro.models.registry import sharding_rules

    cfg = (get_config(args.arch) if args.full_width
           else get_smoke_config(args.arch).replace(dtype="float32"))
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    shape = ShapeConfig(f"{args.kind}_small", args.seq, args.batch,
                        args.kind)
    # Auto axes: the sharding rules constrain with with_sharding_constraint
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh, use_mesh(mesh, sharding_rules(cfg, model_axis_size(mesh))):
        fn, fn_args = BUILDERS[args.kind](cfg, shape, mesh)
        text = fn.lower(*fn_args).compile().as_text()
    if args.hlo:
        with open(args.hlo, "w") as f:
            f.write(text)
    print(json.dumps(analyse(text)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
