"""Port parity: ``repro_torch.dist`` against ``repro.dist`` -- the
logical-axis rules (``logical_to_spec`` on mock meshes, the reference's
own cases and a seeded sweep), the parameters' logical axes
(``param_axes`` against the reference's axes tree for every
architecture), ``constrain`` without a mesh, and int8 quantization,
bitwise on seeded inputs and on half-step ties."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.dist import compression, sharding  # noqa: E402
from repro_torch.models.module import param_axes  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

NAMES = [None] + sorted(sharding.DEFAULT_RULES)
MESHES = [(("data", "model"), (16, 16)), (("data", "model"), (2, 4)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("pod", "data", "model"), (2, 2, 2)), (("data",), (8,)),
          (("model",), (4,))]


def _mesh(names, shape):
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _same_spec(ours, axes, mesh, rules=None, shape=None):
    """``ours`` as a PartitionSpec equals the reference's spec (which
    normalises a one-axis tuple entry to the axis)."""
    jsh = pytest.importorskip("repro.dist.sharding")
    from jax.sharding import PartitionSpec as P
    return P(*ours) == jsh.logical_to_spec(axes, mesh, rules=rules,
                                           shape=shape)


def test_logical_spec_reference_cases():
    mesh = _mesh(("data", "model"), (16, 16))
    # duplicate target axis: first dim wins (trailing Nones are trimmed)
    assert sharding.logical_to_spec(("batch", "seq", "embed"), mesh,
                                    rules={}) == (("data",),)
    # non-divisible dim dropped when shape given (49155 % 16 != 0)
    assert sharding.logical_to_spec(("vocab", "embed"), mesh, rules={},
                                    shape=(49155, 2048)) == (None, "data")
    # divisible vocab keeps the mapping
    assert sharding.logical_to_spec(("vocab", "embed"), mesh, rules={},
                                    shape=(49280, 2048)) == ("model", "data")
    assert sharding.batch_axes(mesh) == ("data",)
    assert sharding.batch_axes(_mesh(("pod", "data", "model"),
                                     (2, 2, 2))) == ("pod", "data")


@pytest.mark.parametrize("seed", range(8))
def test_logical_spec_sweep_equals_reference(seed):
    pytest.importorskip("jax")
    rng = np.random.default_rng(seed)
    rule_sets = [{}, {"heads": None, "head_dim": "model"},
                 {"kv_heads": "model", "embed": None},
                 {"attn_batch": ("pod", "data", "model"), "heads": None}]
    for _ in range(60):
        names, shape = MESHES[rng.integers(len(MESHES))]
        mesh = _mesh(names, shape)
        ndim = int(rng.integers(1, 6))
        axes = tuple(NAMES[i] for i in rng.integers(len(NAMES), size=ndim))
        dims = tuple(int(d) for d in rng.choice([1, 2, 3, 8, 12, 16, 48, 64,
                                                 49155, 49280], size=ndim))
        rules = rule_sets[rng.integers(len(rule_sets))]
        for sh in (None, dims):
            ours = sharding.logical_to_spec(axes, mesh, rules, sh)
            assert _same_spec(ours, axes, mesh, rules, sh), \
                (ours, axes, names, rules, sh)


def test_to_placements_maps_spec_to_mesh_dims():
    mesh = _mesh(("pod", "data", "model"), (2, 2, 2))
    S, R = sharding.Shard, sharding.Replicate
    assert sharding.to_placements((("pod", "data"), None, "model"), mesh,
                                  3) == (S(0), S(0), S(2))
    assert sharding.to_placements(("model",), mesh, 2) == (R(), R(), S(0))
    assert sharding.to_placements((), mesh, 0) == (R(), R(), R())
    with pytest.raises(ValueError):
        sharding.to_placements((None, None, "data"), mesh, 2)


def _ref_param_axes(arch):
    """{port parameter name: axes} of the reference's axes tree: a stacked
    leaf's leading "layers" entry dropped, the stacks expanded per layer."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import module as jmodule
    from repro.models import registry as jregistry

    cfg = jsmoke(arch)
    tree = jax.eval_shape(jregistry.get_model(cfg).init,
                          jax.random.PRNGKey(0))
    values, axes = jmodule.split(tree)

    def is_axes(x):
        return isinstance(x, tuple) and not hasattr(x, "_fields") and \
            all(e is None or isinstance(e, str) for e in x)

    flat, _ = jax.tree_util.tree_flatten_with_path(axes, is_leaf=is_axes)
    vflat = jax.tree.leaves(values)
    out = {}
    for (path, ax), v in zip(flat, vflat):
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        if ax and ax[0] == "layers":
            ax = ax[1:]
            if keys[0] in ("layers", "enc_layers", "dec_layers"):
                for i in range(v.shape[0]):
                    out[".".join([keys[0], str(i)] + keys[1:])] = ax
                continue
        out[".".join(keys)] = ax
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(arch):
    model = get_model(get_smoke_config(arch), device="meta")
    ours = param_axes(model)
    assert ours == _ref_param_axes(arch)
    shapes = dict(model.named_parameters())
    assert all(len(ax) == shapes[k].dim() for k, ax in ours.items())


def test_constrain_is_identity_without_mesh():
    x = torch.ones((4, 4))
    assert sharding.active_mesh() is None and sharding.active_rules() == {}
    assert sharding.constrain(x, "batch", "embed") is x
    assert sharding.gathered(x) is x
    assert sharding.on_mesh(x, None, "batch", "embed") is x


def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((64, 33)).astype(np.float32) * 10 ** rng
          .uniform(-6, 3), np.zeros((5,), np.float32),
          rng.standard_normal((7,)).astype(np.float32) * 1e-14]
    # scale exactly 1: every x/scale below is a half-step tie
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     3.0, -127.0], np.float32)
    return xs + [ties]


@pytest.mark.parametrize("seed", range(4))
def test_int8_quantization_is_bitwise_the_reference(seed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist import compression as jcomp

    for x in _quant_inputs(seed):
        q, s = compression.quantize_int8(torch.as_tensor(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        deq = compression.dequantize_int8(q, s)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(jcomp.dequantize_int8(jq, js)))
        assert float((deq - torch.as_tensor(x)).abs().max()) <= \
            float(s) / 2 * (1 + 1e-6)


def test_int8_rounds_ties_to_even():
    q, s = compression.quantize_int8(torch.as_tensor(_quant_inputs(0)[-1]))
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 3, -127]


def test_error_buffers_have_a_row_per_replica():
    params = {"w": torch.ones((3, 2)), "b": torch.ones(())}
    errs = compression.init_error_buffers(params, n_shards=4)
    assert {k: tuple(v.shape) for k, v in errs.items()} == \
        {"w": (4, 3, 2), "b": (4,)}
    assert all(v.dtype == torch.float32 and not v.any()
               for v in errs.values())


def _ref_cache_spec(path, leaf, b):
    """The reference's path-pattern rule (``repro.launch.shardings.
    cache_shardings``) for one cache leaf."""
    if leaf.dim() == 5:
        return (None, b, "model", None, None)
    if leaf.dim() == 3:
        return (None, b, "model")
    if leaf.dim() == 4:
        return ((None, b, None, "model") if "conv" in path
                else (None, b, "model", None))
    return ()


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_cache_and_batch_shardings_follow_reference_rules(arch):
    pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P
    from repro.launch.shardings import _drop_nondivisible as jdrop
    from repro_torch.launch import shardings as sh
    from repro_torch.models import registry
    from repro_torch.models.config import ShapeConfig

    mesh = _mesh(("pod", "data", "model"), (2, 2, 4))
    b = ("pod", "data")
    cfg = get_smoke_config(arch)
    cache, tokens, _ = registry.decode_input_specs(
        cfg, ShapeConfig("d", 64, 8, "decode"))
    got = sh.cache_shardings(cache, mesh)

    def walk(tree, out, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, out, f"{path}/{k}")
        elif isinstance(tree, tuple) and \
                not isinstance(tree, sharding.Sharding):
            for f, v in zip(getattr(tree, "_fields", range(len(tree))), tree):
                walk(v, out, f"{path}/{f}")
        else:
            out[path] = tree
        return out

    leaves, placed = walk(cache, {}), walk(got, {})
    assert leaves.keys() == placed.keys()
    for path, leaf in leaves.items():
        spec = tuple(jdrop(P(*_ref_cache_spec(path, leaf, b)),
                           tuple(leaf.shape), mesh))
        assert placed[path].placements == sharding.to_placements(
            spec, mesh, leaf.dim()), path
    bs = sh.batch_shardings({"tokens": tokens}, mesh)["tokens"]
    assert bs.placements == (sharding.Shard(0), sharding.Shard(0),
                             sharding.Replicate())


def test_train_state_shardings_mirror_params():
    from repro_torch.launch import shardings as sh
    from repro_torch.models.registry import sharding_rules

    mesh = _mesh(("data", "model"), (2, 2))
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    model = get_model(cfg, device="meta")
    sds, st = sh.train_state_shardings(model, mesh, sharding_rules(cfg, 2))
    assert st.step.placements == (sharding.Replicate(),) * 2
    assert st.opt.step.placements == (sharding.Replicate(),) * 2
    assert st.params.keys() == sds.params.keys() == st.opt.mu.keys()
    for k, s in st.params.items():
        assert st.opt.mu[k] == s and st.opt.nu[k] == s
        assert sds.opt.mu[k].dtype == torch.float32
        assert sds.params[k].device.type == "meta"
    # the experts' hidden dim is tensor-parallel, the embed dim FSDP
    assert st.params["layers.0.moe.w_gate"].placements == \
        (sharding.Shard(1), sharding.Shard(2))
