"""Port parity: the registry's shape cells (``SHAPES``,
``shape_applicable``, the train / prefill / decode input specs),
``model_bytes`` / ``model_flops`` and ``sharding_rules``, for every
architecture at its published config against ``repro.models.registry``.

The specs are compared by shape and dtype (the port's are ``meta``
tensors, the reference's ``ShapeDtypeStruct``s); the decode caches leaf
by leaf under the same path.  Bytes and FLOPs: rtol 1e-12 (the same
float64 arithmetic on the same counts).  The reference's parameter counts
are taken once per architecture (they trace the whole init abstractly).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.fixture(scope="module")
def jcounts():
    """The reference's registry with its parameter counts cached (each
    count traces the model's init)."""
    orig = (jregistry.count_params, jregistry.count_active_params)
    jregistry.count_params = functools.lru_cache(None)(orig[0])
    jregistry.count_active_params = functools.lru_cache(None)(orig[1])
    yield jregistry
    jregistry.count_params, jregistry.count_active_params = orig


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[-1]
    return np.dtype(x.dtype).name


def _leaves(tree, path=""):
    """{path: (shape, dtype)} of a cache tree of dicts, NamedTuples and
    tuples: the port's tensors or the reference's ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{path}/{f}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: (tuple(tree.shape), _dtype(tree))}


def test_shapes_equal_reference():
    assert list(SHAPES) == list(jconfig.SHAPES)
    for name, shape in SHAPES.items():
        ref = jconfig.SHAPES[name]
        assert isinstance(shape, ShapeConfig)
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (ref.name, ref.seq_len, ref.global_batch, ref.kind)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_applicability_and_input_specs_equal_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], jconfig.SHAPES[shape]
    assert registry.shape_applicable(cfg, s) == \
        jregistry.shape_applicable(jcfg, js)
    for ours, ref in ((registry.train_input_specs(cfg, s),
                       jregistry.train_input_specs(jcfg, js)),
                      (registry.prefill_input_specs(cfg, s),
                       jregistry.prefill_input_specs(jcfg, js))):
        assert _leaves(ours) == _leaves(ref)
        assert all(v.device.type == "meta" for v in ours.values())
    if s.kind == "decode":
        cache, tokens, pos = registry.decode_input_specs(cfg, s)
        jcache, jtokens, jpos = jregistry.decode_input_specs(jcfg, js)
        assert _leaves(cache) == _leaves(jcache)
        assert _leaves(tokens) == _leaves(jtokens)
        assert _leaves(pos) == _leaves(jpos)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_bytes_and_flops_equal_reference(arch, shape, jcounts):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], jconfig.SHAPES[shape]
    np.testing.assert_allclose(registry.model_bytes(cfg, s),
                               jcounts.model_bytes(jcfg, js), rtol=1e-12)
    np.testing.assert_allclose(registry.model_flops(cfg, s),
                               jcounts.model_flops(jcfg, js), rtol=1e-12)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("model_axis", [1, 2, 4, 16])
def test_sharding_rules_equal_reference(arch, model_axis):
    assert registry.sharding_rules(get_config(arch), model_axis) == \
        jregistry.sharding_rules(jget_config(arch), model_axis)
