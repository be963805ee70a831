"""Mesh training on the card: a one-rank NCCL group and its ("data",
"model") mesh train the smoke granite, qwen2-moe, falcon-mamba, zamba2
and seamless in float32 through ``repro_torch.launch.train.
train_on_mesh`` (falcon-mamba also at one row, a batch dim of size 1),
with losses equal to the meshless run's on the same weights and batches
within rtol 1e-5 (one rank: every shard is the whole tensor, so the same
kernels see the same operands).

Every test here is marked ``gpu`` and skips where no CUDA card is present.
The module imports no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_mesh_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402

TC = dict(lr=3e-3, warmup_steps=2, total_steps=40)


@pytest.fixture(scope="module")
def card_group(tmp_path_factory):
    """A one-rank NCCL group on card 0 for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,batch", [
    ("granite-3-2b", 4), ("qwen2-moe-a2.7b", 4), ("falcon-mamba-7b", 4),
    ("falcon-mamba-7b", 1), ("zamba2-1.2b", 4), ("seamless-m4t-medium", 4)])
def test_one_rank_mesh_matches_meshless_on_the_card(card_group, arch,
                                                    batch):
    from repro_torch.launch.train import launch_mesh, train_on_mesh
    dev = card_group
    cfg = get_smoke_config(arch).replace(dtype="float32")
    stream = TokenStream(cfg, batch, 32, seed=0)
    quiet = dict(log_every=0, log_fn=lambda *_: None)
    mesh_hist, plain_hist = [], []
    model, state = train_on_mesh(cfg, launch_mesh(1, "cuda"),
                                 TrainConfig(**TC), stream, 4, device=dev,
                                 history=mesh_hist, **quiet)
    assert all(type(p).__name__ == "DTensor" for p in model.parameters())
    plain = get_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    train(plain, TrainConfig(**TC), stream, 4, history=plain_hist, **quiet)
    np.testing.assert_allclose([h["loss"] for h in mesh_hist],
                               [h["loss"] for h in plain_hist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in mesh_hist],
                               [h["grad_norm"] for h in plain_hist],
                               rtol=1e-5)


@pytest.mark.gpu
def test_moe_trains_in_bf16_on_the_card(card_group):
    """The smoke qwen2-moe in bf16 trains on the card without a mesh (the
    gate product takes a differentiable float32 product when autograd
    records) and on the one-rank mesh; the first update has lr 0, so the
    two steps' losses match within rtol 1e-5."""
    from repro_torch.launch.train import launch_mesh, train_on_mesh
    dev = card_group
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    assert cfg.dtype == "bfloat16"
    stream = TokenStream(cfg, 4, 32, seed=0)
    quiet = dict(log_every=0, log_fn=lambda *_: None)
    mesh_hist, plain_hist = [], []
    train_on_mesh(cfg, launch_mesh(1, "cuda"), TrainConfig(**TC), stream, 2,
                  device=dev, history=mesh_hist, **quiet)
    plain = get_model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    train(plain, TrainConfig(**TC), stream, 2, history=plain_hist, **quiet)
    for hist in (mesh_hist, plain_hist):
        assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0
                   for h in hist)
    np.testing.assert_allclose([h["loss"] for h in mesh_hist],
                               [h["loss"] for h in plain_hist], rtol=1e-5)
