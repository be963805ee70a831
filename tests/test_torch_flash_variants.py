"""The flash kernel's variant timer (``repro_torch.kernels.flash_variants``)
without a card: every ablation edits the kernel's source exactly once,
and the timer refuses to run where there is no card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_variants as fv  # noqa: E402


@pytest.mark.parametrize("name", sorted(fv.ABLATIONS))
def test_every_ablation_edits_the_bf16_kernel_once(name):
    src = (_build.CSRC / "flash_attention.cu").read_text()
    old, new = fv.ABLATIONS[name]
    assert src.count(old) == 1
    edited = fv.variant_sources()[name]
    assert edited == src.replace(old, new) and edited != src
    # only the tensor-core kernel is touched
    mma = src.index("// ---- bf16 on the tensor cores")
    assert src.index(old) > mma


def test_timer_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        fv.main([])


@pytest.mark.parametrize("S,D,window", [(256, 64, 0), (300, 120, 100)])
def test_split_p_keeps_the_bf16_limit_that_bf16_p_misses(S, D, window):
    """Why the bf16 kernel splits P: with P rounded to bf16 once before
    P.V, outputs miss the bf16 limit 2e-5 + 2^-7 |want|; as bf16 hi + lo
    they stay within it."""
    gen = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn((1, S, 2, D), generator=gen).bfloat16()
               for _ in range(3))
    split, split_over = fv.p_rounding_error(q, k, v, "split", window=window)
    once, once_over = fv.p_rounding_error(q, k, v, "bf16", window=window)
    assert split <= 1.0 and split_over == 0.0
    assert once > 3.0 and once_over > 0.01
