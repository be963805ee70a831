"""The selective-scan kernel's variant timer
(``repro_torch.kernels.ssm_variants``) without a card: every ablation
edits the kernel's source exactly once, and the timer refuses to run
where there is no card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, _variants  # noqa: E402
from repro_torch.kernels import ssm_variants as sv  # noqa: E402


@pytest.mark.parametrize("name", sorted(sv.ABLATIONS))
def test_every_ablation_edits_the_kernel_once(name):
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    edits = sv.ABLATIONS[name]
    assert all(src.count(old) == 1 for old, _ in edits)
    edited = sv.variant_sources()[name]
    assert edited != src
    want = src
    for old, new in edits:
        want = want.replace(old, new)
    assert edited == want
    # only the kernel's body is touched, not its note or the host code
    body = src.index("ssm_scan_kernel(const TX*")
    host = src.index("cudaError_t launch(")
    assert all(body < src.index(old) < host for old, _ in edits)


@pytest.mark.parametrize("name", sorted(sv.TUNINGS))
def test_every_tuning_edits_the_kernel_once(name):
    src = (_build.CSRC / "ssm_scan.cu").read_text()
    assert all(src.count(old) == 1 for old, _ in sv.TUNINGS[name])
    assert sv.variant_sources(tunings=True)[name] != src


def test_an_edit_that_no_longer_matches_fails_loudly():
    with pytest.raises(RuntimeError, match="no_such_text"):
        _variants.ablated_sources("int x;", {"no_such_text": (
            ("int y;", ""),)}, "x.cu")


def test_timer_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        sv.main([])
