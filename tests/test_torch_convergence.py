"""E1 on the port's own streams, its entry points on the CPU.

``repro_torch.benchmarks.convergence.main(quick=True, device="cpu")``
draws its own params and batches (torch generators, not JAX's streams)
and asserts the paper's claim where the reference asserts it: for each
model whose two arms both reach the target, M-AVG needs at most 1.1x the
samples K-AVG needs. On these streams, as in JAX, the MLP and the tiny
transformer reach their targets in both arms and the CNN in neither. The
parity of the runners with JAX on JAX's inputs is in
``test_torch_convergence_{mlp,cnn,transformer}*.py``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import convergence  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402

torch.set_num_threads(2)


def test_main_quick_on_cpu_asserts_e1():
    lines = []
    rows, summaries = convergence.main(quick=True, device="cpu",
                                       log=lines.append)
    assert [r[:3] for r in rows] == [
        (m, a, mu) for m in ("mlp", "cnn", "tiny-transformer")
        for a, mu in convergence.ARMS]
    csv = [ln for ln in lines if ln.startswith("convergence,")]
    assert csv[0].startswith("convergence,mlp,kavg,mu=0.0,final_loss=")
    assert "samples_to_1.0=" in csv[0]
    records = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert records == summaries
    by = {s["model"]: s for s in summaries}
    assert [s["target"] for s in summaries] == [1.0, 2.2, 5.5]
    for model in ("mlp", "tiny-transformer"):
        s = by[model]
        assert s["kavg_reached"] and s["mavg_reached"] and s["asserted"]
        assert s["m_stt"] <= 1.1 * s["k_stt"]
        assert s["speedup"] == s["k_stt"] / s["m_stt"]
        assert f"convergence,{model},speedup," in "\n".join(lines)
    cnn = by["cnn"]
    assert not cnn["kavg_reached"] and not cnn["mavg_reached"]
    assert not cnn["asserted"] and cnn["speedup"] is None
    for r in rows:
        assert r[3] == r[3] and 0.0 < r[4]  # finite loss, positive metric


def _fake_case(k_losses, m_losses, target=1.0):
    def runner(algo, *, mu, device, **kw):
        return (k_losses if algo == "kavg" else m_losses), 0.5

    return (("fake", runner, dict(P=1, K=1, batch=1), target),)


@pytest.mark.parametrize("k_losses,m_losses,raises", [
    ([2.0, 0.5], [2.0, 2.0, 0.5], True),   # M-AVG 1.5x slower: the claim fails
    ([2.0, 2.0, 0.5], [2.0, 0.5], False),  # M-AVG faster
    ([2.0, 2.0], [0.5], False),            # K-AVG never reaches: no assert
])
def test_main_asserts_only_where_the_reference_does(monkeypatch, k_losses,
                                                    m_losses, raises):
    monkeypatch.setattr(convergence, "cases",
                        lambda quick: _fake_case(k_losses, m_losses))
    if raises:
        with pytest.raises(AssertionError):
            convergence.main(quick=True, device="cpu", log=lambda s: None)
    else:
        _, (s,) = convergence.main(quick=True, device="cpu",
                                   log=lambda s: None)
        assert s["asserted"] == (s["k_stt"] is not None)


def test_samples_to_target_is_the_references():
    from repro_torch.benchmarks.common import samples_to_target

    assert samples_to_target([3.0, 2.0, 0.9, 1.5], 1.0, 4, 4, 16) == 768
    assert samples_to_target([3.0, 2.0], 1.0, 4, 4, 16) is None
    assert samples_to_target([0.5], 1.0, 2, 2, 2) == 8


def test_quickstart_runs_on_cpu(capsys):
    k_losses, m_losses = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "K-AVG (the baseline: mu = 0)" in out
    assert "mavg  samples=   256" in out and "final: K-AVG loss=" in out
    assert len(k_losses) == len(m_losses) == 60
    assert k_losses[-1] < k_losses[0] and m_losses[-1] < m_losses[0]
