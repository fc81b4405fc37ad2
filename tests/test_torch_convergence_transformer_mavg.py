"""E1's tiny-transformer case (quick mode), the M-AVG arm, on the port fed
the JAX runner's inputs; the K-AVG arm and the tolerance are in
``test_torch_convergence_transformer.py``, which this file shares."""
import pytest

pytest.importorskip("torch")

from test_torch_convergence_transformer import check_arm  # noqa: E402

from repro_torch.benchmarks import convergence  # noqa: E402


def test_tiny_transformer_mavg_fed_jax_inputs_matches_jax():
    check_arm(*convergence.ARMS[1])
