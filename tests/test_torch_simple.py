"""The port's CNN, accuracies and teacher-classification stream against
the JAX package's ``models/simple.py`` and ``data/synthetic.py``.

The CNN at hw=12 in float32 (E1's shape): forward logits, loss and the
gradient of every leaf agree to rtol=1e-5, atol=1e-6 (XLA:CPU and ATen sum
the 3x3 convolutions and the matmul in other orders). The parameters keep
JAX's HWIO shapes, so the packed layout is JAX's, key for key. Teacher
labels are equal exactly on the same teacher weights and features (the
argmax of nearly tied logits could differ in principle; the seeded inputs
here have no such tie). Three M-AVG / K-AVG meta steps on the CNN,
packed and per-leaf, agree per step and on every plane to rtol=1e-5,
atol=1e-6, with JAX's Pallas kernels in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MAvgConfig as JMAvgConfig  # noqa: E402
from repro.core.meta import init_state as jinit_state  # noqa: E402
from repro.core.meta import make_meta_step as jmake_meta_step  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.pack import make_pack_spec as jmake_pack_spec  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import MAvgConfig  # noqa: E402
from repro_torch.core.meta import init_state, make_meta_step  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.pack import make_pack_spec  # noqa: E402
from repro_torch.utils.rng import seeded_generator  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

HW, CLASSES = 12, 10
TOL = dict(rtol=1e-5, atol=1e-6)
JPARAMS = jax.device_get(jsimple.cnn_init(jax.random.PRNGKey(0), hw=HW,
                                          classes=CLASSES))


def _batch(seed, lead=(), B=8):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal(lead + (B, HW, HW, 3)).astype(np.float32),
        "y": rng.integers(0, CLASSES, lead + (B,)).astype(np.int32),
    }


def test_cnn_forward_loss_and_grads_match_jax():
    b = _batch(0)
    jlogits = np.asarray(jsimple.cnn_forward(JPARAMS, b["x"]))
    (jloss, _), jgrads = jax.value_and_grad(jsimple.cnn_loss, has_aux=True)(
        JPARAMS, b)
    params = {k: v.requires_grad_(True)
              for k, v in interop.params_from_jax(JPARAMS).items()}
    tb = interop.params_from_jax(b)
    logits = tsimple.cnn_forward(params, tb["x"])
    assert tuple(logits.shape) == jlogits.shape == (8, CLASSES)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    loss, aux = tsimple.cnn_loss(params, tb)
    assert aux == {}
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    loss.backward()
    for k in sorted(JPARAMS):
        assert tuple(params[k].grad.shape) == JPARAMS[k].shape, k
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(jgrads[k]), **TOL, err_msg=k)


def test_cnn_init_shapes_are_jaxs_hwio():
    params = tsimple.cnn_init(seeded_generator("cpu", 0), hw=HW,
                              classes=CLASSES, device="cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in JPARAMS.items()}
    assert params["c1"].shape == (3, 3, 3, 16)
    assert params["out"].shape == (3 * 3 * 32, CLASSES)
    assert torch.all(params["b_out"] == 0)


@pytest.mark.parametrize("model", ["cnn", "mlp"])
def test_accuracy_matches_jax(model):
    if model == "cnn":
        jp, b = JPARAMS, _batch(1, B=64)
    else:
        jp = jax.device_get(jsimple.mlp_init(jax.random.PRNGKey(3), 32, 64,
                                             CLASSES))
        rng = np.random.default_rng(2)
        b = {"x": rng.standard_normal((64, 32)).astype(np.float32),
             "y": rng.integers(0, CLASSES, 64).astype(np.int32)}
    want = float(getattr(jsimple, f"{model}_accuracy")(jp, b))
    got = getattr(tsimple, f"{model}_accuracy")(
        interop.params_from_jax(jp), interop.params_from_jax(b))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == want
    assert 0.0 <= want <= 1.0


def test_cnn_layout_dict_equals_jax():
    """The CNN's 4-D HWIO leaves pack to JAX's layout, key for key."""
    want = jmake_pack_spec(JPARAMS).layout_dict()
    got = make_pack_spec(interop.params_from_jax(JPARAMS)).layout_dict()
    assert got == want
    assert got["paths"] == ["b_out", "c1", "c2", "out"]
    meta = make_pack_spec(tsimple.cnn_init(None, hw=HW, device="meta"))
    assert meta.layout_dict() == want


def test_pack_numpy_matches_jax():
    """pack_numpy with a leading learner axis, as the legacy restore uses
    it, is JAX's buffer bit for bit."""
    jspec = jmake_pack_spec(JPARAMS)
    spec = make_pack_spec(interop.params_from_jax(JPARAMS))
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal((2,) + tuple(s)).astype(np.float32)
              for s in spec.shapes]
    want = jspec.pack_numpy(leaves)
    got = spec.pack_numpy(leaves)
    assert got.shape == want.shape == (2, spec.rows, 128)
    np.testing.assert_array_equal(got, want)
    # bf16 leaves (raw V2 words, as a JAX .npz holds them) pack as words:
    # the top halves of the f32 values land where the f32 values did
    words = [(x.view(np.uint32) >> 16).astype(np.uint16).view("V2")
             for x in leaves]
    bf = spec.pack_numpy(words, dtype="bfloat16")
    assert bf.dtype == np.dtype("V2") and bf.shape == want.shape
    np.testing.assert_array_equal(bf.view(np.uint16),
                                  (want.view(np.uint32) >> 16)
                                  .astype(np.uint16))


def test_teacher_labels_match_jax():
    jt = jax.device_get(jsyn.make_teacher(7, 32, CLASSES))
    x = np.random.default_rng(3).standard_normal((512, 32)).astype(
        np.float32)
    want = np.asarray(jsyn._teacher_labels(jt, x))
    got = tsyn._teacher_labels(interop.params_from_jax(jt),
                               torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 3  # the teacher uses several classes


def test_classif_stream_shapes_and_determinism():
    bf = tsyn.classif_batch_fn(32, CLASSES, 4, 2, 8, device="cpu")
    a = bf(seeded_generator("cpu", 1, 0), 0)
    b = bf(seeded_generator("cpu", 1, 0), 0)
    c = bf(seeded_generator("cpu", 1, 1), 1)
    assert a["x"].shape == (4, 2, 8, 32) and a["y"].shape == (4, 2, 8)
    assert a["x"].dtype == torch.float32 and a["y"].dtype == torch.int32
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
    assert not torch.equal(a["x"], c["x"])
    teacher = tsyn.make_teacher(7, 32, CLASSES, device="cpu")
    assert torch.equal(a["y"], tsyn._teacher_labels(teacher, a["x"]))
    noisy = tsyn.classif_batch_fn(32, CLASSES, 4, 2, 8, noise=0.5,
                                  device="cpu")(seeded_generator("cpu", 1, 0),
                                                0)
    # labels come from the clean features, as in JAX
    assert torch.equal(noisy["y"], a["y"])
    assert not torch.equal(noisy["x"], a["x"])
    ev = tsyn.classif_eval_set(32, CLASSES, n=64, device="cpu")
    assert ev["x"].shape == (64, 32)
    assert torch.equal(ev["y"], tsyn._teacher_labels(teacher, ev["x"]))


def test_bigram_table_on_the_generators_device():
    t = tsyn.bigram_table(torch.Generator("cpu").manual_seed(0), 16)
    assert t.device.type == "cpu" and t.shape == (16, 16)
    torch.testing.assert_close(t.sum(-1), torch.ones(16))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per-leaf"])
@pytest.mark.parametrize("algorithm,mu", [("mavg", 0.7), ("kavg", 0.0)])
def test_cnn_meta_steps_match_jax(algorithm, mu, packed):
    L, K = 2, 2
    kw = dict(algorithm=algorithm, num_learners=L, k_steps=K,
              learner_lr=0.1, momentum=mu, packed=packed)
    batches = [_batch(10 + i, lead=(L, K), B=4) for i in range(3)]
    jcfg = JMAvgConfig(**kw, use_pallas=True)
    jstate = jinit_state(JPARAMS, jcfg)
    jstep = jax.jit(jmake_meta_step(jsimple.cnn_loss, jcfg))
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))

    cfg = MAvgConfig(**kw)
    state = init_state(interop.params_from_jax(JPARAMS), cfg)
    step = make_meta_step(tsimple.cnn_loss, cfg)
    losses = []
    for b in batches:
        state, m = step(state, interop.params_from_jax(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, **TOL)
    assert state.step == int(jstate.step) == 3
    for field in ("global_params", "momentum", "learners"):
        got = tree_leaves(getattr(state, field))
        want = jax.tree.leaves(getattr(jstate, field))
        assert len(got) == len(want) == (1 if packed else 4)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                       err_msg=field)
