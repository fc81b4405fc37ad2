"""The port stands alone: it imports no JAX, nothing of ``repro``, nothing
of the root ``benchmarks`` package (which imports JAX) and no
``ml_dtypes``, and its configs equal the JAX package's field for field."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro|benchmarks|ml_dtypes)"
    r"(?:\.|\s|$)", re.MULTILINE)


def test_no_jax_or_repro_import_in_sources():
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) > 20
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []
    assert not FORBIDDEN.search((ROOT / "chip_smoke.py").read_text())


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'benchmarks', 'ml_dtypes'))\n"
        "subs = {'repro_torch.benchmarks.convergence', "
        "'repro_torch.checkpoint.npz', 'repro_torch.examples.quickstart', "
        "'repro_torch.models.hymba', 'repro_torch.models.xlstm'}\n"
        "print(len(names), bad, sorted(subs - set(names)))\n"
        "sys.exit(1 if bad or len(names) < 20 or subs - set(names) else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_model_configs_equal_jax(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(
        jcfg.reduced())
    assert dataclasses.asdict(tbase.TrainConfig(model=tcfg)) == \
        dataclasses.asdict(jbase.TrainConfig(model=jcfg))


def test_default_run_configs_equal_jax():
    assert dataclasses.asdict(tbase.MAvgConfig()) == dataclasses.asdict(
        jbase.MAvgConfig())
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.ALGORITHMS == jbase.ALGORITHMS
    assert tbase.AVERAGING_ALGOS == jbase.AVERAGING_ALGOS


def test_chaos_configs_equal_jax():
    """The port's copy of ``chaos/config.py``: the same dataclasses, field
    for field (names, types, defaults), the same kinds and limits."""
    from repro.chaos import config as jchaos
    from repro_torch.chaos import config as tchaos

    for name in ("ChaosConfig", "FaultSpec"):
        jf = dataclasses.fields(getattr(jchaos, name))
        tf = dataclasses.fields(getattr(tchaos, name))
        assert [(f.name, f.type, f.default) for f in tf] == [
            (f.name, f.type, f.default) for f in jf]
    for const in ("FAULT_KINDS", "LEARNER_KINDS", "STANDARD_KINDS",
                  "FINITE_SCALE_MAX"):
        assert getattr(tchaos, const) == getattr(jchaos, const)
    spec = dict(kind="finite_bitflip", step=2, learner=1, duration=3,
                bit=31, sticky=True)
    assert dataclasses.asdict(tchaos.FaultSpec(**spec)) == \
        dataclasses.asdict(jchaos.FaultSpec(**spec))
    assert dataclasses.asdict(tchaos.ChaosConfig()) == \
        dataclasses.asdict(jchaos.ChaosConfig())
