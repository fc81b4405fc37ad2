"""The port's Trainer on a mesh (``Trainer(mesh=, state_shardings=)``):
the counterpart of JAX's ``tests/test_system.py::test_meta_step_under_real_mesh``
(which does not run on this jax). The same 4 meta steps of the reduced
Qwen3 (L=4, K=2, lr 0.5, momentum 0.6, B=8, S=32 on the bigram stream)
run in one process and on a real gloo group of 4 CPU ranks, a (2, 2)
('data', 'model') DeviceMesh: 2 learners a rank, the packed planes'
rows split over 'model' (the local phase all-gathers them), the learner
mean completed over 'data'. The losses agree within JAX's 5e-2; they
differ only in the mean's summation order (measured: printed).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import json, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def trainer(mesh=None):
    from repro_torch.configs.base import MAvgConfig, TrainConfig, get_config
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api

    cfg = get_config("qwen3-1.7b").reduced()
    mcfg = MAvgConfig(algorithm="mavg", num_learners=4, k_steps=2,
                      learner_lr=0.5, momentum=0.6)
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=8,
                       seq_len=32, meta_steps=4, log_every=1)
    return Trainer(tcfg, lambda p, b: api.loss_fn(p, cfg, b),
                   init_params_fn=lambda g: api.init_params(g, cfg, "cpu"),
                   batch_fn=lm_batch_fn(cfg, 4, 2, 8, 32, device="cpu"),
                   device="cpu", mesh=mesh)


def rank_main(rank, port, queue):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        tr = trainer(mesh)
        split = str(tr.state.learners.placements)
        hist = tr.run(log=None)
        if rank == 0:
            queue.put({"losses": [h["loss"] for h in hist], "split": split,
                       "local": list(tr.state.learners.to_local().shape)})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "single":
        torch.set_num_threads(1)
        print(json.dumps([h["loss"] for h in trainer().run(log=None)]))
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        mp.start_processes(rank_main, args=(port, queue), nprocs=4,
                           start_method="spawn")
        print(json.dumps(queue.get()))
'''


def test_trainer_on_a_gloo_mesh_of_4_ranks_matches_one_process(tmp_path):
    script = tmp_path / "mesh_run.py"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def run(mode):
        out = subprocess.run([sys.executable, str(script), mode], env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    mesh = run("mesh")
    single = run("single")
    assert mesh["split"] == "(Shard(dim=0), Shard(dim=1))"
    assert mesh["local"][0] == 2  # two of the four learners a rank
    diffs = [abs(a - b) for a, b in zip(mesh["losses"], single)]
    print(f"losses on the mesh {mesh['losses']}, in one process {single}, "
          f"max |diff| {max(diffs):.3e}")
    assert len(diffs) == 4 and max(diffs) < 5e-2, (mesh, single)


DECODE_SCRIPT = r'''
import dataclasses, json, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def steps(arch, mesh=None):
    """A prefill of 8 tokens into a 16-row cache, then 3 decode steps'
    logits, on the reduced config in f32 (placed by the serving specs on
    ``mesh``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import specs as S
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                         dtype=torch.int32)
    _, cache = api.prefill(params, cfg, {"tokens": toks}, 16)
    nxt = torch.randint(0, cfg.vocab_size, (3, 2), generator=gen,
                        dtype=torch.int32)
    if mesh is not None:
        shape = InputShape("decode", 16, 2, "decode")
        params = S.place_tree(params, S.serve_param_shardings(cfg, mesh),
                              mesh)
        cache = S.place_tree(cache, S.cache_shardings(cfg, mesh, shape),
                             mesh)
    out = []
    for t in nxt:
        if mesh is not None:
            t = S.place(t, S.Spec(None), mesh)
        with implicit_replication():
            logits, cache = api.decode_step(params, cfg, cache, t)
        if mesh is not None:
            logits = logits.full_tensor()
        out.append(logits.tolist())
    return out


def rank_main(rank, port, arch, queue):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        out = steps(arch, mesh)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    arch = sys.argv[2]
    if sys.argv[1] == "single":
        print(json.dumps(steps(arch)))
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        mp.start_processes(rank_main, args=(port, arch, queue), nprocs=2,
                           start_method="spawn")
        print(json.dumps(queue.get()))
'''


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_placed_decode_on_a_gloo_mesh_matches_one_process(tmp_path, arch):
    """The dry run's serving program computes what one device does: 3
    decode steps with the weights placed by ``serve_param_shardings`` and
    the cache split along its sequence over 'model' (2 gloo ranks), the
    new rows written by the rank holding them (``layers.index_copy_``) and
    the softmax completed across the split (a partitioned softmax), give
    one process's logits within rtol 1e-5 (f32)."""
    import numpy as np

    script = tmp_path / "decode_run.py"
    script.write_text(DECODE_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def run(mode):
        out = subprocess.run([sys.executable, str(script), mode, arch],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return np.array(json.loads(out.stdout.strip().splitlines()[-1]))

    mesh, single = run("mesh"), run("single")
    assert mesh.shape == single.shape == (3, 2, mesh.shape[-1])
    np.testing.assert_allclose(mesh, single, rtol=1e-5, atol=1e-5)
