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

    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                         dtype=torch.int32)
    _, cache = api.prefill(params, cfg, {"tokens": toks}, 16)
    nxt = torch.randint(0, cfg.vocab_size, (3, 2), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": toks}
    if mesh is not None:
        shape = InputShape("decode", 16, 2, "decode")
        params = S.place_tree(params, S.serve_param_shardings(cfg, mesh),
                              mesh)
        cache = S.place_tree(cache, S.cache_shardings(cfg, mesh, shape),
                             mesh)
        batch = S.place_tree(batch, S.prefill_input_shardings(
            cfg, mesh, InputShape("prefill", 8, 2, "prefill")), mesh)
    # the prefill row's forward, its attention blockwise as at 32k tokens
    L.ATTN_CHUNK_THRESHOLD = 4
    with implicit_replication():
        logits, _ = api.forward(params, cfg, batch)
    L.ATTN_CHUNK_THRESHOLD = 8192
    if mesh is not None:
        logits = logits.full_tensor()
    out = [logits[:, -1].tolist()]
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


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "hymba-1.5b", "xlstm-350m"])
def test_placed_decode_on_a_gloo_mesh_matches_one_process(tmp_path, arch):
    """The dry run's serving programs compute what one device does: the
    prefill row's forward (attention blockwise, as above 8,192 tokens: on
    each rank's pieces where heads and batch split alike) and 3 decode
    steps with the weights placed by ``serve_param_shardings`` and the
    cache by ``cache_shardings`` (a KV cache split along its sequence over
    'model', Hymba's window and SSM state, xLSTM's recurrent state; 2 gloo
    ranks), the new rows written by the rank holding them
    (``layers.index_copy_``) and the softmax completed across the split
    (a partitioned softmax), give one process's logits within rtol 1e-5
    (f32)."""
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
    assert mesh.shape == single.shape == (4, 2, mesh.shape[-1])
    np.testing.assert_allclose(mesh, single, rtol=1e-5, atol=1e-5)


PLACED_SCRIPT = r'''
import dataclasses, filecmp, json, os, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

L, K, B, S, STEPS = 4, 2, 8, 32, 4


def configs(algorithm):
    from repro_torch.configs.base import MAvgConfig, get_config

    cfg = get_config("qwen3-1.7b").reduced()
    mcfg = MAvgConfig(algorithm=algorithm, num_learners=L, k_steps=K,
                      learner_lr=0.5, momentum=0.6,
                      local_momentum=0.5 if algorithm == "mavg_mlocal"
                      else 0.0)
    return cfg, mcfg


def trainer(mesh=None, ckpt=None):
    """4 meta steps of mavg_mlocal (a checkpoint after step 2 and 4)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api

    cfg, mcfg = configs("mavg_mlocal")
    tcfg = TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=B,
                       seq_len=S, meta_steps=STEPS, log_every=1,
                       checkpoint_dir=ckpt, checkpoint_every=2 if ckpt
                       else 0)
    return Trainer(tcfg, lambda p, b: api.loss_fn(p, cfg, b),
                   init_params_fn=lambda g: api.init_params(g, cfg, "cpu"),
                   batch_fn=lm_batch_fn(cfg, L, K, B, S, device="cpu"),
                   device="cpu", mesh=mesh)


def fsdp_steps(tmp, mesh=None):
    """3 placed mavg meta steps with each learner's batch split over
    'model' (tp_mode 'fsdp'), or the unplaced steps in one process: the
    losses, and the meta params saved in ``tmp``."""
    from repro_torch.core.meta import init_state, meta_step
    from repro_torch.data import lm_batch_fn
    from repro_torch.launch import specs as Sp
    from repro_torch.models import api
    from repro_torch.sharding import Spec
    from repro_torch.sharding.placed import Placement, placed_meta_step
    from repro_torch.utils.rng import seeded_generator

    cfg, mcfg = configs("mavg")
    mcfg = dataclasses.replace(mcfg, num_learners=2)
    loss = lambda p, b: api.loss_fn(p, cfg, b)
    state = init_state(api.init_params(seeded_generator("cpu", 7, 0), cfg,
                                       "cpu"), mcfg)
    bf = lm_batch_fn(cfg, 2, K, B, S, device="cpu")
    if mesh is not None:
        state = Sp.place_tree(state, Sp.state_shardings(
            cfg, mcfg, mesh, tp_mode="fsdp"), mesh)
        placement = Placement(mesh, ("data",), "model")
    losses = []
    for i in range(3):
        b = bf(seeded_generator("cpu", 7, 1 + i), i)
        if mesh is None:
            state, m = meta_step(state, b, loss_fn=loss, cfg=mcfg)
        else:
            b = {k: Sp.place(v, Spec("data", None, "model"), mesh)
                 for k, v in b.items()}
            state, m = placed_meta_step(state, b, loss_fn=loss, cfg=mcfg,
                                        placement=placement)
        losses.append(float(m["loss"]))
    gp = state.global_params
    gp = gp.full_tensor() if mesh is not None else gp
    torch.save(gp, os.path.join(tmp, "gp_mesh.pt" if mesh is not None
                                else "gp_single.pt"))
    return losses


def rank_main(rank, port, tmp, queue):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import load_state, save_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ckpt = os.path.join(tmp, "mesh")
        tr = trainer(mesh, ckpt)
        hist = tr.run(log=None)
        out = {"losses": [h["loss"] for h in hist],
               "mom": str(tr.state.local_momentum.placements)}
        # the placed state gathered, saved by one process's path
        plain = dataclasses.replace(tr.state, **{
            f: getattr(tr.state, f).full_tensor()
            for f in ("global_params", "momentum", "learners",
                      "local_momentum")})
        path = os.path.join(ckpt, "step_00000004.npz")
        if rank == 0:
            one = save_state(os.path.join(tmp, "one"), plain, 4)
            out["same_npz"] = filecmp.cmp(path, one, shallow=False)
            out["same_sidecar"] = filecmp.cmp(path + ".crc32.json",
                                              one + ".crc32.json",
                                              shallow=False)
            out["files"] = sorted(os.listdir(ckpt))
        dist.barrier()
        # the round trip: each rank's pieces written back in place
        before = {f: getattr(tr.state, f).to_local().clone()
                  for f in ("global_params", "momentum", "learners",
                            "local_momentum")}
        for f in before:
            getattr(tr.state, f).to_local().zero_()
        tr.restore(path)
        same = all(torch.equal(getattr(tr.state, f).to_local(), before[f])
                   for f in before)
        flags = [None] * 4
        dist.all_gather_object(flags, same)
        out["round_trip"] = all(flags) and tr.state.step == 4
        out["fsdp"] = fsdp_steps(tmp, mesh)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    tmp = sys.argv[2]
    if sys.argv[1] == "single":
        torch.set_num_threads(1)
        hist = trainer().run(log=None)
        print(json.dumps({"losses": [h["loss"] for h in hist],
                          "fsdp": fsdp_steps(tmp)}))
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        mp.start_processes(rank_main, args=(port, tmp, queue), nprocs=4,
                           start_method="spawn")
        print(json.dumps(queue.get()))
'''


@pytest.fixture(scope="module")
def placed_runs(tmp_path_factory):
    """One 4-rank gloo run on a (2, 2) mesh and one single process of the
    same steps (``PLACED_SCRIPT``)."""
    tmp = tmp_path_factory.mktemp("placed")
    script = tmp / "placed_run.py"
    script.write_text(PLACED_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def run(mode):
        out = subprocess.run([sys.executable, str(script), mode, str(tmp)],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    mesh, single = run("mesh"), run("single")
    gp = {m: torch.load(tmp / f"gp_{m}.pt") for m in ("mesh", "single")}
    return mesh, single, gp


def test_mavg_mlocal_on_a_gloo_mesh_of_4_ranks_matches_one_process(
        placed_runs):
    """``mavg_mlocal`` placed: the local-momentum plane is split as the
    learners' are (learners over 'data', rows over 'model'), gathered and
    taken back with them; 4 meta steps within JAX's 5e-2 of one
    process."""
    mesh, single, _ = placed_runs
    assert mesh["mom"] == "(Shard(dim=0), Shard(dim=1))"
    diffs = [abs(a - b) for a, b in zip(mesh["losses"], single["losses"])]
    print(f"mavg_mlocal losses on the mesh {mesh['losses']}, in one "
          f"process {single['losses']}, max |diff| {max(diffs):.3e}")
    assert len(diffs) == 4 and max(diffs) < 5e-2


def test_a_mesh_checkpoint_is_one_process_save_and_round_trips(placed_runs):
    """The Trainer on the mesh saves after steps 2 and 4 (rank 0 writes):
    the step-4 ``.npz`` and its sidecar are byte for byte what one process
    writes for the gathered state, and restoring it writes every rank's
    pieces back in place."""
    mesh, _, _ = placed_runs
    assert mesh["files"] == ["manifest.json", "step_00000002.npz",
                             "step_00000002.npz.crc32.json",
                             "step_00000004.npz",
                             "step_00000004.npz.crc32.json"]
    assert mesh["same_npz"] and mesh["same_sidecar"]
    assert mesh["round_trip"]


def test_fsdp_placed_step_on_a_gloo_mesh_matches_one_process(placed_runs):
    """tp_mode 'fsdp': each learner's batch of 8 split over 'model' (4 a
    rank), the gradient plane and loss all-reduced over 'model' each local
    step; 3 meta steps within 5e-2 of one process's losses, and the meta
    params within a relative norm of 5e-3 (measured 9.2e-4: the two
    halves' mean rounds apart from the whole batch's in the last bits,
    and lr 0.5 over 3 meta steps amplifies it)."""
    mesh, single, gp = placed_runs
    ml, sl = mesh["fsdp"], single["fsdp"]
    diffs = [abs(a - b) for a, b in zip(ml, sl)]
    print(f"fsdp losses on the mesh {ml}, in one process {sl}, max |diff| "
          f"{max(diffs):.3e}")
    assert len(diffs) == 3 and max(diffs) < 5e-2
    rel = float((gp["mesh"] - gp["single"]).norm() / gp["single"].norm())
    print(f"meta params: relative norm of the difference {rel:.3e}")
    assert rel < 5e-3
