"""The port's Trainer on a mesh (``Trainer(mesh=, state_shardings=)``):
the counterpart of JAX's ``tests/test_system.py::test_meta_step_under_real_mesh``
(which does not run on this jax). The same 4 meta steps of the reduced
Qwen3 (L=4, K=2, lr 0.5, momentum 0.6, B=8, S=32 on the bigram stream)
run in one process and on a real gloo group of 4 CPU ranks, a (2, 2)
('data', 'model') DeviceMesh: 2 learners a rank, the packed planes'
rows split over 'model' (the local phase all-gathers them), the learner
mean completed over 'data'. The losses agree within JAX's 5e-2; they
differ only in the mean's summation order (measured: printed).

``MIX_SCRIPT`` runs the configurations placed since on a (2, 2) mesh (a
rank holds whole hierarchical groups) and a (4, 1) mesh (a group spans
two ranks) beside one process, the three started together, in f32
compute (in bf16 a one-ulp difference in the mean's summation order
moves the next step's bf16 roundings, and the planes part at 1e-3
within two steps): the telemetry of every rank against one process,
int8 + EF, the hierarchical topology, robust aggregation, the finite
guard (and the robust step at 1 and 4 threads), top-k, a Trainer with
chaos, the cost analysis and the attribution rows, per-leaf planes,
gossip, the async server, eamsgd, downpour, and a Trainer each with
gossip and with the async server.
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


# ---------------------------------------------------------------------------
# int8 + EF, the hierarchical topology, robust aggregation, the finite
# guard and a chaos Trainer on the mesh (sharding/placed.py)
# ---------------------------------------------------------------------------

MIX_SCRIPT = r'''import dataclasses, json, os, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

L, K, B, S = 4, 2, 2, 16


def configs():
    """name -> (MAvgConfig, meta steps, payload fault or None)."""
    from repro_torch.configs import base as Bc

    c8 = Bc.CommConfig(scheme="int8", chunk_rows=8)
    kw = dict(num_learners=L, k_steps=K, learner_lr=0.5, momentum=0.6)

    def hier(**t):
        return Bc.TopologyConfig(kind="hierarchical", groups=2,
                                 outer_every=2, **t)

    def gossip(**t):
        return Bc.TopologyConfig(kind="gossip", **t)

    elastic = Bc.ElasticConfig(period=4, drop_frac=0.25, seed=1)
    rob = Bc.RobustConfig(estimator="trimmed", trim=1, clip_mult=3.0,
                          clip_window=2)
    return {
        "dense": (Bc.MAvgConfig(**kw), 2, None),
        "int8": (Bc.MAvgConfig(comm=Bc.CommConfig(scheme="int8"), **kw), 4,
                 None),
        "int8_c8": (Bc.MAvgConfig(comm=c8, **kw), 4, None),
        "hier_static": (Bc.MAvgConfig(topology=hier(inner_comm=c8), **kw), 4,
                        None),
        "hier_elastic": (Bc.MAvgConfig(topology=hier(
            inner_comm=c8, outer_comm=c8, elastic=elastic), **kw), 4, None),
        "hier_elastic_dense": (Bc.MAvgConfig(topology=hier(elastic=elastic),
                                             **kw), 4, None),
        "hier_robust": (Bc.MAvgConfig(topology=hier(), robust=dataclasses.replace(
            rob, estimator="mean"), **kw), 3, "scale"),
        "robust": (Bc.MAvgConfig(robust=rob, **kw), 4, "scale"),
        "guard": (Bc.MAvgConfig(finite_guard=True, **kw), 3, "nan"),
        "topk": (Bc.MAvgConfig(comm=Bc.CommConfig(scheme="topk"), **kw), 2,
                 None),
        # the robust run again, one process and each rank on 4 threads
        "robust_t4": (Bc.MAvgConfig(robust=rob, **kw), 4, "scale"),
        "per_leaf": (Bc.MAvgConfig(packed=False, **kw), 3, None),
        "per_leaf_int8": (Bc.MAvgConfig(packed=False, comm=Bc.CommConfig(
            scheme="int8"), **kw), 3, None),
        "gossip_ring": (Bc.MAvgConfig(topology=gossip(
            momentum_tracking=True, inner_comm=c8), **kw), 3, None),
        "gossip_exp": (Bc.MAvgConfig(topology=gossip(
            graph="one_peer_exponential"), **kw), 3, None),
        "gossip_elastic": (Bc.MAvgConfig(topology=gossip(
            inner_comm=c8, elastic=elastic), **kw), 4, None),
        "async": (Bc.MAvgConfig(topology=Bc.TopologyConfig(
            kind="async", server=Bc.AsyncConfig(
                staleness=3, step_time=(1, 1, 2, 4)),
            elastic=elastic), **kw), 6, None),
        "async_robust": (Bc.MAvgConfig(topology=Bc.TopologyConfig(
            kind="async", server=Bc.AsyncConfig(
                staleness=3, step_time=(1, 1, 2, 4))),
            robust=dataclasses.replace(rob, estimator="mean"), **kw), 6,
            "scale"),
        "eamsgd": (Bc.MAvgConfig(algorithm="eamsgd", **kw), 3, None),
        "downpour": (Bc.MAvgConfig(algorithm="downpour", **kw), 6, None),
    }


# the configurations run at another thread count than 1
THREADS = {"robust_t4": 4}


def corruptor(kind):
    """Learner 3's payload scaled x12 from step 1 on, or learner 2's plane
    NaN at step 1 (global learner indices)."""
    if kind is None:
        return None
    if kind == "scale":
        from repro_torch.chaos import (ChaosConfig, FaultSchedule, FaultSpec,
                                       PayloadCorruptor)

        return PayloadCorruptor(FaultSchedule(ChaosConfig(
            seed=0, horizon=8, faults=(FaultSpec(
                "finite_scale", step=1, learner=3, duration=7,
                magnitude=12.0, sticky=True),)), L))

    def nan(learners, step, offset=0):
        j = 2 - offset
        if int(step) == 1 and 0 <= j < learners.shape[0]:
            learners[j].fill_(float("nan"))
        return learners

    return nan


def model():
    from repro_torch.configs.base import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    return cfg, (lambda p, b: api.loss_fn(p, cfg, b))


def planes(state, whole):
    """Every plane of the state (a per-leaf tree leaf by leaf), whole."""
    from repro_torch.utils.tree import tree_leaves, tree_paths

    fields = [(f, getattr(state, f)) for f in (
        "global_params", "momentum", "learners", "comm_residual")]
    fields += [("topo/" + k, v) for k, v in sorted((state.topo or {}).items())
               if k not in ("membership", "robust_count")]
    out = {}
    for f, tree in fields:
        if tree is None:
            continue
        for path, x in zip(tree_paths(tree), tree_leaves(tree)):
            if isinstance(x, torch.Tensor):
                out[f + ("/" + path if path else "")] = whole(x)
    return out


def run(name, mesh=None):
    """(per-step metrics, final planes, largest scale quantum)."""
    torch.set_num_threads(THREADS.get(name, 1))
    try:
        return _run(name, mesh)
    finally:
        torch.set_num_threads(1)


def _run(name, mesh):
    from repro_torch.core.meta import init_state, meta_step
    from repro_torch.data import lm_batch_fn
    from repro_torch.launch import specs as Sp
    from repro_torch.models import api
    from repro_torch.sharding import Spec
    from repro_torch.sharding.placed import Placement, placed_meta_step
    from repro_torch.topology import make_topology
    from repro_torch.utils.rng import seeded_generator

    cfg, loss = model()
    mcfg, steps, fault = configs()[name]
    chaos = corruptor(fault)
    state = init_state(api.init_params(seeded_generator("cpu", 7, 0), cfg,
                                       "cpu"), mcfg)
    bf = lm_batch_fn(cfg, L, K, B, S, device="cpu")
    topology = make_topology(mcfg)
    if mesh is not None:
        state = Sp.place_tree(state, Sp.state_shardings(cfg, mcfg, mesh),
                              mesh)
        placement = Placement(mesh, ("data",))
    hist, quantum = [], 0.0
    for i in range(steps):
        b = bf(seeded_generator("cpu", 7, 1 + i), i)
        if mesh is None and not mcfg.packed:
            state, m = meta_step(state, b, loss_fn=loss, cfg=mcfg,
                                 topology=topology, chaos=chaos)
        elif mesh is None:
            spread = []
            mix = topology.mix

            def spy(learners, gp, *a, **k):
                anchor = gp if learners.shape[1] == gp.shape[0] else gp
                spread.append(float((learners - anchor).abs().max()))
                return mix(learners, gp, *a, **k)

            topology.mix = spy
            state, m = meta_step(state, b, loss_fn=loss, cfg=mcfg,
                                 topology=topology, chaos=chaos)
            topology.mix = mix
            res = [state.comm_residual] + [
                v for k, v in (state.topo or {}).items()
                if k.endswith("residual") and v is not None]
            quantum = max(quantum, (max(spread) + max(
                [float(r.abs().max()) for r in res if r is not None] + [0.0]))
                / 127)
        else:
            b = {k: Sp.place(v, Spec("data"), mesh) for k, v in b.items()}
            state, m = placed_meta_step(state, b, loss_fn=loss, cfg=mcfg,
                                        placement=placement, chaos=chaos)
        hist.append({k: float(v) for k, v in m.items()})
    whole = ((lambda t: t) if mesh is None else
             (lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t))
    return hist, planes(state, whole), quantum


def trainer_run(mesh):
    """A Trainer with chaos (crash windows and a payload fault on an
    elastic hierarchical topology, robust clip and scores), the cost
    analysis and the attribution rows, on the mesh."""
    from repro_torch.chaos import ChaosConfig, FaultSpec
    from repro_torch.configs import base as Bc
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api

    cfg, loss = model()
    mcfg = Bc.MAvgConfig(
        num_learners=L, k_steps=K, learner_lr=0.5, momentum=0.6,
        topology=Bc.TopologyConfig(kind="hierarchical", groups=2,
                                   outer_every=2),
        robust=Bc.RobustConfig(estimator="mean", clip_mult=3.0,
                               clip_window=2))
    chaos = ChaosConfig(seed=0, horizon=4, faults=(
        FaultSpec("crash", step=1, learner=1, duration=2),
        FaultSpec("payload_scale", step=2, learner=3, magnitude=20.0)))
    tcfg = Bc.TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=B,
                          seq_len=S, meta_steps=4, log_every=1, chaos=chaos,
                          obs=Bc.ObsConfig(cost_analysis=True,
                                           attribution=True))
    tr = Trainer(tcfg, loss,
                 init_params_fn=lambda g: api.init_params(g, cfg, "cpu"),
                 batch_fn=lm_batch_fn(cfg, L, K, B, S, device="cpu"),
                 device="cpu", mesh=mesh)
    hist = tr.run(log=None)
    jc = tr.jit_cost
    return {"hist": [{k: v for k, v in h.items()
                      if k not in ("meta_steps_per_sec", "samples_per_sec",
                                   "elapsed_s")} for h in hist],
            "robust": [r.get("clipped_learners") for r in tr.robust_records],
            "jit_cost": None if jc is None else {
                "flops": jc.flops, "collective_bytes": jc.collective_bytes,
                "kernel_calls": jc.kernel_calls},
            "attribution": [r["op"] for r in tr.attribution]}


def trainer_records(kind, mesh=None):
    """A Trainer's records (the wall-clock rates left out) of 4 meta steps
    of gossip (ring, momentum tracking, int8 + EF) or 6 ticks of the async
    server (profile (1, 1, 2, 4), staleness 3), and its final planes."""
    from repro_torch.configs import base as Bc
    from repro_torch.core.trainer import Trainer
    from repro_torch.data import lm_batch_fn
    from repro_torch.models import api

    cfg, loss = model()
    topo = (Bc.TopologyConfig(kind="gossip", momentum_tracking=True,
                              inner_comm=Bc.CommConfig(scheme="int8",
                                                       chunk_rows=8))
            if kind == "gossip" else Bc.TopologyConfig(
                kind="async", server=Bc.AsyncConfig(
                    staleness=3, step_time=(1, 1, 2, 4))))
    mcfg = Bc.MAvgConfig(num_learners=L, k_steps=K, learner_lr=0.5,
                         momentum=0.6, topology=topo)
    steps = 4 if kind == "gossip" else 6
    tcfg = Bc.TrainConfig(model=cfg, mavg=mcfg, batch_per_learner=B,
                          seq_len=S, meta_steps=steps, log_every=1)
    tr = Trainer(tcfg, loss,
                 init_params_fn=lambda g: api.init_params(g, cfg, "cpu"),
                 batch_fn=lm_batch_fn(cfg, L, K, B, S, device="cpu"),
                 device="cpu", mesh=mesh)
    hist = tr.run(log=None)
    whole = ((lambda t: t) if mesh is None else
             (lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t))
    return ([{k: v for k, v in h.items()
              if k not in ("meta_steps_per_sec", "samples_per_sec",
                           "elapsed_s")} for h in hist],
            planes(tr.state, whole))


TRAINERS = ("gossip", "async")


def rank_main(rank, port, shape, tmp, names):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        out = {}
        for name in names:
            hist, pl, _ = run(name, mesh)
            every = [None] * 4
            dist.all_gather_object(every, hist)
            out[name] = every
            if rank == 0:
                torch.save(pl, os.path.join(tmp, f"{name}_mesh.pt"))
        tr = trainer_run(mesh)
        every = [None] * 4
        dist.all_gather_object(every, tr)
        out["trainer"] = every
        for kind in TRAINERS:
            hist, pl = trainer_records(kind, mesh)
            every = [None] * 4
            dist.all_gather_object(every, hist)
            out["trainer_" + kind] = every
            if rank == 0:
                torch.save(pl, os.path.join(tmp, f"trainer_{kind}_mesh.pt"))
        if rank == 0:
            with open(os.path.join(tmp, "mesh.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mode, tmp = sys.argv[1], sys.argv[2]
    names = list(configs())
    if mode == "single":
        torch.set_num_threads(1)
        out = {}
        for name in names:
            hist, pl, q = run(name)
            out[name] = {"hist": hist, "quantum": q}
            torch.save(pl, os.path.join(tmp, f"{name}_single.pt"))
        for kind in TRAINERS:
            hist, pl = trainer_records(kind)
            out["trainer_" + kind] = {"hist": hist}
            torch.save(pl, os.path.join(tmp, f"trainer_{kind}_single.pt"))
        with open(os.path.join(tmp, "single.json"), "w") as f:
            json.dump(out, f)
    else:
        shape = tuple(int(x) for x in mode.split("x"))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(rank_main, args=(port, shape, tmp, names),
                           nprocs=4, start_method="spawn")
'''

MIX_MESHES = ("2x2", "4x1")
MIX_CONFIGS = ("dense", "int8", "int8_c8", "hier_static", "hier_elastic",
               "hier_elastic_dense", "hier_robust", "robust", "guard", "topk",
               "per_leaf", "per_leaf_int8", "gossip_ring", "gossip_exp",
               "gossip_elastic", "async", "async_robust", "eamsgd",
               "downpour")
# per-leaf planes, gossip and the async server, and the planes of each
# that a rank's sum in another order than one process's rounds apart
# (rtol 1e-5 / atol 1e-6); every other plane is one process's bitwise
ROUNDED = {
    # the dense mean's f32 sum completed over the learner ranks moves the
    # mean, then every plane trained from it
    "per_leaf": None,
    # the one-process reducer on the gathered stack
    "per_leaf_int8": (),
    # w~ = the mean of the params, completed over the learner ranks (it
    # feeds no later step)
    "gossip_ring": ("global_params",),
    "gossip_exp": ("global_params",),
    "gossip_elastic": ("global_params",),
    # the displacement sum is exact in f64, in any order of the ranks (and
    # the clip's Gram matrix rounds to f32 once)
    "async": (),
    "async_robust": (),
    "eamsgd": (),
    "downpour": (),
}
# the metrics held on every rank to one process at the first meta step
# (every other one is too)
TELEMETRY = ("v_norm", "displacement_norm", "consensus_dist", "comm_bytes",
             "comm_compression")
# the compressed limit (PERF.md section 2): beyond rtol 1e-5 / atol 1e-6
# at most this share of a plane, each within FLIP_QUANTA scale quanta
FLIP_SHARE = 5e-3
FLIP_QUANTA = 2.0


@pytest.fixture(scope="module")
def mix_runs(tmp_path_factory):
    """``MIX_SCRIPT`` on a (2, 2) and a (4, 1) gloo mesh of 4 ranks and in
    one process, the three started together: {mode: (per-config results,
    directory of the saved planes)}."""
    root = tmp_path_factory.mktemp("mix")
    script = root / "mix_run.py"
    script.write_text(MIX_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {}
    for mode in ("single",) + MIX_MESHES:
        d = root / mode
        d.mkdir()
        procs[mode] = (d, subprocess.Popen(
            [sys.executable, str(script), mode, str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for mode, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        name = "single.json" if mode == "single" else "mesh.json"
        out[mode] = (json.loads((d / name).read_text()), d)
    return out


def _planes(runs, mode, name):
    tag = "single" if mode == "single" else "mesh"
    return torch.load(runs[mode][1] / f"{name}_{tag}.pt")


def _mix(runs, mesh, name):
    """(every rank's per-step metrics, one process's, its quantum)."""
    single = runs["single"][0][name]
    return runs[mesh][0][name], single["hist"], single["quantum"]


@pytest.mark.parametrize("name", MIX_CONFIGS)
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_placed_telemetry_is_one_process_on_every_rank(mix_runs, mesh, name):
    """Every metric the placed step returns is the same on all 4 ranks at
    every step, and at the first step within rtol 1e-5 of one process:
    norms and distances as the root of the sums of squares over the axes
    their operands are split over (the learner axes and 'model'), the wire
    bytes of the global shapes (not each rank's partial norms and
    bytes)."""
    ranks, single, _ = _mix(mix_runs, mesh, name)
    assert all(r == ranks[0] for r in ranks), name
    got, want = ranks[0][0], single[0]
    assert set(got) == set(want)
    assert set(TELEMETRY) <= set(got)
    for k, w in want.items():
        assert got[k] == pytest.approx(w, rel=1e-5, abs=1e-30), (k, got[k],
                                                                  w)


def _within_flip_rule(mesh_planes, one_planes, quantum):
    """Each plane within rtol 1e-5 / atol 1e-6 but for FLIP_SHARE of its
    values, each of those within FLIP_QUANTA quanta; returns the largest
    share."""
    worst = 0.0
    assert set(mesh_planes) == set(one_planes)
    for k, want in one_planes.items():
        got = mesh_planes[k]
        diff = (got.float() - want.float()).abs()
        off = diff > 1e-6 + 1e-5 * want.float().abs()
        share = float(off.float().mean())
        worst = max(worst, share)
        assert share <= FLIP_SHARE, (k, share)
        assert float(diff.max()) <= FLIP_QUANTA * quantum, (k, quantum)
    return worst


@pytest.mark.parametrize("name", ["int8", "int8_c8"])
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_int8_ef_on_a_mesh_matches_one_process(mix_runs, mesh, name):
    """int8 + error feedback placed: ``pack_update`` on each rank's pieces
    with its learners' uniforms of one process's dither, the f64 sum of
    C(delta) over its learners completed by one all-reduce (``chunk_rows``
    8, and 64 on (4, 1)), or, where a 64-row chunk would straddle the
    (2, 2) mesh's two row pieces (the reduced plane's 10,256 rows take
    16-row chunks, 5,128 a piece), the one-process reducer on the
    gathered stack: 4 meta steps within JAX's 5e-2 in the loss, and the
    meta planes and the residual within the compressed limit; in fact
    bitwise, as the f64 sums are exact in any order of the ranks."""
    ranks, single, quantum = _mix(mix_runs, mesh, name)
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(ranks[0], single)) < 5e-2
    got, want = _planes(mix_runs, mesh, name), _planes(mix_runs, "single",
                                                      name)
    share = _within_flip_rule(got, want, quantum)
    print(f"{name} on {mesh}: {share:.3%} of a plane beyond rtol 1e-5")
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", ["hier_static", "hier_elastic",
                                  "hier_elastic_dense", "hier_robust"])
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_hierarchical_on_a_mesh_matches_one_process(mix_runs, mesh, name):
    """The hierarchical topology placed (G=2 groups of S=2, outer every 2
    meta steps; static with int8 + EF inner, elastic with int8 inner and
    outer, elastic dense, robust): the dense-inner one on the rank's
    pieces (on (2, 2) a rank holds a whole group, on (4, 1) a group spans
    two ranks: partial sums, one all-reduce), the int8-inner and robust
    ones as the one-process mix on the gathered stack. 4 meta steps
    within 5e-2 in the loss, the same learners present, and every plane
    (the group stacks and residuals too) within the compressed limit."""
    ranks, single, quantum = _mix(mix_runs, mesh, name)
    assert max(abs(a["loss"] - b["loss"])
               for a, b in zip(ranks[0], single)) < 5e-2
    assert ([h.get("present_count") for h in ranks[0]]
            == [h.get("present_count") for h in single])
    assert [h["outer_fired"] for h in ranks[0]] == [0.0, 1.0, 0.0, 1.0][
        :len(single)]
    share = _within_flip_rule(_planes(mix_runs, mesh, name),
                              _planes(mix_runs, "single", name), quantum)
    print(f"{name} on {mesh}: {share:.3%} of a plane beyond rtol 1e-5")


@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_robust_on_a_mesh_clips_the_learners_of_one_process(mix_runs, mesh):
    """Robust aggregation placed (trimmed mean, trim 1; the norm clip at 3x
    the median of a 2-step ring; scores) while learner 3's payload is
    scaled x12 from step 1: the re-split stack's partial Gram matrices
    summed over every rank clip the same learners on the same steps as
    one process, and every plane is within rtol 1e-5 / atol 1e-6."""
    ranks, single, _ = _mix(mix_runs, mesh, "robust")
    clipped = [h["robust_clipped_learners"] for h in single]
    assert any(clipped)
    assert [h["robust_clipped_learners"] for h in ranks[0]] == clipped
    got, want = _planes(mix_runs, mesh, "robust"), _planes(
        mix_runs, "single", "robust")
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["robust", "robust_t4"])
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_robust_on_a_mesh_is_one_process_at_any_thread_count(mix_runs, mesh,
                                                             name):
    """The robust run of the test above with one process and each rank on
    1 thread (``robust``) and on 4 (``robust_t4``; the local phase's
    products block by thread count, so each is held to one process at its
    own): the Gram matrix, read through every ``robust_*`` metric (the
    scores and the clip budget are differences of its entries), is one
    process's bitwise at every step, and every plane is within rtol 1e-5 /
    atol 1e-6. Both routes form each window's partial Gram matrix in f64
    and round the whole sum to f32 once, so the BLAS blocking, the thread
    count and the ranks' row pieces leave the f32 matrix as it is."""
    ranks = mix_runs[mesh][0][name]
    single = mix_runs["single"][0][name]["hist"]
    keys = sorted(k for k in single[0] if k.startswith("robust_"))
    assert "robust_score_0" in keys and "robust_clip_budget" in keys
    for r in ranks:
        for k in keys:
            assert [h[k] for h in r] == [h[k] for h in single], k
    got, want = _planes(mix_runs, mesh, name), _planes(mix_runs, "single",
                                                      name)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_finite_guard_on_a_mesh_resets_the_learner_of_one_process(mix_runs,
                                                                  mesh):
    """The finite guard placed while learner 2's plane turns NaN at step 1:
    its flags are taken on each rank's whole learners and gathered, so
    every rank reads one NaN learner at step 1 (and the rank that holds
    it resets it), and the planes stay finite and within rtol 1e-5 /
    atol 1e-6 of one process."""
    ranks, single, _ = _mix(mix_runs, mesh, "guard")
    want = [h["nonfinite_learners"] for h in single]
    assert want == [0.0, 1.0, 0.0]
    for r in ranks:
        assert [h["nonfinite_learners"] for h in r] == want
    got, one = _planes(mix_runs, mesh, "guard"), _planes(mix_runs, "single",
                                                        "guard")
    for k in one:
        assert bool(torch.isfinite(got[k]).all()), k
        torch.testing.assert_close(got[k], one[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_topk_on_a_mesh_is_the_gathered_one_process_reducer(mix_runs, mesh):
    """A scheme whose selection spans a learner's whole plane (topk) runs
    the one-process reducer on the gathered stack: bitwise one process's
    planes and residual."""
    got, want = _planes(mix_runs, mesh, "topk"), _planes(mix_runs, "single",
                                                        "topk")
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_trainer_with_chaos_cost_and_attribution_on_a_mesh(mix_runs, mesh):
    """A Trainer on the mesh with chaos (learner 1 crashed for steps 1-2,
    so elastic membership, and learner 3's payload scaled x20 at step 2),
    the robust clip and scores, ``obs.cost_analysis`` and
    ``obs.attribution`` runs its 4 meta steps, and every rank logs the
    same records: the crash seen as 3 learners present, the clip firing
    once, the cost of the placed step with its collectives, and the three
    attribution rows."""
    ranks = mix_runs[mesh][0]["trainer"]
    assert all(r == ranks[0] for r in ranks)
    t = ranks[0]
    assert [h["present_count"] for h in t["hist"]] == [4.0, 3.0, 3.0, 4.0]
    assert sum(t["robust"]) == 1.0
    jc = t["jit_cost"]
    assert jc is not None and jc["flops"] > 0 and jc["collective_bytes"] > 0
    assert t["attribution"] == ["phase:step", "phase:local",
                                "phase:meta_mix"]


# ---------------------------------------------------------------------------
# per-leaf planes, gossip and the async server (eamsgd, downpour) on the
# mesh (sharding/placed.py)
# ---------------------------------------------------------------------------


def _held(got, want, rounding):
    """Each plane bitwise one process's, but those named in ``rounding``
    (every plane where it is None) within rtol 1e-5 / atol 1e-6."""
    assert set(got) == set(want)
    for k, w in want.items():
        if rounding is None or any(k.startswith(r) for r in rounding):
            torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got[k], w), k


def _same_records(got, want):
    """Per-step records with the same keys, each value within rtol 1e-5
    of one process's (the host counters, clocks and gaps exactly)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, x in w.items():
            assert g[k] == pytest.approx(x, rel=1e-5, abs=1e-30), (k, g[k], x)


@pytest.mark.parametrize("name", list(ROUNDED))
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_per_leaf_gossip_and_async_on_a_mesh_match_one_process(
        mix_runs, mesh, name):
    """Per-leaf planes (dense: the mean of each leaf's pieces completed by
    one all-reduce, block momentum on the pieces; int8 + EF: the
    one-process quantizer on the gathered stack), gossip (ring with
    momentum tracking and int8 + EF on the rank's pieces, the stepped
    one_peer_exponential, elastic masking; each rank mixes its own
    learners from the stack gathered over the learner axes through the
    ``neighbor_mix`` window) and the async server (mavg on the profile
    (1, 1, 2, 4) under elastic membership, the same profile with the
    robust clip and scores while learner 3's payload is scaled x12,
    eamsgd, downpour; the decayed displacement sum exact in f64 and
    completed by one all-reduce), held
    to one process over 3 or more meta steps (ticks): every rank logs the
    same records, each within rtol 1e-5 of one process's, and every plane
    (residual and topology buffers too) is one process's bitwise where
    the route is order-free, else within rtol 1e-5 / atol 1e-6
    (``ROUNDED``)."""
    ranks, single, _ = _mix(mix_runs, mesh, name)
    assert all(r == ranks[0] for r in ranks), name
    assert len(single) >= 3
    _same_records(ranks[0], single)
    for k in ("fired_count", "staleness_max", "present_count",
              "mixing_spectral_gap"):
        if k in single[0]:
            assert [h[k] for h in ranks[0]] == [h[k] for h in single], k
    got, want = _planes(mix_runs, mesh, name), _planes(mix_runs, "single",
                                                      name)
    _held(got, want, ROUNDED[name])
    if name.startswith("gossip"):
        assert "topo/params" in want and "topo/momentum" in want
    if name == "gossip_ring":
        assert want["topo/residual"].abs().max() > 0
    if name.startswith("async"):
        assert any(h["fired_count"] < 4.0 for h in single)
        assert max(h["staleness_max"] for h in single) > 0
    if name == "async_robust":
        assert any(h["robust_clipped_learners"] for h in single)


@pytest.mark.parametrize("kind", ["gossip", "async"])
@pytest.mark.parametrize("mesh", MIX_MESHES)
def test_trainer_with_gossip_or_async_on_a_mesh_matches_one_process(
        mix_runs, mesh, kind):
    """A Trainer on the mesh with gossip (ring, momentum tracking, int8 +
    EF; 4 meta steps) or the async server (profile (1, 1, 2, 4),
    staleness 3; 6 ticks): every rank logs one process's records (the
    samples counted in completed K-blocks, the staleness and fired
    counts, each value within rtol 1e-5), and its final planes are one
    process's (gossip's w~ within rtol 1e-5 / atol 1e-6, every other
    plane bitwise)."""
    ranks = mix_runs[mesh][0]["trainer_" + kind]
    single = mix_runs["single"][0]["trainer_" + kind]["hist"]
    assert all(r == ranks[0] for r in ranks)
    _same_records(ranks[0], single)
    assert [h["samples"] for h in ranks[0]] == [h["samples"] for h in single]
    if kind == "async":
        for k in ("staleness_max", "fired_count"):
            assert [h[k] for h in ranks[0]] == [h[k] for h in single]
    tag = f"trainer_{kind}"
    got, want = (torch.load(mix_runs[m][1] / f"{tag}_{t}.pt")
                 for m, t in ((mesh, "mesh"), ("single", "single")))
    _held(got, want, ("global_params",) if kind == "gossip" else ())
