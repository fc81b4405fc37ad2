"""Config system: model architecture + input shapes + run settings.

This is repro_torch's own copy of the JAX package's ``configs/base.py``:
the dataclasses, their fields and defaults are identical, so
``dataclasses.asdict`` agrees across the two packages (pinned in
tests/test_torch_isolation.py). The port imports nothing of ``repro``.

Every assigned architecture has a module ``repro_torch/configs/<id>.py`` exposing
``CONFIG`` (the exact full-scale config from the assignment table, with the
source citation) and smoke tests use ``CONFIG.reduced()``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0  # routed expert hidden size
    moe_aux_coef: float = 0.01
    first_dense_layers: int = 0  # deepseek-moe: leading dense FFN layers
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    slstm_every: int = 0  # xlstm: every k-th block is an sLSTM block
    # --- attention variants ---
    sliding_window: int = 0  # 0 = full; >0 = sliding-window attention
    causal: bool = True  # False for encoder-only (hubert)
    # --- modality frontends (stubs per spec) ---
    input_mode: str = "tokens"  # tokens | embeddings | tokens+patches
    num_patches: int = 256  # VLM stub patch count per image
    meta_tokens: int = 0  # hymba learnable prefix tokens
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0, (
            f"{self.name}: num_heads={self.num_heads} not a multiple of "
            f"num_kv_heads={self.num_kv_heads}"
        )

    # ------------------------------------------------------------------
    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """Can this config serve 500k-token contexts?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims.

        Per spec: 2 layers, d_model <= 512, <= 4 experts.
        """
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, n_heads * self.num_kv_heads // self.num_heads)
        updates = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_patches=min(self.num_patches, 16),
            meta_tokens=min(self.meta_tokens, 8),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
        )
        if self.num_experts:
            updates.update(
                num_experts=4,
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_top_k=min(self.moe_top_k, 2),
                d_expert=min(self.d_expert, 128),
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.slstm_every:
            updates["slstm_every"] = 2
        return replace(self, **updates)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        if self.family == "ssm":  # xlstm: mLSTM/sLSTM blocks, no attn/ffn
            d_in = self.ssm_expand * d
            mlstm = 2 * d * d_in + 3 * d_in * d_in // 1 + d_in * d  # rough
            return self.num_layers * mlstm + 2 * self.vocab_size * d
        ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.num_experts:
            routed = self.num_experts * 3 * d * self.d_expert
            shared = self.num_shared_experts * 3 * d * self.d_expert
            router = d * self.num_experts
            n_moe = self.num_layers - self.first_dense_layers
            moe = n_moe * (routed + shared + router)
            ffn = self.first_dense_layers * ffn
            per_layer = attn
            total = self.num_layers * per_layer + moe + ffn
        else:
            total = self.num_layers * (attn + ffn)
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = self.num_layers * (2 * d * d_in + d_in * self.ssm_state * 2)
            total += ssm
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total + embed)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        n_moe = self.num_layers - self.first_dense_layers
        inactive = (
            n_moe * (self.num_experts - self.moe_top_k) * 3 * d * self.d_expert
        )
        return int(self.param_count() - inactive)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "llama3-405b",
    "kimi-k2-1t-a32b",
    "qwen3-1.7b",
    "qwen1.5-110b",
    "xlstm-350m",
    "deepseek-moe-16b",
    "hubert-xlarge",
    "qwen2-7b",
    "internvl2-76b",
    "hymba-1.5b",
]


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    )
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# algorithms whose meta step is a plain average — the ones the repro.comm
# reducer owns (eamsgd/downpour ship their own update structure through
# the async server topology instead)
AVERAGING_ALGOS = ("mavg", "kavg", "sync", "mavg_mlocal")

# every algorithm the stack implements — the single source the CLI
# `choices` are derived from (launch/train.py). eamsgd/downpour are
# aliases onto the async bounded-staleness server (repro.topology.
# async_server): core/meta.py itself has no per-algorithm branches.
ALGORITHMS = AVERAGING_ALGOS + ("eamsgd", "downpour")

COMM_SCHEMES = ("dense", "int8", "fp8", "topk", "int8_topk")

# meta-level mixing topologies (the repro.topology subsystem)
TOPOLOGIES = ("flat", "hierarchical", "gossip", "async")

# one_peer_exponential is *time-varying*: step t uses only the +/-2^(t mod
# ceil(log2 L)) offsets (a perfect XOR matching when L is a power of two),
# matching the static exponential graph's consensus rate at degree <= 2
# (Takezawa et al. 2022)
GOSSIP_GRAPHS = ("ring", "exponential", "complete", "one_peer_exponential")


@dataclass(frozen=True)
class CommConfig:
    """Meta-communication compression knobs (the ``repro.comm`` subsystem).

    The meta average is the paper's one communication event per K local
    steps; these knobs select how each learner's displacement w_j - w~ is
    compressed on the wire (DESIGN.md §5).

    scheme          dense | int8 | fp8 | topk | int8_topk
    k_frac          kept fraction for the top-k schemes
    error_feedback  carry the compression residual e_j in MetaState so the
                    block-momentum update stays unbiased (EF-SGD)
    chunk_rows      rows of the (rows, 128) wire layout sharing one f32
                    quantization scale (chunk = chunk_rows * 128 values)
    use_pallas      route quant/dequant through the Pallas kernels
                    (interpret mode off-TPU) instead of the jnp reference
    seed            stochastic-rounding PRNG stream
    """

    scheme: str = "dense"
    k_frac: float = 0.1
    error_feedback: bool = True
    chunk_rows: int = 64
    use_pallas: bool = False
    seed: int = 0

    def __post_init__(self):
        assert self.scheme in COMM_SCHEMES, (
            f"unknown comm scheme {self.scheme!r}; choose from {COMM_SCHEMES}"
        )


@dataclass(frozen=True)
class ElasticConfig:
    """Deterministic learner dropout/join schedule (elastic execution).

    Real elastic clusters race wall clocks; under SPMD the same quantity
    — which learners participate in a given meta step — is simulated with
    a deterministic, checkpointable schedule instead (the downpour move,
    DESIGN.md §4/§8). The (period, L) 0/1 membership mask rides in
    ``MetaState.topo["membership"]`` and indexes by ``step % period``.

    period      schedule length T in meta steps (cycles)
    drop_frac   target fraction of learners absent at each scheduled step
                (0.0 = everyone always present — must reproduce the static
                topology bit-for-bit, pinned in tests/test_elastic.py)
    seed        PRNG stream the schedule is drawn from; every group keeps
                at least one present learner regardless
    schedule    explicit (period, L) 0/1 rows overriding the drawn
                schedule — how repro.chaos maps crash windows (and the
                supervisor maps quarantine) onto membership. When set,
                ``period`` must equal ``len(schedule)`` and every row
                must keep at least one learner present; drop_frac/seed
                are ignored.
    """

    period: int = 8
    drop_frac: float = 0.25
    seed: int = 0
    schedule: Optional[tuple] = None

    def __post_init__(self):
        assert self.period >= 1, self.period
        assert 0.0 <= self.drop_frac < 1.0, self.drop_frac
        if self.schedule is not None:
            rows = tuple(
                tuple(float(v) for v in row) for row in self.schedule
            )
            object.__setattr__(self, "schedule", rows)
            assert len(rows) == self.period, (
                f"explicit membership schedule has {len(rows)} rows for "
                f"period={self.period}"
            )
            L = len(rows[0])
            for t, row in enumerate(rows):
                assert len(row) == L, (t, len(row), L)
                assert all(v in (0.0, 1.0) for v in row), (t, row)
                assert sum(row) >= 1.0, (
                    f"membership schedule row {t} has no present learner"
                )


ASYNC_UPDATES = ("mavg", "elastic")

# robust aggregation estimators over the learner stack (repro.robust,
# DESIGN.md §14) — the single source the CLI choices derive from.
# 'mean' keeps the plain average (clipping/scoring may still be on).
ROBUST_ESTIMATORS = ("mean", "trimmed", "median")


@dataclass(frozen=True)
class RobustConfig:
    """Byzantine-tolerant meta aggregation (``repro.robust``, DESIGN.md §14).

    The paper's block-momentum update trusts the plain mean over learner
    displacements; one learner shipping finite-but-corrupt payloads
    poisons the global momentum for everyone. These knobs bound each
    learner's influence on the consensus instead of trusting it.
    ``MAvgConfig.robust=None`` (the default) leaves every code path
    untouched — bitwise-identical to a build without the subsystem.

    estimator        mean | trimmed | median — the aggregation rule that
                     replaces the learner-stack mean inside mean-based
                     reducers (flat all-reduce, hierarchical inner+outer).
                     'trimmed' drops the ``trim`` largest and smallest
                     values per coordinate; 'median' is the maximal trim.
                     Gossip/async have weighted partial means instead of
                     an L-way mean, so there the influence bound is the
                     norm clip (below) — the estimator is ignored.
    trim             coordinates trimmed per side (estimator='trimmed');
                     trim=0 is bitwise the plain mean (pinned in tests)
    clip_mult        per-learner displacement norm clip: each learner's
                     displacement is scaled down to at most
                     ``clip_mult x median(trailing clip_window per-step
                     median norms)``. 0.0 = clipping off. Clipped-away
                     mass is REJECTED — it never enters the error-
                     feedback residual (not deferred to later rounds).
    clip_window      trailing-median ring length (meta steps); no
                     clipping until the ring has filled once (warmup)
    score            compute Krum-style per-learner anomaly scores each
                     mix (nearest-neighbor distance sums from the
                     learner-stack Gram matrix) and stream them through
                     repro.obs as ``robust`` records (schema v4)
    score_neighbors  neighbors summed per score; 0 = auto (L - 2)
    quarantine_after M consecutive anomalous flush windows before the
                     Trainer quarantines a learner inline through the
                     elastic membership mask — no HealthHalt round-trip,
                     no rollback. 0 = inline quarantine off. Requires a
                     membership-capable topology (hierarchical/gossip/
                     async).
    score_ratio      a learner is anomalous in a window when its mean
                     score exceeds ``score_ratio x`` the median of its
                     peers' scores
    """

    estimator: str = "trimmed"
    trim: int = 1
    clip_mult: float = 0.0
    clip_window: int = 8
    score: bool = True
    score_neighbors: int = 0
    quarantine_after: int = 0
    score_ratio: float = 4.0

    def __post_init__(self):
        assert self.estimator in ROBUST_ESTIMATORS, (
            f"unknown robust estimator {self.estimator!r}; choose from "
            f"{ROBUST_ESTIMATORS}"
        )
        assert self.trim >= 0, self.trim
        assert self.clip_mult >= 0.0, self.clip_mult
        assert self.clip_window >= 1, self.clip_window
        assert self.score_neighbors >= 0, self.score_neighbors
        assert self.quarantine_after >= 0, self.quarantine_after
        assert self.score_ratio > 1.0, self.score_ratio


@dataclass(frozen=True)
class AsyncConfig:
    """The async bounded-staleness meta server (``repro.topology.
    async_server``, DESIGN.md §12).

    True asynchrony is unexpressible under SPMD (every program step is
    collective), so — exactly like elastic membership and the retired
    downpour queue — *when each learner reaches its K* becomes a
    deterministic, checkpointable schedule: learner j needs
    ``step_time[j]`` meta ticks per K-step block, pushes its displacement
    when its logical clock fills, and pulls the current w~ without
    waiting for anyone. Staleness (center updates between a learner's
    pull and its push) is bounded by construction:
    ``max(step_time) - 1 <= staleness``.

    staleness      tau: the staleness bound. 0 forces a uniform profile —
                   the synchronous degenerate case, bitwise-identical to
                   FlatAllReduce (pinned in tests/test_async.py)
    step_time      per-learner ticks per K-step block (length L, each
                   >= 1); () derives a profile from ``skew``/``seed``
    skew           when step_time is empty: deterministic profile drawn
                   over {1..skew} (seeded permutation of an even spread)
    seed           PRNG stream of the derived profile
    update         'mavg' — applied displacements are weighted by the
                   staleness-decayed block momentum (decay^tau); or
                   'elastic' — Zhang's EASGD elastic force toward the
                   current center, same decay weighting
    decay          per-round staleness decay of an applied displacement
                   (weight decay^tau); None -> the effective block
                   momentum mu (the mu^tau rule of Yu et al.)
    elastic_alpha  elastic-force coupling; None -> MAvgConfig.elastic_alpha
    """

    staleness: int = 0
    step_time: tuple = ()
    skew: int = 1
    seed: int = 0
    update: str = "mavg"
    decay: Optional[float] = None
    elastic_alpha: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(
            self, "step_time", tuple(int(m) for m in self.step_time)
        )
        assert self.staleness >= 0, self.staleness
        assert self.skew >= 1, self.skew
        assert self.update in ASYNC_UPDATES, (
            f"unknown async update {self.update!r}; choose from "
            f"{ASYNC_UPDATES}"
        )
        assert all(m >= 1 for m in self.step_time), self.step_time
        slowest = max(self.step_time) if self.step_time else self.skew
        if slowest - 1 > self.staleness:
            raise ValueError(
                f"step-time profile (slowest learner: {slowest} ticks per "
                f"K-step block) can push displacements up to {slowest - 1} "
                f"center updates stale, beyond the staleness bound "
                f"tau={self.staleness} — raise staleness or flatten the "
                f"profile"
            )
        if self.decay is not None:
            assert 0.0 <= self.decay <= 1.0, self.decay


@dataclass(frozen=True)
class TopologyConfig:
    """Who averages with whom, how often (the ``repro.topology`` subsystem).

    The paper's flat model — every learner averages with every other
    learner each meta step — is one point in a family (DESIGN.md §7):

    kind             flat | hierarchical | gossip
    groups           G: learners partitioned into G groups (hierarchical)
    outer_every      H: cross-group average every H meta steps, so the
                     slow inter-node links are touched once per K·H local
                     steps while intra-node averaging stays at every K
    outer_momentum   mu_out: block momentum of the outer (cross-group)
                     level; the inner level uses MAvgConfig.momentum
    graph            gossip mixing graph: ring | exponential | complete
                     (all doubly stochastic, so the learner mean is
                     preserved exactly)
    momentum_tracking  gossip: also mix the per-learner momentum buffers
                     with the same matrix (Takezawa et al. 2022)
    inner_comm       Reducer for the intra-group / neighbor edge class
                     (None -> MAvgConfig.comm)
    outer_comm       Reducer for the cross-group edge class — where the
                     inter-node byte savings land (None -> MAvgConfig.comm)
    group_k          hierarchical: per-group local-step counts K_g (length
                     G, each 1..k_steps). Groups behind slow inter-node
                     links can run more local steps than fast intra-node
                     groups; the extra steps of low-K_g groups are masked
                     inside the static K-step scan so the SPMD program
                     never changes shape. None -> every group runs k_steps.
    elastic          deterministic learner dropout/join schedule
                     (ElasticConfig); absent learners run zero local steps
                     and are masked out of the mixing with the matrix
                     re-wired to stay doubly stochastic. Under the async
                     server an absent learner simply cannot push — drop
                     and lag are one staleness axis. None -> off.
    server           async bounded-staleness server knobs (AsyncConfig);
                     only for kind='async'. None -> AsyncConfig() (the
                     synchronous degenerate case).
    """

    kind: str = "flat"
    groups: int = 1
    outer_every: int = 1
    outer_momentum: float = 0.0
    graph: str = "ring"
    momentum_tracking: bool = False
    inner_comm: Optional[CommConfig] = None
    outer_comm: Optional[CommConfig] = None
    group_k: Optional[tuple] = None
    elastic: Optional[ElasticConfig] = None
    server: Optional[AsyncConfig] = None

    def __post_init__(self):
        assert self.kind in TOPOLOGIES, (
            f"unknown topology {self.kind!r}; choose from {TOPOLOGIES}"
        )
        assert self.graph in GOSSIP_GRAPHS, (
            f"unknown gossip graph {self.graph!r}; choose from {GOSSIP_GRAPHS}"
        )
        assert self.groups >= 1 and self.outer_every >= 1
        if self.group_k is not None:
            # normalize to a hashable tuple (configs are frozen/hashable)
            object.__setattr__(self, "group_k", tuple(int(k) for k in self.group_k))
            assert self.kind == "hierarchical", (
                f"group_k only applies to the hierarchical topology, "
                f"not {self.kind!r}"
            )
            assert len(self.group_k) == self.groups, (
                f"group_k has {len(self.group_k)} entries for "
                f"groups={self.groups}"
            )
            assert all(k >= 1 for k in self.group_k), self.group_k
        if self.elastic is not None:
            assert self.kind in ("hierarchical", "gossip", "async"), (
                f"elastic membership masks the hierarchical/gossip mixing "
                f"(or the async server's push schedule); topology "
                f"{self.kind!r} has no mixing rows to mask"
            )
        if self.server is not None:
            assert self.kind == "async", (
                f"AsyncConfig only applies to the async topology, "
                f"not {self.kind!r}"
            )


@dataclass(frozen=True)
class MAvgConfig:
    """Hyper-parameters of the paper's Algorithm 1 (+ baselines)."""

    algorithm: str = "mavg"  # mavg | kavg | sync | eamsgd | downpour | mavg_mlocal
    num_learners: int = 4  # P in the paper
    k_steps: int = 4  # K: local steps between averaging
    learner_lr: float = 0.1  # gamma_n
    meta_lr: float = 1.0  # eta_n scaling of the displacement d
    momentum: float = 0.7  # mu: block momentum
    local_momentum: float = 0.0  # learner-level momentum (mavg_mlocal)
    nesterov: bool = False  # beyond-paper: Nesterov block momentum
    # EAMSGD
    elastic_alpha: float = 0.05
    # Downpour (simulated bounded staleness)
    staleness: int = 1
    # numerics: meta state always f32 (Theorem 1 variance); learner copies
    # default f32 for CPU experiments, bf16 for TPU launch configs
    meta_dtype: str = "float32"
    compute_dtype: str = "float32"
    # Pallas kernels on TPU in the JAX package. Kept for config parity
    # only: repro_torch chooses by device (CUDA tensors launch the
    # hand-written kernels, CPU tensors take their plain versions), so
    # this field has no effect in the port.
    use_pallas: bool = False
    # packed flat meta-plane (repro.pack, DESIGN.md §9): the whole param
    # pytree rides as ONE lane-aligned (rows, 128) buffer, so every
    # meta-phase op is a constant number of whole-model kernel passes
    # instead of one per leaf. False = the legacy per-leaf path, kept as
    # the parity oracle and for resuming per-leaf checkpoints.
    packed: bool = True
    # donate the MetaState input buffers to the jitted meta step
    # (jax.jit(donate_argnums=...)): every state plane is updated in
    # place instead of functionally rebuilt, halving the meta phase's
    # peak state HBM (DESIGN.md §10). Numerics are identical (aliasing
    # only); False keeps the input state alive after a step, which the
    # interactive/debug paths (and any caller that re-reads the
    # pre-step state) need.
    donate: bool = True
    # in-step finite guard (repro.chaos / DESIGN.md §13): after the local
    # phase (and any injected payload corruption), learners whose planes
    # carry NaN/Inf are reset to the broadcast global params (zero
    # displacement — the poisoned block is skipped, momentum pure-decays
    # when every learner is bad) and counted in the nonfinite_learners
    # metric, so a non-finite value can never reach MetaState's global
    # params through the mix. Off (default) the code path is untouched;
    # on with a clean run the guard is bitwise-invisible (where on an
    # all-true mask) — both pinned in tests/test_chaos.py.
    finite_guard: bool = False
    # meta-communication compression (repro.comm); dense = exact average
    comm: CommConfig = field(default_factory=CommConfig)
    # meta-level mixing topology (repro.topology); flat = all-reduce
    topology: TopologyConfig = field(default_factory=TopologyConfig)
    # Byzantine-tolerant meta aggregation (repro.robust, DESIGN.md §14);
    # None = off — every existing code path is bitwise untouched
    robust: Optional[RobustConfig] = None

    def __post_init__(self):
        if self.comm.scheme != "dense" and self.algorithm not in AVERAGING_ALGOS:
            raise ValueError(
                f"comm scheme {self.comm.scheme!r} only applies to the "
                f"averaging algorithms {AVERAGING_ALGOS}; "
                f"{self.algorithm!r} communicates through its own update"
            )
        t = self.topology
        if t.kind not in ("flat", "async") and self.algorithm not in AVERAGING_ALGOS:
            raise ValueError(
                f"topology {t.kind!r} only applies to the averaging "
                f"algorithms {AVERAGING_ALGOS}; {self.algorithm!r} is an "
                f"alias onto the async server (topology 'async')"
            )
        if t.kind == "async":
            if self.comm.scheme != "dense":
                raise ValueError(
                    f"the async server ships dense displacement planes; "
                    f"comm scheme {self.comm.scheme!r} is not supported on "
                    f"the async path"
                )
            server = t.server if t.server is not None else AsyncConfig()
            if server.step_time and len(server.step_time) != self.num_learners:
                raise ValueError(
                    f"async step_time profile has {len(server.step_time)} "
                    f"entries for num_learners={self.num_learners}"
                )
        if t.kind == "hierarchical" and self.num_learners % t.groups:
            raise ValueError(
                f"num_learners={self.num_learners} not divisible into "
                f"groups={t.groups}"
            )
        if t.group_k is not None and max(t.group_k) > self.k_steps:
            raise ValueError(
                f"group_k={t.group_k} exceeds k_steps={self.k_steps} — the "
                f"heterogeneous schedule masks steps *within* the static "
                f"K-step scan, so every K_g must be <= k_steps"
            )
        if self.robust is not None:
            r = self.robust
            if r.estimator == "trimmed" and r.trim > 0:
                # the smallest L-way mean the trimmed estimator replaces:
                # within-group size for hierarchical, L for flat
                width = (
                    self.num_learners // t.groups
                    if t.kind == "hierarchical" else self.num_learners
                )
                if 2 * r.trim >= width:
                    raise ValueError(
                        f"robust trim={r.trim} removes 2*trim={2 * r.trim} "
                        f"of {width} values per coordinate — the trimmed "
                        f"mean needs 2*trim < the aggregation width"
                    )
            if r.quarantine_after > 0 and t.kind == "flat":
                raise ValueError(
                    "robust inline quarantine masks learners through the "
                    "elastic membership schedule; the flat topology has no "
                    "membership rows — use hierarchical/gossip/async, or "
                    "set quarantine_after=0"
                )


# sink kinds of the repro.obs subsystem (DESIGN.md §11) — the single
# source the CLI choices derive from
OBS_SINKS = ("none", "jsonl", "csv", "memory")


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs (the ``repro.obs`` subsystem, DESIGN.md §11).

    sink             none | jsonl | csv | memory — where flushed metric
                     records and the run manifest go. Metrics stay on
                     device between ``log_every`` boundaries regardless
                     (the MetricsBuffer ring); the sink only sees already-
                     flushed host floats, so enabling it adds no syncs.
    run_dir          directory of the run log (run.jsonl / run.csv) and
                     trace exports; required for the file sinks
    buffer_capacity  rows of the device metric ring (0 -> sized to
                     max(log_every, 1), the flush cadence)
    trace            phase spans (``obs/trace.py``) on the profiler's
                     epoch clock: the Trainer's data / dispatch (with
                     the allocator's retry, alloc and free deltas) /
                     host_flush / checkpoint_io / sink_append, each
                     collection (gc), and in the meta step local_phase,
                     meta_mix and each local step's forward / backward /
                     update, also as ``<span>.device`` CUDA-event time
                     on a card; Chrome-trace export to
                     ``run_dir/trace.json`` at the end of each run
    profiler         capture a torch.profiler trace of the run (CPU and,
                     on the card, its kernels) into ``run_dir/torch_trace``
    cost_analysis    the meta step's cost in the run manifest
                     (``roofline.cost.jit_cost`` on meta copies of the
                     state; JAX: roofline.hlo_cost.jit_cost)
    health           run-health watchdogs (obs.health): declarative rules
                     evaluated over each flushed metric window, emitting
                     structured ``alert`` records into the sink. Consumes
                     only already-flushed host floats — a healthy run is
                     bitwise unaffected (pinned in tests)
    health_halt      fatal rules (NaN loss, divergence) halt the run with
                     a resumable checkpoint + HealthHalt; False records
                     the alerts but never stops
    attribution      phase attribution (obs.profile): before step 0,
                     steady-state-time the meta step / local phase / meta
                     mix on a clone of the state and record the rows into
                     the sink; nothing in the loop
    """

    sink: str = "none"
    run_dir: Optional[str] = None
    buffer_capacity: int = 0
    trace: bool = False
    profiler: bool = False
    cost_analysis: bool = False
    health: bool = False
    health_halt: bool = True
    attribution: bool = False

    def __post_init__(self):
        assert self.sink in OBS_SINKS, (
            f"unknown obs sink {self.sink!r}; choose from {OBS_SINKS}"
        )
        assert self.buffer_capacity >= 0, self.buffer_capacity
        if self.sink in ("jsonl", "csv") and self.run_dir is None:
            raise ValueError(
                f"ObsConfig(sink={self.sink!r}) needs run_dir for the run log"
            )


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    mavg: MAvgConfig = field(default_factory=MAvgConfig)
    batch_per_learner: int = 8
    seq_len: int = 128
    meta_steps: int = 10
    seed: int = 0
    log_every: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    # retention: keep the last N sidecar-verified snapshots as the
    # rollback chain (checkpoint.prune_checkpoints); 0 keeps everything
    checkpoint_keep: int = 0
    # deterministic fault injection (repro.chaos): a ChaosConfig whose
    # FaultSchedule the Trainer compiles and threads through the batch
    # stream, the jitted step and the checkpoint writer; None = off
    # (typed loosely to keep configs free of a chaos import)
    chaos: Optional[object] = None
    # supervisor retry salt: folded into the data stream so a rolled-back
    # attempt redraws the poisoned block's batches (and FaultSchedule
    # drops non-sticky faults); 0 on every first attempt
    data_salt: int = 0
    # telemetry (repro.obs): sink/tracing knobs; the device metric ring is
    # always on (it IS the metrics path), the knobs decide where it lands
    obs: ObsConfig = field(default_factory=ObsConfig)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
