"""Mesh/sharding planner: roofline cost model for dp × tp × sp layouts
(counterpart of lele_tpu/parallel/planner.py, as it is, with an H100
preset beside the TPU ones; `plan_mesh` builds the port's DeviceMesh).

Choosing the mesh is a decision the program cannot make for you:
shardings are declared, collectives follow. This module encodes
the standard roofline algebra (compute / HBM / ICI, each a potential
bottleneck) so a deployment can rank candidate meshes BEFORE compiling
anything, then validate the winner with the real dryrun
(`__graft_entry__.dryrun_multichip`) and a profile.

The cost model is deliberately first-order:

  compute_s   = FLOPs / (chips_used · peak_flops)        (MXU bound)
  stream_s    = per-chip weight+activation bytes / hbm_bw (HBM bound)
  collective_s= per-layer link traffic / ici_bw           (ICI / NVLink bound)
  step_s      ≈ max(compute_s, stream_s) + collective_s

Collective formulas (ring algorithms, one-way link bandwidth):
  all-reduce of B bytes over n chips   ≈ 2·B·(n−1)/n / ici_bw
  all-gather / reduce-scatter          ≈   B·(n−1)/n / ici_bw

Numbers are nameplate approximations for ranking, not predictions of
wall time — the point is ORDERING candidates and exposing which resource
binds. Chip presets carry their sources in comments.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product


@dataclass(frozen=True)
class ChipSpec:
    """Nameplate per-chip numbers (first-order; see module docstring)."""

    name: str
    peak_flops_bf16: float  # FLOP/s
    peak_ops_int8: float    # OP/s
    hbm_bytes: float
    hbm_bw: float           # B/s
    ici_bw: float           # B/s one-way, aggregate over links


# v5e: 197 TFLOP/s bf16, 394 TOP/s int8, 16 GB @ 819 GB/s; ICI 4×400 Gbps
# links ≈ 2e11 B/s aggregate one-way (public v5e datasheet figures).
V5E = ChipSpec("v5e", 197e12, 394e12, 16e9, 819e9, 2.0e11)
# v5p: 459 TFLOP/s bf16, 918 TOP/s int8, 95 GB @ 2765 GB/s; 6×800 Gbps.
V5P = ChipSpec("v5p", 459e12, 918e12, 95e9, 2765e9, 6.0e11)
# H100 SXM: 989 TFLOP/s bf16 and 1,979 TOP/s int8 (dense), 80 GB @ 3.35 TB/s;
# NVLink 900 GB/s in total, so 450 GB/s one way (NVIDIA H100 Tensor Core GPU
# datasheet figures; `ici_bw` is the NVLink rate here).
H100 = ChipSpec("h100", 989e12, 1979e12, 80e9, 3.35e12, 4.5e11)


@dataclass(frozen=True)
class EncoderSpec:
    """A SAN-M/transformer-encoder-shaped workload (the flagship shape)."""

    n_layers: int = 50
    d_model: int = 512
    ffn: int = 2048
    vocab: int = 25055
    seq: int = 97            # frames per utterance after LFR
    batch: int = 1
    weight_bytes: int = 1    # 1 = int8, 2 = bf16, 4 = f32
    act_bytes: int = 4

    @property
    def layer_weight_bytes(self) -> float:
        # qkv (d→3d) + out (d→d) + ffn in/out (d→ffn→d)
        n = self.d_model * 3 * self.d_model + self.d_model * self.d_model \
            + 2 * self.d_model * self.ffn
        return n * self.weight_bytes

    @property
    def total_weight_bytes(self) -> float:
        return (self.n_layers * self.layer_weight_bytes
                + self.d_model * self.vocab * self.weight_bytes)

    @property
    def layer_flops(self) -> float:
        # 2·m·k·n per matmul, per sequence position
        per_tok = 2 * (self.d_model * 3 * self.d_model
                       + self.d_model * self.d_model
                       + 2 * self.d_model * self.ffn)
        attn = 4 * self.seq * self.seq * self.d_model  # scores + context
        return self.batch * (self.seq * per_tok + attn)

    @property
    def total_flops(self) -> float:
        head = 2 * self.batch * self.seq * self.d_model * self.vocab
        return self.n_layers * self.layer_flops + head


@dataclass
class MeshPlan:
    dp: int
    tp: int
    sp: int
    step_s: float
    bound: str              # "compute" | "hbm" | "ici"
    compute_s: float
    stream_s: float
    collective_s: float
    per_chip_weight_bytes: float
    fits_hbm: bool
    notes: list = field(default_factory=list)

    @property
    def chips(self) -> int:
        return self.dp * self.tp * self.sp


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_encoder(
    model: EncoderSpec,
    n_chips: int,
    chip: ChipSpec = V5E,
    quantized: bool = True,
) -> list[MeshPlan]:
    """Rank every dp·tp·sp factorization of `n_chips` for an encoder
    forward step. Returns plans sorted fastest-first; each carries which
    resource binds so the deployment knows what another chip would buy.

    dp shards batch (no per-step collectives in inference), tp shards the
    matmul contraction (per-layer all-reduce of [B,T,d] activations), sp
    shards the sequence (all-gathers around attention — the Ulysses-style
    layout; cost modeled as one activation all-gather per layer)."""
    peak = chip.peak_ops_int8 if quantized else chip.peak_flops_bf16
    plans: list[MeshPlan] = []
    for dp, tp in product(_divisors(n_chips), repeat=2):
        if n_chips % (dp * tp):
            continue
        sp = n_chips // (dp * tp)
        if model.batch % dp:
            continue  # dp must divide batch
        if model.d_model % tp or model.ffn % tp:
            continue
        if model.seq % sp:
            continue
        notes = []
        # compute: dp/tp/sp all divide the matmul work
        compute_s = model.total_flops / (n_chips * peak)
        # HBM: tp shards the weights; dp/sp replicate them
        per_chip_w = model.total_weight_bytes / tp
        act = model.batch * model.seq * model.d_model * model.act_bytes
        stream_s = (per_chip_w + act / (dp * sp)) / chip.hbm_bw
        # ICI per layer: tp → all-reduce activations twice (attn out + ffn
        # out); sp → all-gather once around attention. Collectives move the
        # PER-REPLICA shard, not the full batch: dp shards the batch before
        # any tp/sp collective runs, and the tp all-reduce operates on the
        # sequence shard sp leaves on each chip.
        act_rep = act / dp
        coll_bytes = 0.0
        if tp > 1:
            coll_bytes += 2 * 2 * (act_rep / sp) * (tp - 1) / tp
        if sp > 1:
            coll_bytes += act_rep * (sp - 1) / sp
        collective_s = model.n_layers * coll_bytes / chip.ici_bw
        if tp > 1 and model.d_model // tp < 128:
            notes.append(
                f"tp={tp} leaves d/tp={model.d_model // tp} < 128 lanes — "
                "sub-tile matmuls; prefer smaller tp"
            )
        step = max(compute_s, stream_s) + collective_s
        bound = ("ici" if collective_s > max(compute_s, stream_s)
                 else "hbm" if stream_s >= compute_s else "compute")
        plans.append(MeshPlan(
            dp=dp, tp=tp, sp=sp, step_s=step, bound=bound,
            compute_s=compute_s, stream_s=stream_s,
            collective_s=collective_s,
            per_chip_weight_bytes=per_chip_w,
            fits_hbm=per_chip_w + act < chip.hbm_bytes * 0.9,
            notes=notes,
        ))
    plans.sort(key=lambda p: p.step_s)
    return plans


def recommend_plan(
    model: EncoderSpec,
    n_chips: int,
    chip: ChipSpec = V5E,
    quantized: bool = True,
) -> MeshPlan:
    """The planner's pick: fastest plan that fits HBM and has no
    sub-lane-tile warning. Feed it to `plan_mesh` to get the mesh and the
    input shardings."""
    plans = plan_encoder(model, n_chips, chip, quantized)
    for p in plans:
        if p.fits_hbm and not p.notes:
            return p
    # degrade in order: fitting-but-noted (slower tiling beats an OOM),
    # then fastest overall (nothing fits — caller sees fits_hbm=False)
    for p in plans:
        if p.fits_hbm:
            return p
    if not plans:
        raise ValueError(
            f"no dp·tp·sp factorization of {n_chips} divides "
            f"batch={model.batch}, d={model.d_model}, seq={model.seq}")
    return plans[0]


def recommend_serving_plan(
    model: EncoderSpec,
    n_chips: int,
    chip: ChipSpec = V5E,
    quantized: bool = True,
) -> MeshPlan:
    """The serving pick: fastest PURE-dp plan (tp = sp = 1) that fits HBM.

    Serving replication is preferred when the weights fit one chip: zero
    per-step collectives, and every request's math is bitwise identical to
    the single-device program (no all-reduce reordering) — the property the
    batcher's per-request parity gate relies on. Falls back to
    `recommend_plan` (tp/sp) only when a single chip can't hold the model.
    """
    plans = [p for p in plan_encoder(model, n_chips, chip, quantized)
             if p.tp == 1 and p.sp == 1 and p.fits_hbm]
    if plans:
        return plans[0]
    return recommend_plan(model, n_chips, chip, quantized)


def plan_mesh(plan: MeshPlan, devices: str | None = None):
    """MeshPlan → (DeviceMesh over ("data","seq","model"), compile kwargs).

    Every rank of a default process group of plan.chips ranks calls it
    (`parallel.mesh.init_distributed`); `devices` is the device type, as
    in `make_mesh`. The kwargs say how inputs shard: batch over "data"
    (axis 0), activations over "seq" (axis 1) when sp > 1; `param_rules`
    is left to the caller (graph-specific Megatron placement).
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = plan.chips
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(f"plan needs {n} devices, have {have} ranks")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(devices, torch.arange(n).reshape(plan.dp, plan.sp, plan.tp),
                      mesh_dim_names=("data", "seq", "model"))
    kwargs = {"mesh": mesh, "batch_axis": 0}
    if plan.sp > 1:
        kwargs["seq_axis"] = 1
    return mesh, kwargs


def main() -> None:  # python -m lele_tpu_torch.parallel.planner [n_chips]
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    for batch, label in ((1, "latency (batch 1)"), (64, "throughput (batch 64)")):
        # seq=96: the bucketed shape (runtime/bucketing.py pads to
        # composite sizes precisely so sp has factors to use)
        m = EncoderSpec(batch=batch, seq=96)
        print(f"\nflagship encoder, {label}, {n}× {V5E.name}:")
        print(format_plans(plan_encoder(m, n)))


def format_plans(plans: list[MeshPlan], top: int = 8) -> str:
    rows = ["  dp  tp  sp   step(µs)  bound     per-chip W(MB)  fits"]
    for p in plans[:top]:
        rows.append(
            f"  {p.dp:>2}  {p.tp:>2}  {p.sp:>2}   {p.step_s * 1e6:8.1f}"
            f"  {p.bound:<8}  {p.per_chip_weight_bytes / 1e6:13.1f}"
            f"  {'yes' if p.fits_hbm else 'NO'}"
            + (f"   ({'; '.join(p.notes)})" if p.notes else "")
        )
    return "\n".join(rows)


if __name__ == "__main__":
    main()
