"""tests/test_planner.py's cases with the port's planner
(lele_tpu_torch/parallel/planner.py), held to the JAX package's plans
field for field, plus the H100 preset. The last case builds the winner's
mesh with the port's processes (8 gloo ranks, tests/torch_port_legs.py)
where JAX uses 8 virtual devices."""

import dataclasses

import numpy as np
import pytest

from lele_tpu.parallel import planner as jplanner
from lele_tpu_torch.parallel.planner import (
    H100,
    V5E,
    V5P,
    EncoderSpec,
    format_plans,
    main,
    plan_encoder,
    recommend_serving_plan,
)

import torch_port_legs as legs


def test_all_factorizations_enumerated_and_valid():
    m = EncoderSpec(batch=8, seq=96)
    plans = plan_encoder(m, 8)
    assert plans, "no valid plans for 8 chips"
    for p in plans:
        assert p.chips == 8
        assert m.batch % p.dp == 0
        assert m.d_model % p.tp == 0 and m.ffn % p.tp == 0
        assert m.seq % p.sp == 0
    # sorted fastest-first
    steps = [p.step_s for p in plans]
    assert steps == sorted(steps)


def test_weight_streaming_model_prefers_tp_over_dp_at_batch1():
    """The flagship regime: batch-1 int8 encoder is weight-stream-bound,
    so sharding the WEIGHTS (tp) divides the binding term while dp only
    replicates it — tp must rank above pure-dp."""
    m = EncoderSpec(batch=1, seq=96)  # batch 1 → dp>1 invalid anyway
    plans = plan_encoder(m, 4)
    best = plans[0]
    assert best.tp > 1
    pure_replication = [p for p in plans if p.tp == 1 and p.sp == 1]
    assert not pure_replication or (
        pure_replication[0].step_s >= best.step_s
    )


def test_dp_scales_compute_without_collectives():
    """Large-batch inference: dp has zero per-step collective cost in the
    model, so a dp-only plan's collective term is exactly 0."""
    m = EncoderSpec(batch=64, seq=96)
    plans = plan_encoder(m, 8)
    dp_only = next(p for p in plans if p.dp == 8)
    assert dp_only.collective_s == 0.0
    # and its per-chip weights are NOT reduced (replication)
    assert np.isclose(dp_only.per_chip_weight_bytes, m.total_weight_bytes)


def test_collectives_move_per_replica_shards():
    """tp/sp collective bytes scale with the PER-REPLICA activation
    (act/dp, and the tp all-reduce sees the sp sequence shard) — modeling
    the full batch overstated mixed layouts by dp× and mis-ranked them:
    at batch 8 / bf16 weights, dp4·tp2 (weights halved, modest all-reduce)
    beats pure dp8 replication."""
    m = EncoderSpec(batch=8, seq=96, weight_bytes=2)
    plans = plan_encoder(m, 8, quantized=False)
    by = {(p.dp, p.tp, p.sp): p for p in plans}
    assert by[(4, 2, 1)].step_s < by[(8, 1, 1)].step_s
    # dp shards the batch before the collective: doubling dp at fixed
    # tp/sp halves the all-reduce bytes (compare across chip counts —
    # dp·tp·sp must equal n_chips within one plan set)
    m2 = EncoderSpec(batch=8, seq=96)
    p8 = {(p.dp, p.tp, p.sp): p for p in plan_encoder(m2, 8)}
    p4 = {(p.dp, p.tp, p.sp): p for p in plan_encoder(m2, 4)}
    assert np.isclose(p8[(4, 2, 1)].collective_s,
                      p4[(2, 2, 1)].collective_s / 2)
    # and the sp shard shrinks what each tp all-reduce moves (sp=4 adds
    # its own all-gather, but 4·(act/4)·½ + act·¾ < 4·act·½)
    p2 = {(p.dp, p.tp, p.sp): p for p in plan_encoder(m2, 2)}
    assert p8[(1, 2, 4)].collective_s < p2[(1, 2, 1)].collective_s


def test_tp_shards_weights_and_pays_ici():
    m = EncoderSpec(batch=8, seq=96)
    plans = plan_encoder(m, 8)
    tp8 = next(p for p in plans if p.tp == 8)
    assert np.isclose(tp8.per_chip_weight_bytes, m.total_weight_bytes / 8)
    assert tp8.collective_s > 0
    # d/tp = 64 < 128 lanes → the sub-tile warning fires
    assert any("128 lanes" in n for n in tp8.notes)


def test_hbm_capacity_gate():
    big = EncoderSpec(n_layers=200, d_model=8192, ffn=32768, vocab=128000,
                      batch=1, weight_bytes=2)
    plans = plan_encoder(big, 4)
    # ~50 GB of bf16 weights: tp=1 cannot fit a 16 GB v5e
    tp1 = [p for p in plans if p.tp == 1]
    assert all(not p.fits_hbm for p in tp1)


def test_recommend_prefers_fitting_plan_over_fast_oom():
    """When every note-free plan is out of HBM but a NOTED plan fits,
    recommend_plan must return the fitting one — a slower tiling beats an
    OOM (tests/test_planner.py's case: a fallback that returned the
    fastest plan regardless of fits_hbm while a fitting plan existed)."""
    from lele_tpu_torch.parallel.planner import recommend_plan

    # ~68 GB f32 weights on 8 v5e chips: only tp=8 fits, and tp=8 on
    # d_model=512 leaves 64 < 128 lanes — the sub-lane-tile note
    big = EncoderSpec(n_layers=250, d_model=512, ffn=65536, vocab=32000,
                      batch=8, seq=96, weight_bytes=4)
    plans = plan_encoder(big, 8)
    assert not any(p.fits_hbm and not p.notes for p in plans)
    assert any(p.fits_hbm for p in plans)  # premise: a noted plan fits
    pick = recommend_plan(big, 8)
    assert pick.fits_hbm


def test_bound_labels_match_terms():
    m = EncoderSpec(batch=8, seq=96)
    for p in plan_encoder(m, 8):
        if p.bound == "ici":
            assert p.collective_s > max(p.compute_s, p.stream_s)
        elif p.bound == "hbm":
            assert p.stream_s >= p.compute_s
        else:
            assert p.compute_s > p.stream_s


def test_format_plans_renders():
    m = EncoderSpec(batch=8, seq=96)
    out = format_plans(plan_encoder(m, 8))
    assert "dp" in out and "bound" in out and len(out.splitlines()) > 2


def test_planner_winner_runs_on_the_process_mesh(tmp_path):
    """The ranked-best layout must be constructible with the port's mesh
    helpers (plan_mesh and make_mesh over 8 gloo ranks) and shard a matmul
    without error."""
    m = EncoderSpec(batch=8, seq=96)
    best = plan_encoder(m, 8)[0]
    ranks = legs.run_ranks(legs.planner_mesh, 8, tmp_path, best.dp, best.sp, best.tp,
                           m.batch, m.seq, m.d_model, m.ffn)
    want = {"data": best.dp, "seq": best.sp, "model": best.tp}
    for r in ranks:
        assert r["plan"] == (best.dp, best.sp, best.tp)
        assert r["mesh"] == want and r["mesh2"] == want
        assert r["kwargs"] == sorted(["mesh", "batch_axis"] + (["seq_axis"] if best.sp > 1
                                                                else []))
        assert r["y"] == (m.batch, m.seq, m.ffn) and r["err"] <= 1e-3
        assert r["y_local"] == (m.batch // best.dp, m.seq // best.sp, m.ffn // best.tp)


_CASES = [(EncoderSpec(batch=8, seq=96), 8, True), (EncoderSpec(batch=1, seq=96), 4, True),
          (EncoderSpec(batch=64, seq=96), 8, True),
          (EncoderSpec(batch=8, seq=96, weight_bytes=2), 8, False),
          (EncoderSpec(n_layers=250, d_model=512, ffn=65536, vocab=32000, batch=8, seq=96,
                       weight_bytes=4), 8, True)]


@pytest.mark.parametrize("chip", ["v5e", "v5p"])
def test_plans_equal_the_jax_planners(chip):
    """Every plan, field for field, as the JAX package's planner gives it."""
    port_chip = {"v5e": V5E, "v5p": V5P}[chip]
    jax_chip = {"v5e": jplanner.V5E, "v5p": jplanner.V5P}[chip]
    assert dataclasses.astuple(port_chip) == dataclasses.astuple(jax_chip)
    for spec, n, quantized in _CASES:
        jspec = jplanner.EncoderSpec(**dataclasses.asdict(spec))
        got = plan_encoder(spec, n, port_chip, quantized)
        want = jplanner.plan_encoder(jspec, n, jax_chip, quantized)
        assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
        assert format_plans(got) == jplanner.format_plans(want)


def test_h100_preset(capsys, monkeypatch):
    """NVIDIA's H100 SXM datasheet figures; on 8 cards the flagship's int8
    encoder fits one card, and at batch 64 the pick is pure dp, bound by the
    matmul rate as it is on v5e."""
    assert (H100.peak_flops_bf16, H100.peak_ops_int8) == (989e12, 1979e12)
    assert (H100.hbm_bytes, H100.hbm_bw, H100.ici_bw) == (80e9, 3.35e12, 450e9)
    m = EncoderSpec(batch=64, seq=96)
    plans = plan_encoder(m, 8, H100)
    assert all(p.fits_hbm for p in plans)
    pick = recommend_serving_plan(m, 8, H100)
    assert (pick.dp, pick.tp, pick.sp) == (8, 1, 1) and pick.bound == "compute"
    v5e = recommend_serving_plan(m, 8, V5E)
    assert pick.step_s < v5e.step_s
    out = format_plans(plans)
    assert "dp" in out and "bound" in out
    monkeypatch.setattr("sys.argv", ["planner", "8"])
    main()
    assert "flagship encoder" in capsys.readouterr().out
