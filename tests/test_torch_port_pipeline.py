"""The port's GPipe pipeline (lele_tpu_torch/parallel/pipeline.py) against
the JAX package's (lele_tpu/parallel/pipeline.py).

JAX runs its pipeline on conftest's virtual CPU devices, one a stage; the
port runs it as gloo processes, one a stage, spawned once for every leg
(tests/torch_port_legs.pipeline_legs, 4 ranks). Replayed:
tests/test_sharding.py:326 (S 4, M 4, tanh stages, at its 1e-5) and :358
(S 2, M 1, and the ragged batch's ValueError), and dryrun_multichip's pp
leg (4 SAN-M blocks at d 32 through the port's `sanm_block`, at its 1e-4),
each against JAX's `pipeline_apply` on the same numpy inputs and weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import init_sensevoice as jinit
from lele_tpu.models.sensevoice import sanm_block as jsanm_block
from lele_tpu.parallel.pipeline import pipeline_apply as jpipeline
from lele_tpu.parallel.pipeline import stack_stage_params as jstack
from lele_tpu_torch.parallel import pipeline_apply, stack_stage_params

import torch_port_legs as legs

PP = dict(n_layers=4, d_model=32, ffn_dim=64, vocab_size=16, n_heads=2, dtype="float32")


def _jax_pipe(stage_fn, per_stage, x, S, M):
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))
    return np.asarray(jpipeline(stage_fn, jstack(per_stage), jnp.asarray(x), mesh,
                                n_microbatch=M))


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    """The legs' inputs, JAX's outputs on them, and every rank's results."""
    rng = np.random.default_rng(0)
    S, D, batch = 4, 16, 8
    seq = {"stages": [{"w": rng.standard_normal((D, D)).astype(np.float32) * 0.3,
                       "b": rng.standard_normal(D).astype(np.float32) * 0.1}
                      for _ in range(S)],
           "x": rng.standard_normal((batch, D)).astype(np.float32)}
    rng = np.random.default_rng(1)
    one = {"stages": [rng.standard_normal((8, 8)).astype(np.float32) * 0.2 for _ in range(2)],
           "x": rng.standard_normal((3, 8)).astype(np.float32)}
    layers = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1), JConfig(**PP))["layers"])
    pp = {"cfg": PP, "layers": layers,
          "x": np.random.default_rng(0).standard_normal((8, 12, 32)).astype(np.float32)}
    payload = {"seq": seq, "one": one, "pp": pp}
    ranks = legs.run_ranks(legs.pipeline_legs, 4, tmp_path_factory.mktemp("pipe"), payload)

    jseq = _jax_pipe(lambda p, mb: jnp.tanh(mb @ p["w"] + p["b"]),
                     [{k: jnp.asarray(v) for k, v in p.items()} for p in seq["stages"]],
                     seq["x"], 4, 4)
    jone = _jax_pipe(lambda p, mb: mb @ p["w"], [{"w": jnp.asarray(w)} for w in one["stages"]],
                     one["x"], 2, 1)
    mask = np.ones((1, 12), np.float32)

    def stage_fn(p, mb):
        return jsanm_block(p, mb, jnp.broadcast_to(jnp.asarray(mask), (mb.shape[0], 12)),
                           JConfig(**PP))

    jpp = _jax_pipe(stage_fn, layers, pp["x"], 4, 4)
    return payload, ranks, {"seq": jseq, "one": jone, "pp": jpp}


def test_pipeline_parallel_matches_sequential(pipe_run):
    """tests/test_sharding.py:326: 4 stages, 4 microbatches, against the
    plain sequential stack and JAX's pipeline at 1e-5; every rank returns
    the whole output."""
    payload, ranks, jax_out = pipe_run
    want = payload["seq"]["x"]
    for p in payload["seq"]["stages"]:
        want = np.tanh(want @ p["w"] + p["b"])
    for r in ranks:
        np.testing.assert_allclose(r["seq"], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["seq"], jax_out["seq"], atol=1e-5, rtol=1e-5)
        assert r["stacked_shape"] == (4, 16, 16)


def test_pipeline_parallel_single_microbatch_and_ragged_guard(pipe_run):
    """tests/test_sharding.py:358: M = 1 is plain staged execution; a batch
    of 3 in 2 microbatches raises ValueError before any collective (the
    ranks go on to the next leg)."""
    payload, ranks, jax_out = pipe_run
    one = payload["one"]
    want = one["x"] @ one["stages"][0] @ one["stages"][1]
    for r in ranks[:2]:
        np.testing.assert_allclose(r["one"], want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["one"], jax_out["one"], atol=1e-5, rtol=1e-5)
        assert r["ragged"].startswith("ValueError") and "M=2" in r["ragged"]
    with pytest.raises(ValueError):  # raised before the mesh is read
        pipeline_apply(lambda p, mb: mb, {"w": torch.zeros(2, 1)}, torch.zeros(3, 8), None,
                       n_microbatch=2)


def test_dryrun_pp_leg_sanm_blocks_match_jax(pipe_run):
    """dryrun_multichip's pp leg: 4 SAN-M blocks (d 32, 2 heads) as 4
    stages, 8 x 12 frames in 4 microbatches, against JAX's pipeline and the
    blocks run in sequence, at the leg's 1e-4."""
    payload, ranks, jax_out = pipe_run
    pp = payload["pp"]
    want = jnp.asarray(pp["x"])
    m = jnp.ones((8, 12), jnp.float32)
    for lp in pp["layers"]:
        want = jsanm_block(lp, want, m, JConfig(**PP))
    for r in ranks:
        np.testing.assert_allclose(r["pp"], np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(r["pp"], jax_out["pp"], atol=1e-4)


def test_stack_stage_params_matches_jax():
    """A tree of per-stage leaves → one tree stacked on a new stage axis,
    as JAX's (dicts and lists keep their structure)."""
    rng = np.random.default_rng(3)
    per = [{"a": rng.standard_normal((2, 3)).astype(np.float32),
            "l": [rng.standard_normal(4).astype(np.float32)]} for _ in range(3)]
    got = stack_stage_params([{"a": torch.from_numpy(p["a"]), "l": [torch.from_numpy(p["l"][0])]}
                              for p in per])
    want = jstack(per)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["l"][0].numpy(), np.asarray(want["l"][0]))
    assert isinstance(got["l"], list)
