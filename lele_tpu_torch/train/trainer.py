"""Fine-tuning: the CTC training step for the ASR family (counterpart of
lele_tpu/train/trainer.py).

One step is value-and-grad of `ctc_loss_fn`, then AdamW, then the update,
written into the params and moments in place (JAX's step donates both).
On params placed by `parallel.shard_params` (DTensors over a DeviceMesh)
the same body and the same forward run on each rank's shards, under the
rank's `parallel.spmd.Layout`, with the collectives that GSPMD inserts for
the JAX package written out there.

The trainable path is the unquantized model: it calls plain PyTorch only,
no kernel of the port (no kernel has a backward, as no JAX kernel has a
custom_vjp). `ctc_loss` is optax's algorithm (optax is not on the card
machine), so a label sequence that cannot fit its frames costs ~1e5, as in
JAX, where `F.ctc_loss` gives inf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..models.sensevoice import SenseVoiceConfig, sensevoice_encode
from ..params import tree_leaves, tree_map
from ..parallel.spmd import LOCAL, Layout, gather, layout_of, local_shard, reduce_

LOG_EPSILON = -1e5  # optax's stand-in for log(0)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """Per-sequence CTC loss [B], optax.ctc_loss's recursion in its order.

    logits [B, T, K] (log-softmaxed here, as optax does), paddings 1.0 at a
    padded frame or label; labels [B, N] right-padded. A padded frame
    carries the forward variables unchanged, so padding at the end is the
    same as a frame length, as in JAX. A label sequence that needs more
    frames than it has ends near -log_epsilon (1e5), never at inf."""
    logprobs = torch.log_softmax(logits, dim=-1)
    B, T, K = logprobs.shape
    N = labels.shape[1]
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    repeat = torch.nn.functional.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    classes = torch.arange(K, device=labels.device)
    one_hot = (labels[..., None] == classes).float()  # [B, N, K]
    phi_t = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1).unbind(0)  # T x [B, 1]
    emit_t = torch.einsum("btk,bnk->btn", logprobs, one_hot).transpose(0, 1).unbind(0)
    pad_t = logit_paddings.transpose(0, 1).reshape(T, B, 1).unbind(0)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((B, N + 1), log_epsilon, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, device=logits.device)
    eps_repeat = log_epsilon * repeat
    eps_other = log_epsilon * (1.0 - repeat)
    for lp_emit, lp_phi, pad in zip(emit_t, phi_t, pad_t):
        prev_phi = update_phi(phi, emit + eps_repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + eps_other)
        # optax blends pad·old + (1 - pad)·new; with pad 0 or 1 and finite
        # values that is a select, bit for bit
        emit = torch.where(pad > 0, emit, next_emit)
        phi = torch.where(pad > 0, phi, next_phi)
    last = update_phi(phi, emit)
    ends = (labellens[:, None] == torch.arange(N + 1, device=labels.device)).float()
    return -(last * ends).sum(dim=1)


def _as_batch(batch: dict, device) -> dict:
    """numpy or tensor batch → tensors on `device` (f32 masks, int64 labels)."""
    def put(k, v):
        t = torch.as_tensor(v, device=device)
        return t.long() if k == "labels" else t.float()
    return {k: put(k, v) for k, v in batch.items()}


def ctc_loss_fn(params, batch, cfg: SenseVoiceConfig, lay: Layout = LOCAL,
                denom: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of per-sequence CTC losses over the label count (at least 1):
    encode, drop the cfg.n_prefix query frames, log-softmax in f32, CTC with
    blank 0 over the feature and label masks. The masks pad at the end (as
    every caller's do), so they are the frame and label lengths.

    Under a sharded `lay`: this rank's rows and shards, over `denom`, the
    global label count; the logits are gathered over "seq" (the CTC
    recursion has no sharded form)."""
    t = batch["feats"].shape[1]
    logits = sensevoice_encode(params, batch["feats"], batch["feat_mask"], cfg, lay=lay)
    logits = gather(logits, lay.seq, dim=1, reduce=False,
                    sizes=lay.frames(t * lay.seq.size + cfg.n_prefix, cfg.n_prefix))
    feat_mask = gather(batch["feat_mask"], lay.seq, dim=1, reduce=False)
    logits = logits[:, cfg.n_prefix:, :]
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    loss = ctc_loss(logprobs, 1.0 - feat_mask, batch["labels"], 1.0 - batch["label_mask"])
    if denom is None:
        denom = torch.clamp(batch["label_mask"].sum(), min=1.0)
    return loss.sum() / denom


@dataclass
class AdamW:
    """optax.adamw with every default spelled out (torch.optim.AdamW's
    weight_decay default is 1e-2; optax's is 1e-4, on every leaf). The
    state mirrors optax's ScaleByAdamState: {"count": int32 0-d, "mu",
    "nu"} trees shaped like the params. `update` writes moments and params
    in place, in optax's order: moments, bias corrections in f32,
    mu_hat / (sqrt(nu_hat + eps_root) + eps), + weight_decay * param,
    times -lr, added to the param."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(self, grads: list, state: dict, params) -> None:
        p = [local_shard(t) for t in tree_leaves(params)]
        mu = [local_shard(t) for t in tree_leaves(state["mu"])]
        nu = [local_shard(t) for t in tree_leaves(state["nu"])]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count = local_shard(state["count"])
        count += 1
        n = count.float()
        one = torch.ones((), device=n.device)
        bc1 = one - torch.full_like(one, self.b1) ** n
        bc2 = one - torch.full_like(one, self.b2) ** n
        u = torch._foreach_div(mu, bc1)
        d = torch._foreach_div(nu, bc2)
        torch._foreach_add_(d, self.eps_root)
        torch._foreach_sqrt_(d)
        torch._foreach_add_(d, self.eps)
        torch._foreach_div_(u, d)
        torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_add_(p, u, alpha=-self.lr)


def value_and_grad(params, batch: dict, cfg: SenseVoiceConfig):
    """(loss, grads as a list in tree_leaves order). On DTensor params each
    rank runs its shards of the params and of the batch (`shard_batch`)
    under its Layout and gets the gradient of its own shards, summed over
    "data" and "seq"; the loss is the global one."""
    leaves = tree_leaves(params)
    if leaves and hasattr(leaves[0], "device_mesh"):
        if not hasattr(batch["feats"], "to_local"):
            batch = shard_batch(batch, leaves[0].device_mesh)
        lay = layout_of(params, batch["feats"])
        batch = {k: v.to_local() for k, v in batch.items()}
        batch["labels"] = batch["labels"].long()
        leaves = [t.to_local() for t in leaves]
    else:
        lay = LOCAL
        batch = _as_batch(batch, leaves[0].device)
    denom = torch.clamp(reduce_(batch["label_mask"].sum(), lay.data), min=1.0)
    with torch.enable_grad():
        live = [t.detach().requires_grad_() for t in leaves]
        it = iter(live)
        loss = ctc_loss_fn(tree_map(lambda _: next(it), params), batch, cfg, lay, denom)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    if lay.data.group is not None or lay.seq.group is not None:
        flat = reduce_(torch.cat([g.reshape(-1) for g in grads]), lay.data, lay.seq)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    return reduce_(loss.detach().clone(), lay.data), grads


def _step_body(params, opt_state, batch, cfg: SenseVoiceConfig, tx: AdamW):
    """The one training-step body (value_and_grad → tx.update, in place):
    ctc_train_step and make_train_step both run THIS, so a change (grad
    clipping, loss scaling) can never reach one and miss the other."""
    loss, grads = value_and_grad(params, batch, cfg)
    tx.update(grads, opt_state, params)
    return params, opt_state, loss


def ctc_train_step(state: TrainState, batch, cfg: SenseVoiceConfig, tx: AdamW):
    """TrainState convenience wrapper around the same body."""
    new_params, new_opt, loss = _step_body(state.params, state.opt_state, batch, cfg, tx)
    return TrainState(new_params, new_opt, state.step + 1), loss


def make_train_step(cfg: SenseVoiceConfig, lr: float = 1e-4):
    """Returns (tx, step); step(params, opt_state, batch) → (params,
    opt_state, loss) with params and moments updated in place.

    Sharded use: place params with `parallel.shard_params(params, mesh)`
    BEFORE `tx.init`, so the moments are DTensors with the params'
    placements, and the batch with `shard_batch(batch, mesh)`."""
    tx = AdamW(lr)

    def step(params, opt_state, batch):
        return _step_body(params, opt_state, batch, cfg, tx)

    return tx, step


def shard_batch(batch: dict, mesh) -> dict:
    """Batch over "data"; on a 3-D mesh, time-major tensors (feats,
    feat_mask) also shard their T axis over "seq" when it divides. Every
    rank passes the whole batch and keeps its own shard (DTensors)."""
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.mesh import axis_sizes, mesh_device
    from ..parallel.sharding import to_placements

    sizes = axis_sizes(mesh)
    dev = mesh_device(mesh)
    out = {}
    for name, arr in _as_batch(batch, dev).items():
        spec = ["data"] + [None] * (arr.ndim - 1)
        if ("seq" in sizes and name in ("feats", "feat_mask") and arr.ndim >= 2
                and arr.shape[1] % sizes["seq"] == 0):
            spec[1] = "seq"
        if arr.shape[0] % sizes["data"]:
            raise ValueError(f"batch {arr.shape[0]} does not divide over data={sizes['data']}")
        out[name] = distribute_tensor(arr, mesh, to_placements(mesh, tuple(spec)),
                                      src_data_rank=None)
    return out
