"""Train step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation, on one device or over a process group.

The step is a function of (state, batch) as in the reference; it updates
the state's tensors in place and returns the same dict. The forward runs
with ``remat=True``: each layer is recomputed in the backward, as the
reference's rematerialised layer scan.

With ``plan`` (``sharding.make_plan(launch.mesh.make_group_mesh(model=M))``:
the ranks on ("data", "model")) the step is the reference's planned step,
ZeRO-3 over the data ranks and Megatron tensor parallelism over the model
ranks: every rank holds its shard of each parameter and AdamW moment (a ``sharding.RankState``, from
:func:`init_train_state` or :func:`shard_train_state`) and its rows of the
batch (``sharding.shard_batch``, or a ``TokenPipeline`` given the plan); each
layer gathers its weights at use, each weight's gradient is
reduce-scattered back to its shard and each replicated leaf's all-reduced
(``core.comm.fsdp``), and each layer splits its work over the model ranks
(``models``); the loss is over the global token count and the metrics are
global, the same on every rank. Every rank runs the same collectives in the
same order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import sharding as shard_mod
from ..core.comm import fsdp
from ..models.model_zoo import Model
from ..tree import leaves, tree_map
from .loss import chunked_cross_entropy
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainHParams", "TrainState", "init_train_state", "train_state_specs",
           "shard_train_state", "make_loss_fn", "make_train_step",
           "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: AdamWConfig = AdamWConfig()
    loss_chunk: int = 512
    moe_aux_weight: float = 0.01
    microbatches: int = 1          # gradient accumulation steps


class TrainState(dict):
    """{params, opt}: a plain dict of tensors."""


def _train_group(plan):
    """The data group of a train plan: a plan is for training, over a
    group."""
    if plan is not None and plan.mode != "train":
        raise ValueError(f"a {plan.mode!r} plan has no FSDP axes: the train step takes a "
                         "'train' plan")
    return shard_mod.data_group(plan)


def shard_train_state(state: dict, plan) -> shard_mod.RankState:
    """A whole train state (on one rank: ``init_train_state``, a restore or
    ``models.convert.from_jax_train_state``) -> this rank's shards under
    ``plan``, each leaf a copy of its ``local_shard`` in its own memory."""
    if _train_group(plan) is None:
        raise ValueError("shard_train_state needs a train plan over a process group")
    coord = plan.mesh.coord
    specs = shard_mod.state_specs(state, plan)
    local = {"params": shard_mod.local_shards(state["params"], specs["params"], plan, coord),
             "opt": {"mu": shard_mod.local_shards(state["opt"]["mu"], specs["opt"]["mu"],
                                                  plan, coord),
                     "nu": shard_mod.local_shards(state["opt"]["nu"], specs["opt"]["nu"],
                                                  plan, coord),
                     "step": state["opt"]["step"]}}
    return shard_mod.RankState(tree_map(lambda t: t.clone(), local), plan, specs)


def init_train_state(model: Model, gen: torch.Generator, plan=None) -> dict:
    """Random float32 parameters from ``gen`` and zero AdamW state, on the
    model's device; with ``plan``, this rank's shards of them (every rank
    draws the same whole state from the same seed, then keeps its part)."""
    params = model.init_params(gen)
    state = {"params": params, "opt": adamw_init(params)}
    return state if plan is None else shard_train_state(state, plan)


def train_state_specs(model: Model, plan=None) -> dict:
    """The train state's shapes and dtypes as tensors on the ``meta``
    device: no memory is allocated. With ``plan``, the shapes one rank
    holds (``sharding.local_shape`` of each leaf)."""
    from ..models import transformer

    gen = torch.Generator()
    params = transformer.init_params(gen, model.cfg, device="meta")
    state = {"params": params, "opt": adamw_init(params)}
    if plan is None:
        return state
    specs = shard_mod.param_specs(params, plan)
    local = shard_mod.local_shards(params, specs, plan, {a: 0 for a in plan.mesh.axis_names})
    return {"params": local, "opt": {"mu": local, "nu": local, "step": state["opt"]["step"]}}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(model: Model, hp: TrainHParams, plan=None) -> Callable:
    """loss_fn(params, batch) -> (loss, {"nll", "ntok", "moe_aux"}), float32
    scalars. The batch holds "tokens", "labels" and "loss_mask" (B, S), plus
    the family's "patch_embeds" or "enc_frames"; arrays may be numpy.

    With ``plan`` (a train plan over a process group), ``params`` are this
    rank's shards and ``batch`` its rows; the metrics are global (the same
    on every rank) and the returned loss is this rank's share of the global
    loss: its nll over the global token count plus the aux term over the
    world size, whose gradients summed over the ranks are the global
    loss's."""
    cfg = model.cfg
    group = _train_group(plan)
    shapes = model.param_shapes() if group is not None else None
    tp = shard_mod.model_axis(plan, model.param_shapes())

    prefix = cfg.n_patches if cfg.family == "vlm" and cfg.n_patches else 0

    def loss_fn(params, batch):
        batch = _to_device(batch, model.device)
        hidden, moe_aux = model.forward(params, batch, remat=True, plan=plan, gather_out=False)
        name = "unembed" if "unembed" in params else "embed"
        emb = shard_mod.use_param(params[name], plan, name, shapes and shapes[name])
        labels = batch["labels"]
        mask = batch["loss_mask"].float()
        vocab_tp = tp.sub(name) if tp is not None and tp.dims[name] is not None else None
        entered = shard_mod.stream_split(plan, prefix + batch["tokens"].shape[1])
        if entered:  # f of the vocabulary-parallel loss, or the whole stream for a whole one
            hidden = (fsdp.gather_seq(hidden, tp.group) if vocab_tp is not None
                      else fsdp.gather_whole(hidden, 1, tp.group))
        # vlm: hidden includes the image prefix; score text positions only
        if hidden.shape[1] != labels.shape[1]:
            hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
        nll, ntok = chunked_cross_entropy(
            hidden, emb, labels, mask, chunk=min(hp.loss_chunk, labels.shape[1]),
            final_softcap=cfg.final_logit_softcap, plan=plan, tp=vocab_tp,
            entered=entered and vocab_tp is not None)
        if group is None:
            loss = nll + hp.moe_aux_weight * moe_aux
            return loss, {"nll": nll, "ntok": ntok, "moe_aux": moe_aux}
        share = nll + hp.moe_aux_weight * moe_aux / plan.axis_size(plan.dp)
        return share, {"nll": fsdp.all_reduce(nll, group), "ntok": ntok, "moe_aux": moe_aux}

    return loss_fn


def value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """((loss, aux), grads): ``loss_fn(params, batch)`` and the gradient of
    its loss for every parameter, a tree in the parameters' layout (float32
    for float32 parameters). The loss and aux values are detached."""
    leaf_params = tree_map(lambda v: v.detach().requires_grad_(), params)
    loss, aux = loss_fn(leaf_params, batch)
    found = iter(torch.autograd.grad(loss, leaves(leaf_params), allow_unused=True))

    def grad_of(p):  # a parameter the loss does not reach gets zeros
        g = next(found)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad_of, leaf_params)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), grads


def make_train_step(model: Model, hp: TrainHParams = TrainHParams(), plan=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    With ``hp.microbatches > 1`` the leading batch dimension is split and
    the gradients summed in float32, then divided by the count; the loss is
    the mean of the microbatches' losses and the aux metrics are the last
    microbatch's, as in the reference.

    With ``plan`` (a train plan over a process group; a mesh without a group
    raises ``RuntimeError``) ``state`` is a ``sharding.RankState`` of this rank's
    shards and ``batch`` this rank's rows as ``sharding.shard_batch`` lays them
    out (for each microbatch, its block of the microbatch's rows); the
    state comes back as a ``RankState`` and the metrics are global.
    """
    group = _train_group(plan)
    loss_fn = make_loss_fn(model, hp, plan)

    def metric_loss(loss, aux):
        # the global loss from the global metrics (a rank's loss is its share)
        return loss if group is None else aux["nll"] + hp.moe_aux_weight * aux["moe_aux"]

    def accumulated(params, batch):
        mb = hp.microbatches
        n = next(iter(batch.values())).shape[0]
        if n % mb:
            raise ValueError(f"batch {n} is not divisible into {mb} microbatches")
        size = n // mb
        gsum, lsum, aux = None, None, None
        for i in range(mb):
            mbatch = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            (loss, aux), grads = value_and_grad(loss_fn, params, mbatch)
            loss = metric_loss(loss, aux)
            if gsum is None:
                gsum, lsum = tree_map(lambda g: g.float(), grads), loss
            else:
                tree_map(torch.Tensor.add_, gsum, grads)
                lsum = lsum + loss
            del grads
        for g in leaves(gsum):
            g.div_(mb)
        return lsum / mb, aux, gsum

    def train_step(state, batch):
        if group is not None and not isinstance(state, shard_mod.RankState):
            raise TypeError("a planned step takes a sharding.RankState (init_train_state or "
                            "shard_train_state with the plan)")
        params = state["params"]
        if hp.microbatches > 1:
            loss, aux, grads = accumulated(params, batch)
        else:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
            loss = metric_loss(loss, aux)
        specs = state.specs["params"] if group is not None else None
        params, opt, opt_metrics = adamw_update(hp.opt, params, grads, state["opt"], plan,
                                                specs)
        del grads
        new = {"params": params, "opt": opt}
        if group is not None:
            new = shard_mod.RankState(new, state.plan, state.specs)
        return new, {"loss": loss, **aux, **opt_metrics}

    return train_step
