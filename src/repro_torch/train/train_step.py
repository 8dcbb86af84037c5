"""Train step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation, on one device.

The step is a function of (state, batch) as in the reference; it updates
the state's tensors in place and returns the same dict. The forward runs
with ``remat=True``: each layer is recomputed in the backward, as the
reference's rematerialised layer scan. The reference's ``plan`` (a device
mesh's shardings) has no meaning on one card and is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.model_zoo import Model
from ..tree import leaves, tree_map
from .loss import chunked_cross_entropy
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainHParams", "TrainState", "init_train_state", "train_state_specs",
           "make_loss_fn", "make_train_step", "value_and_grad"]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    opt: AdamWConfig = AdamWConfig()
    loss_chunk: int = 512
    moe_aux_weight: float = 0.01
    microbatches: int = 1          # gradient accumulation steps


class TrainState(dict):
    """{params, opt}: a plain dict of tensors."""


def init_train_state(model: Model, gen: torch.Generator) -> dict:
    """Random float32 parameters from ``gen`` and zero AdamW state, on the
    model's device."""
    params = model.init_params(gen)
    return {"params": params, "opt": adamw_init(params)}


def train_state_specs(model: Model) -> dict:
    """The train state's shapes and dtypes as tensors on the ``meta``
    device: no memory is allocated."""
    from ..models import transformer

    gen = torch.Generator()
    params = transformer.init_params(gen, model.cfg, device="meta")
    return {"params": params, "opt": adamw_init(params)}


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_loss_fn(model: Model, hp: TrainHParams) -> Callable:
    """loss_fn(params, batch) -> (loss, {"nll", "ntok", "moe_aux"}), float32
    scalars. The batch holds "tokens", "labels" and "loss_mask" (B, S), plus
    the family's "patch_embeds" or "enc_frames"; arrays may be numpy."""
    cfg = model.cfg

    def loss_fn(params, batch):
        batch = _to_device(batch, model.device)
        hidden, moe_aux = model.forward(params, batch, remat=True)
        emb = params["unembed"] if "unembed" in params else params["embed"]
        labels = batch["labels"]
        mask = batch["loss_mask"].float()
        # vlm: hidden includes the image prefix; score text positions only
        if hidden.shape[1] != labels.shape[1]:
            hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
        nll, ntok = chunked_cross_entropy(
            hidden, emb, labels, mask, chunk=min(hp.loss_chunk, labels.shape[1]),
            final_softcap=cfg.final_logit_softcap)
        loss = nll + hp.moe_aux_weight * moe_aux
        return loss, {"nll": nll, "ntok": ntok, "moe_aux": moe_aux}

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


def make_train_step(model: Model, hp: TrainHParams = TrainHParams()) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    With ``hp.microbatches > 1`` the leading batch dimension is split and
    the gradients summed in float32, then divided by the count; the loss is
    the mean of the microbatches' losses and the aux metrics are the last
    microbatch's, as in the reference.
    """
    loss_fn = make_loss_fn(model, hp)

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
        params = state["params"]
        if hp.microbatches > 1:
            loss, aux, grads = accumulated(params, batch)
        else:
            (loss, aux), grads = value_and_grad(loss_fn, params, batch)
        params, opt, opt_metrics = adamw_update(hp.opt, params, grads, state["opt"])
        del grads
        return {"params": params, "opt": opt}, {"loss": loss, **aux, **opt_metrics}

    return train_step
