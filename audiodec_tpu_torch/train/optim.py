"""Optimizers and schedules of a reference-style config (counterpart of
audiodec_tpu/train/optim.py; ref codecTrain.py:150-187): torch.optim's Adam
or AdamW with the config's betas, eps and weight decay, StepLR, MultiStepLR
or ExponentialLR stepped once per update, and clip_grad_norm_ when
`<role>_grad_norm` is above 0 (ref: trainer/trainerGAN.py:271-294).  These
are the classes the reference trains with; the JAX package rebuilds them
on optax.

`Optimizer` owns the leaves of a param tree that it trains, by their
"/"-joined paths.  A step differentiates a loss with respect to the leaves
of the paths it is given only; the others keep `.grad` None, so Adam skips
them (the JAX package zeroes their gradients and updates: the parameters
come out the same, their moments do not).

Data-parallel steps pass the data axis (parallel/distributed.py `Axis`):
the gradients are averaged over its ranks after they are computed and
before they are clipped, as JAX `pmean`s them before its optimizer chain
clips, in one flat buffer and one collective per step.  Every rank then
takes the same update, so the params and the moments stay identical.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from audiodec_tpu_torch.utils.profiling import span


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """[(path, tensor)] of a tree of dicts and lists, in order; list items
    by index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves(v, f"{prefix}/{k}" if prefix else k))
    return out


def _mean_over(grads: list, axis) -> list:
    """The gradients averaged over the axis's ranks, flattened into one
    buffer for one collective."""
    flat = axis.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                           "mean")
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def _scheduler(opt, sched_type: str, p: dict):
    if sched_type == "StepLR":
        return torch.optim.lr_scheduler.StepLR(
            opt, step_size=p.get("step_size", 10 ** 9),
            gamma=p.get("gamma", 1.0))
    if sched_type == "MultiStepLR":
        return torch.optim.lr_scheduler.MultiStepLR(
            opt, milestones=list(p.get("milestones", [])),
            gamma=p.get("gamma", 0.5))
    if sched_type == "ExponentialLR":
        return torch.optim.lr_scheduler.ExponentialLR(
            opt, gamma=p.get("gamma", 1.0))
    raise NotImplementedError(f"Scheduler {sched_type} not supported")


class Optimizer:
    """One role's ("generator" or "discriminator") optimizer, schedule and
    clipping over `params`, [(path, leaf tensor)]."""

    def __init__(self, config: dict, role: str,
                 params: Iterable[Tuple[str, torch.Tensor]]):
        opt_type = config.get(f"{role}_optimizer_type", "Adam")
        if opt_type not in ("Adam", "AdamW"):
            raise NotImplementedError(f"Optimizer {opt_type} not supported")
        op = dict(config.get(f"{role}_optimizer_params", {}))
        self.params: Dict[str, torch.Tensor] = dict(params)
        for t in self.params.values():
            t.requires_grad_(True)
        cls = torch.optim.AdamW if opt_type == "AdamW" else torch.optim.Adam
        self.opt = cls(
            list(self.params.values()), lr=op.get("lr", 1e-3),
            betas=tuple(op.get("betas", (0.9, 0.999))),
            eps=op.get("eps", 1e-8),
            weight_decay=op.get("weight_decay",
                                1e-2 if opt_type == "AdamW" else 0.0))
        self.sched = _scheduler(
            self.opt, config.get(f"{role}_scheduler_type", "StepLR"),
            dict(config.get(f"{role}_scheduler_params", {})))
        self.clip = config.get(f"{role}_grad_norm", -1)

    def step(self, loss: torch.Tensor, paths=None, axis=None):
        """Backpropagate `loss` to the leaves of `paths` (default: all),
        average the gradients over `axis` (None: no reduction), clip,
        update them, and advance the schedule by one update."""
        paths = list(self.params) if paths is None else list(paths)
        leaves = [self.params[p] for p in paths]
        with span("backward", loss.device):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(leaves, grads)]
        with span("update", loss.device):
            if axis is not None and axis.size > 1:
                grads = _mean_over(grads, axis)
            for t, g in zip(leaves, grads):
                t.grad = g
            if self.clip and self.clip > 0:
                torch.nn.utils.clip_grad_norm_(leaves, self.clip)
            self.opt.step()
            self.sched.step()
            self.opt.zero_grad(set_to_none=True)

    @property
    def lr(self) -> float:
        return self.opt.param_groups[0]["lr"]

    def state_tree(self) -> dict:
        """The optimizer's state as a tree of numpy arrays and numbers, by
        param path (torch's layout, not optax's)."""
        state = self.opt.state_dict()
        index = {i: p for i, p in enumerate(self.params)}
        return {
            "moments": {index[i]: {k: v.detach().cpu().numpy()
                                   if torch.is_tensor(v) else v
                                   for k, v in s.items()}
                        for i, s in state["state"].items()},
            "lr": float(self.lr),
            "last_epoch": int(self.sched.last_epoch),
        }

    def load_state_tree(self, tree: dict):
        """Restore what state_tree wrote (same params, same order)."""
        index = {p: i for i, p in enumerate(self.params)}
        state = self.opt.state_dict()
        state["state"] = {
            index[p]: {k: torch.as_tensor(np.array(v)) for k, v in m.items()}
            for p, m in tree.get("moments", {}).items()}
        for group in state["param_groups"]:
            group["lr"] = float(tree["lr"])
        self.opt.load_state_dict(state)
        self.sched.last_epoch = int(tree["last_epoch"])
        self.sched._last_lr = [g["lr"] for g in self.opt.param_groups]
