"""Train-state checkpoints in the JAX package's format (counterpart of
audiodec_tpu/train/checkpoint.py: `save_checkpoint`, `load_checkpoint`,
on top of utils/checkpoint.py, whose `load_only_params` (norms folded
on load) serves both).

`gen` and `disc` are written as the JAX trees (utils/bridge.py), so that the
JAX package's `load_only_params` reads a checkpoint written here, and the
port's `codec_test` reads its `gen`.  The optimizers' states keep torch's
layout (train/optim.py `Optimizer.state_tree`): the port resumes from its
own checkpoints; from a JAX one it takes `gen` only (`load_only_params`,
the `initial:` warm start).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from audiodec_tpu_torch.utils import bridge
from audiodec_tpu_torch.utils import checkpoint as ckpt_io


def save_checkpoint(path: str, state: Dict[str, Any], steps: int,
                    extra: Optional[dict] = None) -> None:
    """state: {gen, disc, gen_opt, disc_opt} as train/steps.py keeps it."""
    ckpt_io.save_checkpoint(path, {
        "gen": bridge.params_to_jax(state["gen"]),
        "disc": bridge.disc_params_to_jax(state["disc"]),
        "gen_opt": state["gen_opt"].state_tree(),
        "disc_opt": state["disc_opt"].state_tree(),
    }, steps, extra)


def _copy_into(dst, src, where=""):
    """Copy a tree of tensors into `dst`'s tensors in place (the optimizers
    hold them), checking that the trees match."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint tree differs at {where or '/'}: "
                             f"{sorted(dst)} against {sorted(src)}")
        return {k: _copy_into(dst[k], src[k], f"{where}/{k}") for k in dst}
    if isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint tree differs at {where}")
        return [_copy_into(d, s, f"{where}/{i}")
                for i, (d, s) in enumerate(zip(dst, src))]
    if dst.shape != src.shape:
        raise ValueError(f"{where}: shape {tuple(src.shape)} in the "
                         f"checkpoint, {tuple(dst.shape)} in the model")
    with torch.no_grad():
        dst.copy_(src)
    return dst


def load_params_into(tree: dict, jax_tree: dict, disc: bool = False):
    """A JAX-layout tree (numpy leaves, lists restored) copied into the
    port's tree in place."""
    src = (bridge.disc_params_from_jax(jax_tree) if disc
           else bridge.params_from_jax(jax_tree))
    return _copy_into(tree, src)


def load_checkpoint(path: str, state: Dict[str, Any]):
    """Restore a checkpoint written by save_checkpoint into `state` (built
    for the same model and config) -> (state, header)."""
    raw, header = ckpt_io.load_checkpoint(path)
    state["gen"] = load_params_into(state["gen"],
                                    ckpt_io.restore_lists(raw["gen"]))
    state["disc"] = load_params_into(state["disc"],
                                     ckpt_io.restore_lists(raw["disc"]),
                                     disc=True)
    state["gen_opt"].load_state_tree(raw["gen_opt"])
    state["disc_opt"].load_state_tree(raw["disc_opt"])
    return state, header
