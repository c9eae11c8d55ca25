"""Train-state checkpoints in the JAX package's format (counterpart of
audiodec_tpu/train/checkpoint.py: `save_checkpoint`, `load_checkpoint`,
on top of utils/checkpoint.py, whose `load_only_params` (norms folded
on load) serves both).

The whole state is written, as JAX writes it: {gen, gen_opt} for a
denoiser, with {disc, disc_opt} for the GAN modes and the frozen
{analyzer} for a vocoder.  `gen` (a symAD generator or a vocoder),
`disc` and `analyzer` are written as the JAX trees (utils/bridge.py), so
that the JAX package's `load_only_params` reads a checkpoint written here,
and the port's `codec_test` reads its `gen`.  The optimizers' states keep
torch's layout (train/optim.py `Optimizer.state_tree`): the port resumes
from its own checkpoints; from a JAX one it takes `gen` only
(`load_only_params`, the `initial:` warm start).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from audiodec_tpu_torch.utils import bridge
from audiodec_tpu_torch.utils import checkpoint as ckpt_io


def _to_jax(tree: dict) -> dict:
    """A port tree -> the JAX tree, by its kind."""
    if "input_conv" in tree:
        return bridge.vocoder_params_to_jax(tree)
    if "encoder" in tree:
        return bridge.params_to_jax(tree)
    return bridge.disc_params_to_jax(tree)


def _from_jax(tree: dict) -> dict:
    """A JAX tree (numpy leaves, lists restored) -> the port's, by its
    kind."""
    if "input_conv" in tree:
        return bridge.vocoder_params_from_jax(tree)
    if "encoder" in tree:
        return bridge.params_from_jax(tree)
    return bridge.disc_params_from_jax(tree)


_TREES = ("gen", "disc", "analyzer")
_OPTIMIZERS = ("gen_opt", "disc_opt")


def save_checkpoint(path: str, state: Dict[str, Any], steps: int,
                    extra: Optional[dict] = None) -> None:
    """state: as train/steps.py `train_state` builds it."""
    tree = {k: _to_jax(state[k]) for k in _TREES if k in state}
    tree.update({k: state[k].state_tree() for k in _OPTIMIZERS
                 if k in state})
    ckpt_io.save_checkpoint(path, tree, steps, extra)


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


def load_params_into(tree: dict, jax_tree: dict):
    """A JAX-layout tree (numpy leaves, lists restored) copied into the
    port's tree of the same kind in place."""
    return _copy_into(tree, _from_jax(jax_tree))


def load_checkpoint(path: str, state: Dict[str, Any]):
    """Restore a checkpoint written by save_checkpoint into `state` (built
    for the same model and config) -> (state, header)."""
    raw, header = ckpt_io.load_checkpoint(path)
    if set(raw) != {k for k in _TREES + _OPTIMIZERS if k in state}:
        raise ValueError(f"{path} holds {sorted(raw)}, the state "
                         f"{sorted(state)}")
    for k in _TREES:
        if k in state:
            state[k] = load_params_into(state[k],
                                        ckpt_io.restore_lists(raw[k]))
    for k in _OPTIMIZERS:
        if k in state:
            state[k].load_state_tree(raw[k])
    return state, header
