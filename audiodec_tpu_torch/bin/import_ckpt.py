"""Convert a reference AudioDec checkpoint (.pkl) into a JAX-format
checkpoint that the port's command lines read (counterpart of
tools/import_ckpt.py).

    python -m audiodec_tpu_torch.bin.import_ckpt \\
        --torch checkpoint-200000steps.pkl --config config.yml \\
        --out exp/.../checkpoint-200000steps.ckpt

The reference's generator state dict (`{"model": {"generator": sd}}` or a
bare state dict) is mapped onto the param tree of the config's model:
`model_type` HiFiGAN or UnivNet is a vocoder, anything else an
autoencoder; weight norm is folded.  The checkpoint holds {"gen": params}
in the JAX package's layout, its header the reference's `steps`, and
`imported_from` and `epochs` beside it; the config is copied beside the
checkpoint as `config.yml`, where the command lines look for it.  Runs on
the CPU; reads the YAML with utils/config.py.
"""

from __future__ import annotations

import argparse
import os
import shutil

from audiodec_tpu_torch.utils.bridge import (
    load_reference_checkpoint,
    load_reference_meta,
    params_from_reference_sd,
    params_to_jax,
    vocoder_params_from_reference_sd,
    vocoder_params_to_jax,
)
from audiodec_tpu_torch.utils.checkpoint import save_checkpoint
from audiodec_tpu_torch.utils.config import generator_config, load_config

VOCODERS = ("HiFiGAN", "UnivNet")


def import_params(sd: dict, config: dict) -> dict:
    """A reference generator state dict -> the JAX-layout params of the
    config's model."""
    cfg = generator_config(config)
    if config.get("model_type") in VOCODERS:
        return vocoder_params_to_jax(vocoder_params_from_reference_sd(sd, cfg))
    return params_to_jax(params_from_reference_sd(sd, cfg))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--torch", required=True,
                        help="reference checkpoint (.pkl)")
    parser.add_argument("--config", required=True,
                        help="the model's reference config.yml")
    parser.add_argument("--out", required=True,
                        help="the checkpoint to write")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    params = import_params(load_reference_checkpoint(args.torch), config)
    meta = load_reference_meta(args.torch)
    save_checkpoint(args.out, {"gen": params}, steps=meta.get("steps", 0),
                    extra={"imported_from": os.path.basename(args.torch),
                           "epochs": meta.get("epochs", 0)})
    dst = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                       "config.yml")
    if os.path.abspath(args.config) != dst:
        shutil.copy(args.config, dst)
    print(f"imported {args.torch} -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
