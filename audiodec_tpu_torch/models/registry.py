"""Model registry: released-model names -> (sample_rate, encoder ckpt,
decoder ckpt) (the port's copy of audiodec_tpu/models/registry.py; ref
utils/audiodec.py:109-179).

Checkpoint paths point into exp/ and hold JAX-format checkpoints
(utils/checkpoint.py), each with its config.yml beside it.
"""

from __future__ import annotations

import os
from typing import Tuple

_EXP = "exp"


def _ae(tag: str, steps: int) -> str:
    return os.path.join(_EXP, "autoencoder", tag,
                        f"checkpoint-{steps}steps.ckpt")


def _voc(tag: str, steps: int) -> str:
    return os.path.join(_EXP, "vocoder", tag,
                        f"checkpoint-{steps}steps.ckpt")


REGISTRY = {
    "libritts_v1": (24000,
                    _ae("symAD_libritts_24000_hop300", 500000),
                    _voc("AudioDec_v1_symAD_libritts_24000_hop300_clean",
                         500000)),
    "libritts_sym": (24000,
                     _ae("symAD_libritts_24000_hop300", 1000000),
                     _ae("symAD_libritts_24000_hop300", 1000000)),
    "vctk_v0": (48000, _ae("symAD_vctk_48000_hop300", 200000),
                _voc("AudioDec_v0_symAD_vctk_48000_hop300_clean", 500000)),
    "vctk_v1": (48000, _ae("symAD_vctk_48000_hop300", 200000),
                _voc("AudioDec_v1_symAD_vctk_48000_hop300_clean", 500000)),
    "vctk_v2": (48000, _ae("symAD_vctk_48000_hop300", 200000),
                _voc("AudioDec_v2_symAD_vctk_48000_hop300_clean", 500000)),
    "vctk_sym": (48000, _ae("symAD_vctk_48000_hop300", 700000),
                 _ae("symAD_vctk_48000_hop300", 700000)),
    "vctk_v0_denoise": (48000, _ae("../denoise/symAD_vctk_48000_hop300",
                                   200000),
                        _voc("AudioDec_v0_symAD_vctk_48000_hop300_clean",
                             500000)),
    "vctk_v1_denoise": (48000, _ae("../denoise/symAD_vctk_48000_hop300",
                                   200000),
                        _voc("AudioDec_v1_symAD_vctk_48000_hop300_clean",
                             500000)),
    "vctk_v2_denoise": (48000, _ae("../denoise/symAD_vctk_48000_hop300",
                                   200000),
                        _voc("AudioDec_v2_symAD_vctk_48000_hop300_clean",
                             500000)),
    "vctk_univ": (48000, _ae("symADuniv_vctk_48000_hop300", 500000),
                  _voc("AudioDec_v3_symADuniv_vctk_48000_hop300_clean",
                       500000)),
    "vctk_univ_sym": (48000, _ae("symADuniv_vctk_48000_hop300", 700000),
                      _ae("symADuniv_vctk_48000_hop300", 700000)),
    "vctk_activate_sym": (48000, _ae("symAAD_vctk_48000_hop300", 500000),
                          _ae("symAAD_vctk_48000_hop300", 500000)),
    "vctk_c16_sym": (48000, _ae("symAD_c16_vctk_48000_hop320", 700000),
                     _ae("symAD_c16_vctk_48000_hop320", 700000)),
}


def assign_model(name: str) -> Tuple[int, str, str]:
    """name -> (sample_rate, encoder_ckpt, decoder_ckpt)
    (ref: utils/audiodec.py:109-179)."""
    if name not in REGISTRY:
        raise NotImplementedError(
            f"Model {name} is not supported! Options: {sorted(REGISTRY)}")
    return REGISTRY[name]
