"""Feature-matching L1 loss over intermediate discriminator feature maps
(counterpart of audiodec_tpu/losses/feat_match.py; ref:
losses/feat_match_loss.py:13-55)."""

from __future__ import annotations

import torch


def feature_match_loss(feats_hat, feats, *, average_by_layers: bool = True,
                       average_by_discriminators: bool = True,
                       include_final_outputs: bool = False):
    loss = 0.0
    for fh, f in zip(feats_hat, feats):
        if not include_final_outputs:
            fh, f = fh[:-1], f[:-1]
        inner = 0.0
        for a, b in zip(fh, f):
            inner = inner + torch.mean(torch.abs(a - b.detach()))
        if average_by_layers:
            inner = inner / len(fh)
        loss = loss + inner
    if average_by_discriminators:
        loss = loss / len(feats)
    return loss
