"""Training losses (counterpart of audiodec_tpu/losses)."""

from audiodec_tpu_torch.losses.adversarial import (
    discriminator_adversarial_loss,
    generator_adversarial_loss,
)
from audiodec_tpu_torch.losses.feat_match import feature_match_loss
from audiodec_tpu_torch.losses.mel import MultiMelSpectrogramLoss
from audiodec_tpu_torch.losses.stft import MultiResolutionSTFTLoss
from audiodec_tpu_torch.losses.waveform import MultiWindowShapeLoss
