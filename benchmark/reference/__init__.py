"""The plain reference of the benchmark: AudioDec's symAD autoencoder, its
residual VQ and the causal HiFiGAN vocoder, written from the published
AudioDec code's equations in plain float32 PyTorch.  It reads a state dict
in the reference checkpoint's layout and imports nothing of the program
under test."""
