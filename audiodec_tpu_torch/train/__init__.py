"""GAN training: criterion, optimizers, steps, checkpoints and the loop."""
