"""Models: the symAD autoencoder and its kernel path."""
