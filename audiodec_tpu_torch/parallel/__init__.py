"""Chunk-halo helpers (counterpart of audiodec_tpu/parallel/: so far only
the receptive-field halos of `codec.py`, which the batch folds read)."""
