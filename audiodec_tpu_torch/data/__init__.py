"""Audio data: WAV I/O and the file datasets."""
